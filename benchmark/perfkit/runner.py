"""One run of one cell: check the chips, run the cell's driver, read its
metrics and print the result line."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from . import spec
from .counts import peaks

FORBIDDEN = ("jax", "jaxlib", "flax", "nbdistributed_tpu")
HOST_THREADS = 1


def set_environment() -> None:
    """Kernel caches at fixed paths inside the checkout, no JAX from
    libraries that would load it by themselves, and one CPU thread for
    the host's math libraries: the load is one process with few
    threads."""
    build = spec.ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    for k in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[k] = "0"
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = str(HOST_THREADS)
    if "torch" in sys.modules:
        sys.modules["torch"].set_num_threads(HOST_THREADS)


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that must not be, compared
    whole (``nbdistributed_tpu_torch`` is not ``nbdistributed_tpu``)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def read_metrics(entries: list, view: dict) -> dict:
    out = {}
    for m in entries:
        v = spec.metric_reader(m["name"]).read(view)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def metric_view(result: dict, kind: str, recorder) -> dict:
    from .trace import host
    rec = result["record"]
    calls = {} if recorder is None else \
        {k: host(v) for k, v in recorder.calls.items()}
    return {"record": rec, "trace": rec.get("trace"), "calls": calls,
            "peak": peaks(kind)}


def finite(x):
    """``x`` with every non-finite float replaced by None (JSON has no
    infinity)."""
    if isinstance(x, float):
        return x if x == x and abs(x) != float("inf") else None
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    return x


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def driver_of(cell):
    """The cell's driver, refused where it does not run the cell's
    number of chips (each driver lists them in ``CHIPS``)."""
    drv = spec.driver(cell.mix["driver"])
    if cell.chips not in drv.CHIPS:
        raise ValueError(f"driver {cell.mix['driver']!r} runs "
                         f"{drv.CHIPS} chips, not {cell.chips}")
    return drv


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_process: float, cfg=None, kind: str | None = None):
    """Run ``cell`` once on ``device``; returns (result line without its
    checks, the driver's result).  ``cfg`` replaces the configuration
    file's port config (the tests' small sizes); ``kind`` names the
    device for the peaks table."""
    import torch
    from .context import Context
    from .trace import Recorder
    recorder = None
    if trace:
        recorder = Recorder()
        recorder.install(spec.span_entries())
    try:
        ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                      device=device, t_process=t_process, recorder=recorder)
        result = driver_of(cell).run(ctx, cfg)
    finally:
        if recorder is not None:
            recorder.uninstall()
    if kind is None:
        kind = torch.cuda.get_device_name(device)
    view = metric_view(result, kind, recorder)
    entries = cell.per_layer if trace else cell.end_to_end
    device_info = {"platform": "gpu", "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": result["memory_peak_bytes"]}
    line = {"correct": bool(result["correct"]),
            "attempted": result["attempted"], "failed": result["failed"],
            "metrics": read_metrics(entries, view), "device": device_info}
    tr = view["trace"]
    if trace:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": tr.top_device_ops(10),
                             "idle_gaps": tr.idle_gaps(10)}
    return line, result


def main(argv, t_process: float) -> int:
    args = parse(argv)
    set_environment()
    cell = spec.load_cell(args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"benchmark: cell {cell.name} needs {cell.chips} CUDA "
              f"device(s); found {have}", file=sys.stderr)
        return 2
    try:
        driver_of(cell)
    except ValueError as e:
        print(f"benchmark: cell {cell.name}: {e}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    line, result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            device, t_process)
    line["device"]["power_limit"] = power_limit()
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    line["checks"] = result["checks"]
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(line), allow_nan=False), flush=True)
    return 0
