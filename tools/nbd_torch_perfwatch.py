#!/usr/bin/env python
"""Perf-regression sentinel CLI (counterpart of
``tools/nbd_perfwatch.py``).

Scores a pinned loadgen report (and, when available, the serving
observatory's stage summary) against a baselines file and exits
nonzero on regression:

    # gate a fresh run against a baselines file:
    python tools/nbd_torch_perfwatch.py --baseline B.json \\
        --report /tmp/load.json --stages /tmp/latency.json \\
        --diff /tmp/perfwatch.json

    # seed / re-seed the baseline from a known-good run:
    python tools/nbd_torch_perfwatch.py --baseline B.json \\
        --report /tmp/load.json --update

    # spin a 3-rank gloo pool on the CPU (2 decode ranks, tiny model),
    # drive it, and score the result in one shot (--report/--stages
    # become OUTPUT paths):
    python tools/nbd_torch_perfwatch.py --baseline B.json --smoke \\
        --report /tmp/load.json --diff /tmp/perfwatch.json

The port keeps no baselines file yet, and no number measured on
another device carries over, so the file is always named: by
``--baseline PATH`` or ``NBD_PERFWATCH_BASELINE``.

The scoring contract lives in
:mod:`nbdistributed_tpu_torch.observability.perfbase`: each watched metric
carries a direction and a noise band IN the baseline file, so the
baselines file is the whole contract and ``--update`` preserves
hand-tuned bands.  ``--diff`` writes the machine-readable verdict
(one dict per metric); the same content is
printed human-readably either way.

``NBD_PERFWATCH_BAND_SCALE`` (or ``--band-scale``)
widens every band uniformly on noisy runners.  Exit code: 0 = within
bands (or just seeded), 1 = regression, 2 = could not run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from nbdistributed_tpu_torch.observability import perfbase  # noqa: E402
from nbdistributed_tpu_torch.utils import knobs  # noqa: E402


def _load_json(path: str, what: str) -> dict:
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except Exception as e:
        raise SystemExit(f"cannot read {what} {path!r}: "
                         f"{type(e).__name__}: {e}")


# The smoke pool: 3 gloo ranks on the CPU, 2 of them decoding the tiny
# model over paged KV (the shape of the JAX package's smoke pool).
_SMOKE_SPEC = (
    "import torch as _t\n"
    "from nbdistributed_tpu_torch.models import tiny_config, init_params\n"
    "cfg = tiny_config(dtype=_t.float32)\n"
    "params = init_params(cfg, 0, device='cpu')\n")


def _run_smoke(report_path: str,
               stages_path: str | None) -> tuple[dict, dict | None]:
    """Spin the 2-decode-rank CPU pool, run the deterministic loadgen
    schedule against it, and return (report, stage_summary) — writing
    both to disk."""
    from nbdistributed_tpu_torch.gateway.client import TenantClient
    from nbdistributed_tpu_torch.gateway.daemon import GatewayDaemon
    from nbdistributed_tpu_torch.serving_fast import LoadConfig, run_load
    from nbdistributed_tpu_torch.serving_fast.loadgen import ClientTransport

    print("[perfwatch] starting 3-rank cpu pool "
          "(2 decode ranks, paged KV)", file=sys.stderr, flush=True)
    gw = GatewayDaemon(3, backend="cpu", attach_timeout=240.0)
    stages = None
    try:
        client = TenantClient(gw.tenant_host, gw.tenant_port,
                              "perfwatch", pool_token=gw.pool_token)
        try:
            client.serve_start(_SMOKE_SPEC, max_batch=2, max_len=48,
                               pad_to=4, steps=2, queue_depth=8,
                               inflight=64, decode_ranks=2,
                               kv_block_tokens=8, timeout=600)
            cfg = LoadConfig(rps=3.0, duration_s=6.0, seed=1,
                             prompt_len=(2, 5), max_new=(4, 4),
                             drain_s=120.0)
            report = run_load(ClientTransport(client), cfg)
            lat = (client.serve_status() or {}).get("lat") or {}
            if "stages" in (lat.get("summary") or {}):
                stages = lat["summary"]
        finally:
            client.close(detach=True)
    finally:
        gw.close()

    with open(report_path, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
    if stages_path and stages is not None:
        with open(stages_path, "w", encoding="utf-8") as f:
            json.dump(stages, f, indent=2, sort_keys=True)
            f.write("\n")
    print(f"[perfwatch] smoke: offered={report.get('offered')} "
          f"completed={report.get('completed')} "
          f"tok/s={report.get('tokens_per_s')} → {report_path}",
          file=sys.stderr, flush=True)
    return report, stages


def _stage_summary(doc: dict | None) -> dict | None:
    """Accept either a bare ``ServingObservatory.summary()`` block or
    a whole ``/latency.json`` payload carrying one at
    ``serving.summary`` / ``lat.summary`` — whichever artifact the
    caller happened to save."""
    if not isinstance(doc, dict):
        return None
    if "stages" in doc:
        return doc
    for key in ("serving", "lat"):
        inner = doc.get(key)
        if isinstance(inner, dict) and "stages" in (
                inner.get("summary") or {}):
            return inner["summary"]
    return None


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description="score a loadgen report against the checked-in "
                    "perf baseline (exit 1 on regression)")
    p.add_argument("--report", required=True,
                   help="loadgen JSON report (tools/nbd_torch_loadgen.py "
                        "--report)")
    p.add_argument("--stages", default=None,
                   help="serving stage summary JSON — either a bare "
                        "summary block or a saved /latency.json")
    p.add_argument("--baseline",
                   default=knobs.get_str("NBD_PERFWATCH_BASELINE"),
                   help="baselines file (default: "
                        "$NBD_PERFWATCH_BASELINE; there is no other)")
    p.add_argument("--key", default="serving_smoke",
                   help="baseline entry to gate against")
    p.add_argument("--band-scale", type=float,
                   default=knobs.get_float("NBD_PERFWATCH_BAND_SCALE",
                                           1.0),
                   help="uniform multiplier on every noise band")
    p.add_argument("--update", action="store_true",
                   help="seed/refresh the baseline entry from this "
                        "report instead of gating (keeps hand-tuned "
                        "bands)")
    p.add_argument("--diff", default=None,
                   help="write the machine-readable score here")
    p.add_argument("--source", default="",
                   help="provenance note stored with --update "
                        "(e.g. 'h100 loadgen, 3 rps')")
    p.add_argument("--smoke", action="store_true",
                   help="spin the 2-decode-rank CPU smoke pool and "
                        "generate the report/stages in-process "
                        "(--report/--stages become output paths)")
    args = p.parse_args(argv)
    if not args.baseline:
        print("no baselines file: pass --baseline PATH (or set "
              "NBD_PERFWATCH_BASELINE)", file=sys.stderr)
        return 2

    try:
        if args.smoke:
            report, stages = _run_smoke(args.report, args.stages)
        else:
            report = _load_json(args.report, "loadgen report")
            stages = (_stage_summary(_load_json(args.stages,
                                                "stage summary"))
                      if args.stages else None)
        metrics = perfbase.extract_metrics(report, stages)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2
    except Exception as e:
        print(f"perfwatch smoke failed: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2
    if not metrics:
        print(f"no gated metrics found in {args.report!r} — not a "
              "pinned loadgen report?", file=sys.stderr)
        return 2

    if args.update:
        doc: dict = {"baselines": {}}
        old_bands: dict[str, float] = {}
        if os.path.exists(args.baseline):
            try:
                doc = perfbase.load_baselines(args.baseline)
            except Exception as e:
                print(f"replacing unreadable baseline: {e}",
                      file=sys.stderr)
                doc = {"baselines": {}}
            old = (doc.get("baselines") or {}).get(args.key) or {}
            old_bands = {n: m["band"] for n, m in
                         (old.get("metrics") or {}).items()
                         if "band" in m}
        doc.setdefault("baselines", {})[args.key] = \
            perfbase.make_baseline(metrics, source=args.source,
                                   bands=old_bands)
        perfbase.save_baselines(args.baseline, doc)
        n = len(doc["baselines"][args.key]["metrics"])
        print(f"NBD_PERFWATCH seeded {args.baseline} "
              f"[{args.key}]: {n} gated metrics", file=sys.stderr)
        return 0

    try:
        doc = perfbase.load_baselines(args.baseline)
    except Exception as e:
        print(f"cannot load baseline {args.baseline!r}: {e}",
              file=sys.stderr)
        return 2
    entry = (doc.get("baselines") or {}).get(args.key)
    if not entry:
        print(f"baseline {args.baseline!r} has no entry "
              f"{args.key!r} — seed one with --update",
              file=sys.stderr)
        return 2

    result = perfbase.score(entry, metrics,
                            band_scale=args.band_scale)
    result["key"] = args.key
    result["baseline_file"] = args.baseline
    result["band_scale"] = args.band_scale
    if args.diff:
        with open(args.diff, "w", encoding="utf-8") as f:
            json.dump(result, f, indent=2, sort_keys=True)
            f.write("\n")
    print(perfbase.format_diff(result))
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
