"""What a driver gets: the cell's files, the run's arguments and the
clocks."""

from __future__ import annotations

import dataclasses
import gc
import math
import statistics
import sys
import time

import torch

from . import weights
from .spec import Cell


@dataclasses.dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_process: float                 # perf_counter at process start
    recorder: object = None          # perfkit.trace.Recorder when tracing

    @property
    def mix(self) -> dict:
        return self.cell.mix

    @property
    def limits(self) -> dict:
        return self.cell.limits

    def log(self, what: str) -> None:
        """A progress line on standard error, with seconds since the
        process started."""
        print(f"[{self.now() - self.t_process:8.2f} s] {what}",
              file=sys.stderr, flush=True)

    def build_kernels(self) -> None:
        """The port's kernels, built once into the checkout's build
        directory (a later run finds them there)."""
        if self.device.type == "cuda":
            from nbdistributed_tpu_torch.ops import _build
            spent = _build.build_all()
            if spent:
                self.log(f"built kernels {spent}")

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def now(self) -> float:
        return time.perf_counter()

    def memory_peak(self) -> int:
        if self.device.type == "cuda":
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def sq_norm(t: torch.Tensor) -> float:
    """Squared L2 norm in float64, a slice of the first axis at a time
    (no float32 copy of a whole stacked leaf)."""
    parts = t if t.ndim > 2 else [t]
    return math.fsum(float((p.detach().double() ** 2).sum()) for p in parts)


def change_norms(tree: dict, sizes: dict, seed: int, device) -> dict:
    """Per leaf, the norm of ``tree`` minus the tree made from ``seed``
    (each made again alone)."""
    out = {}
    for path in weights.leaf_specs(sizes):
        p = weights.get(tree, path)
        p0 = weights.make_leaf(sizes, seed, path, device)
        parts = zip(p, p0) if p.ndim > 2 else [(p, p0)]
        out[path] = math.fsum(float(((a.detach().double() - b.double()) ** 2).sum())
                              for a, b in parts) ** 0.5
        del p0
    return out


def worst_leaf_gap(prog: dict, ref: dict, leaves=None, base=None) -> float:
    """max over leaves of |prog - base| / max(ref, median of ref), where
    ``base`` defaults to ``ref`` (a gap of norms); with ``base`` zero,
    ``prog`` is already a norm of differences."""
    base = ref if base is None else base
    keys = [k for k in ref if leaves is None or k in leaves]
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog.get(k, 0.0) - base[k]) / max(ref[k], med, 1e-30)
               for k in keys)


def check(value: float, limit: float) -> dict:
    return {"value": value, "limit": limit}


def passed(checks: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())
