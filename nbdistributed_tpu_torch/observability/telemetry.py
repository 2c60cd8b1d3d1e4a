"""Per-worker live device telemetry (counterpart of
``nbdistributed_tpu/observability/telemetry.py``).

The status probe (``get_status``) answers through the worker's SERIAL
request loop, so it stalls exactly when the operator most wants it —
mid-cell, mid-OOM-death-spiral.  This module is the *push*-based
alternative: a :class:`TelemetrySampler` snapshots device state off the
hot path and the worker's heartbeat thread piggybacks the compact
snapshot on its ping ``data``, giving the coordinator a live per-rank
view (device memory in use / peak, resilience counters) that works
while the main thread is busy.

Snapshot shape (compact on purpose — it rides every Nth 2-second
heartbeat)::

    {"ts": unix_s,
     "hbm": [{"id", "in_use", "peak", "limit", "reserved"}, ...],  # bytes
     "compiles": 0, "compile_s": 0.0,
     ...extra_fn() fields (dedup hits, msgs seen, ...)}

The memory numbers are the CUDA caching allocator's
(``torch.cuda.memory_allocated`` / ``max_memory_allocated`` /
``memory_reserved``) and the card's total from ``mem_get_info``.  The
JAX package also counts XLA backend compiles here, through
``jax.monitoring``; the port runs eager PyTorch and prebuilt kernels,
so there is no compile to watch: the compile fields stay 0 (kept so
the ping reads the same to the coordinator) and
:func:`compile_seconds` is 0.0.

Nothing here touches CUDA at import time, and a CPU device reports no
memory (None), so the sampler never creates a CUDA context in a CPU
worker.
"""

from __future__ import annotations

import time

from . import metrics as obs_metrics

DEFAULT_INTERVAL_S = 4.0


def device_memory(device) -> dict | None:
    """``{"in_use", "peak", "limit", "reserved"}`` in bytes for a CUDA
    ``torch.device``, or None for any other device (the CPU has no
    allocator stats).  Shared by the ``get_status`` pull path
    (:func:`~nbdistributed_tpu_torch.runtime.introspect.device_status`)
    and the heartbeat push path."""
    try:
        import torch

        dev = torch.device(device)
        if dev.type != "cuda":
            return None
        _free, total = torch.cuda.mem_get_info(dev)
        return {"in_use": int(torch.cuda.memory_allocated(dev)),
                "peak": int(torch.cuda.max_memory_allocated(dev)),
                "limit": int(total),
                "reserved": int(torch.cuda.memory_reserved(dev))}
    except Exception:
        return None


def compile_seconds() -> float:
    """Cumulative backend-compile seconds: always 0.0 in the port (see
    the module docstring).  The latency observatory's worker-side
    stamps take a delta of this around each handler."""
    return 0.0


class TelemetrySampler:
    """Samples device state for one worker rank.

    ``sample()`` forces a snapshot; ``maybe_sample()`` respects the
    minimum interval (heartbeats fire every 2 s — resampling device
    stats on every ping would make the liveness signal itself a load
    source) and returns None between samples so unchanged pings stay
    small.  Every snapshot also feeds the process metrics registry so
    ``metrics`` exports carry the device numbers.
    """

    def __init__(self, rank: int, *, device=None,
                 min_interval_s: float = DEFAULT_INTERVAL_S,
                 extra_fn=None):
        self.rank = rank
        self.device = device
        self.min_interval_s = min_interval_s
        self._extra_fn = extra_fn
        self._last_ts = 0.0
        self.last: dict | None = None

    # ------------------------------------------------------------------

    def maybe_sample(self, now: float | None = None) -> dict | None:
        now = time.time() if now is None else now
        if now - self._last_ts < self.min_interval_s:
            return None
        return self.sample(now)

    def sample(self, now: float | None = None) -> dict:
        now = time.time() if now is None else now
        self._last_ts = now
        snap: dict = {"ts": round(now, 3)}
        reg = obs_metrics.registry()
        mem = None if self.device is None else device_memory(self.device)
        if mem is not None:
            did = getattr(self.device, "index", None) or 0
            snap["hbm"] = [{"id": did, **mem}]
            for k in ("in_use", "peak"):
                reg.gauge(f"nbd_hbm_{k}_bytes", f"device memory {k} bytes",
                          {"device": str(did)}).set(mem[k])
        snap["compiles"] = 0
        snap["compile_s"] = 0.0
        if self._extra_fn is not None:
            try:
                snap.update(self._extra_fn() or {})
            except Exception:
                pass
        self.last = snap
        return snap


def hbm_totals(snapshot: dict | None) -> dict | None:
    """Sum a snapshot's per-device memory numbers into one
    ``{"in_use", "peak", "limit", "devices"}`` (bytes) — the per-rank
    figure ``%dist_top`` shows (a copy of the JAX package's; a port
    rank owns one GPU, so the sum is that card's).  None when the
    snapshot carries no memory stats (CPU ranks)."""
    hbm = (snapshot or {}).get("hbm") or []
    if not hbm:
        return None
    out = {"devices": len(hbm)}
    for key in ("in_use", "peak", "limit"):
        vals = [d.get(key) for d in hbm if d.get(key) is not None]
        out[key] = sum(vals) if vals else None
    return out


def peak_hbm(snapshots) -> dict:
    """Summarize a sequence of snapshots into per-device peak memory
    bytes (a trajectory summary; a copy of the JAX package's)."""
    peaks: dict[str, int] = {}
    for snap in snapshots:
        for dev in (snap or {}).get("hbm", ()):
            for key in ("peak", "in_use"):
                v = dev.get(key)
                if v is not None:
                    did = str(dev.get("id"))
                    peaks[did] = max(peaks.get(did, 0), v)
                    break
    return peaks
