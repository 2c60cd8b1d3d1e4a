"""Functional, notebook-friendly collectives over the worker's
``torch.distributed`` process group (counterpart of
``nbdistributed_tpu/parallel/collectives.py``).

The reference seeds ``torch.distributed`` into the interactive namespace
so users call ``dist.all_reduce(t)`` cell by cell (reference:
worker.py:160-177).  The worker seeds that same ``dist`` module; this
module adds the JAX package's *functional* collectives beside it, by the
same names: each takes a value (tensor, numpy array or number), leaves
it untouched, and returns the result — the reduced / gathered value as
seen by this rank.  Every rank passes a value of identical shape.

On an NCCL group the value moves to the rank's GPU (a host value too);
on gloo it runs on the CPU.  A tensor input gets its result back on its
own device.  Without a process group (a plain process) every call is
an identity on one rank, so the same notebook code runs anywhere.

Each call carries the JAX package's instrumentation: a
``collective/<op>`` span while a trace is active, a duration histogram
and call counter in the process metrics registry, and the
collective-guard entry/exit marks (``runtime/collective_guard.py``)
that refuse a world-collective from a strict subset of ranks and feed
the hang watchdog.
"""

from __future__ import annotations

import functools
import time

from ..observability import metrics as _obs_metrics
from ..observability.spans import maybe_span as _maybe_span
from ..runtime.collective_guard import check as _guard_check
from ..runtime.collective_guard import done as _guard_done
from ..runtime.collective_guard import nested as _guard_nested
from ..runtime.tracked_dist import completion_probe as _completion_probe

__all__ = ["all_gather", "all_reduce", "all_reduce_quantized", "barrier",
           "broadcast", "gather", "rank", "reduce", "reduce_scatter",
           "scatter", "world_size"]

_OPS = ("sum", "mean", "max", "min")


def _instrumented(name: str):
    """Observability wrapper for an eager collective: a
    ``collective/<op>`` span while a trace is active (one flag check
    when not) and an always-on duration histogram in the process
    metrics registry.  Metrics are resolved once, at decoration time —
    the per-call cost is one ``observe``.  Composed ops (gather →
    all_gather) record both levels, mirroring their span nesting."""
    reg = _obs_metrics.registry()
    hist = reg.histogram("nbd_collective_seconds",
                         "eager collective duration", {"op": name})
    calls = reg.counter("nbd_collectives_total",
                        "eager collective calls", {"op": name})

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            probe = None
            try:
                with _maybe_span(f"collective/{name}", kind="collective"):
                    out = fn(*args, **kwargs)
                # An NCCL op returned at enqueue: the guard keeps it in
                # flight until the card has done it.
                probe = _completion_probe()
            finally:
                # Mark the guard's progress stream not-in-flight even
                # when the op raised (hazard error, interrupt) — the
                # watchdog must not keep seeing a long-dead entry as
                # "still inside".  Nested composite internals are
                # suppressed by the guard itself.
                _guard_done(name, probe)
            calls.inc()
            hist.observe(time.perf_counter() - t0)
            return out
        return wrapped
    return deco


def _dist():
    import torch.distributed as dist
    return dist


def _grouped() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return _dist().get_world_size() if _grouped() else 1


def rank() -> int:
    return _dist().get_rank() if _grouped() else 0


def _group_device():
    """Where the group's collectives run: the rank's GPU on NCCL, the
    CPU otherwise."""
    import torch
    if _grouped() and _dist().get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _local(x):
    """``(copy, home)``: a private copy of ``x`` on the group's device
    (collectives write their buffer, so the caller's value is never
    it), and the device a tensor input came from (None otherwise)."""
    import torch
    home = x.device if isinstance(x, torch.Tensor) else None
    t = torch.as_tensor(x).detach()
    return t.to(_group_device(), copy=True), home


def _home(t, home):
    return t if home is None else t.to(home)


def _reduce_op(op: str):
    dist = _dist()
    if op not in _OPS:
        raise ValueError(f"op must be one of {sorted(_OPS)}")
    return {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
            "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]


def _mean(t, n: int):
    """``t / n`` in ``t``'s dtype (integers truncate, as an integer
    ``pmean`` does)."""
    import torch
    if t.dtype.is_floating_point:
        return t / n
    return torch.div(t, n, rounding_mode="trunc")


def _check_root(root: int, what: str) -> None:
    """torch.distributed raises on an invalid root; so do we, before
    any rank enters the collective."""
    w = world_size()
    if not 0 <= root < w:
        raise ValueError(f"{what}: root {root} out of range for "
                         f"world size {w}")


@_instrumented("all_reduce")
def all_reduce(x, op: str = "sum"):
    """Elementwise reduce across all ranks; every rank gets the result
    (``dist.all_reduce``, functional: ``x`` is not written).  ``op`` is
    sum, mean, max or min."""
    _guard_check("all_reduce")
    red = _reduce_op(op)
    t, home = _local(x)
    if _grouped():
        _dist().all_reduce(t, op=red)
        if op == "mean":
            t = _mean(t, world_size())
    return _home(t, home)


def _gather_flat(t):
    """``(world, numel)`` of every rank's flattened ``t``, one
    ``all_gather_into_tensor``."""
    import torch
    n = world_size()
    flat = t.reshape(-1).contiguous()
    out = torch.empty((n * flat.numel(),), dtype=t.dtype, device=t.device)
    _dist().all_gather_into_tensor(out, flat)
    return out.reshape(n, -1)


@_instrumented("all_gather")
def all_gather(x):
    """Gather per-rank values; returns them stacked on a leading axis of
    length world size (``dist.all_gather``, functional)."""
    _guard_check("all_gather")
    t, home = _local(x)
    if not _grouped():
        return _home(t[None], home)
    out = _gather_flat(t).reshape((world_size(),) + tuple(t.shape))
    return _home(out, home)


@_instrumented("broadcast")
def broadcast(x, root: int = 0):
    """Every rank returns ``root``'s value (``dist.broadcast``,
    functional); every rank passes a value of the same shape."""
    _guard_check("broadcast")
    _check_root(root, "broadcast")
    t, home = _local(x)
    if _grouped():
        _dist().broadcast(t, src=root)
    return _home(t, home)


@_instrumented("barrier")
def barrier():
    """Block until every rank arrives (``dist.barrier``; the reference
    uses it for %sync at worker.py:213-215)."""
    _guard_check("barrier")
    if _grouped():
        _dist().barrier()


@_instrumented("reduce_scatter")
def reduce_scatter(x, op: str = "sum"):
    """Reduce across ranks, then return this rank's equal chunk of the
    leading axis (``dist.reduce_scatter_tensor``, functional)."""
    _guard_check("reduce_scatter")
    red = _reduce_op(op)
    t, home = _local(x)
    n = world_size()
    if n == 1:
        return _home(t, home)
    if t.dim() == 0 or t.shape[0] % n:
        raise ValueError(f"leading dim of shape {tuple(t.shape)} not "
                         f"divisible by {n} ranks")
    out = _reduce_scatter(t, red)
    if op == "mean":
        out = _mean(out, n)
    return _home(out, home)


def _reduce_scatter(t, red):
    """This rank's chunk of the reduced leading axis of ``t``."""
    import torch
    n = world_size()
    out = torch.empty((t.shape[0] // n,) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    _dist().reduce_scatter_tensor(out, t.contiguous(), op=red)
    return out


@_instrumented("all_reduce_quantized")
def all_reduce_quantized(x, op: str = "sum", *, block: int = 256):
    """Approximate all-reduce with an int8-quantized gather phase
    (EQuARX, arXiv:2506.17615; the JAX package's
    ``collectives.py:308-378``): reduce-scatter in fp32, then each rank
    quantizes its reduced shard blockwise to int8 with a per-block
    absmax scale, and the all-gather moves int8 plus the scales instead
    of fp32 — ~1.6x fewer bytes.  Relative error is bounded by ~1/254
    per block.  Same contract as :func:`all_reduce` for sum and mean;
    use it where exactness matters."""
    import torch
    _guard_check("all_reduce_quantized")
    if op not in ("sum", "mean"):
        raise ValueError("all_reduce_quantized supports op sum|mean")
    t, home = _local(x)
    n = world_size()
    if not _grouped():
        return _home(t, home)
    shape, dtype = t.shape, t.dtype
    flat = t.to(torch.float32).reshape(-1)
    pad = (-flat.numel()) % (n * block)
    flat = torch.nn.functional.pad(flat, (0, pad))
    with _guard_nested():
        shard = _reduce_scatter(flat, _reduce_op("sum"))      # (m,) fp32
    blocks = shard.reshape(-1, block)
    absmax = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    qg = _gather_flat(q)                                   # int8 on the wire
    sg = _gather_flat(scale)
    out = (qg.to(torch.float32).reshape(-1, block)
           * sg.reshape(-1, 1)).reshape(-1)
    if op == "mean":
        out = out / n
    if pad:
        out = out[:-pad]
    if not dtype.is_floating_point:
        # Truncation would bias quantization noise toward zero (a true
        # 3 dequantizing to 2.996 must not become 2).
        out = torch.round(out)
    return _home(out.reshape(shape).to(dtype), home)


@_instrumented("scatter")
def scatter(x, root: int = 0):
    """Rank ``root`` provides a stacked ``(world, ...)`` value; every
    rank returns its own row (``dist.scatter``, functional).  As in the
    JAX package, a broadcast of root's stack and a row slice: the extra
    traffic is ``(world-1)/world`` of the stack, fine at notebook
    scale.  Non-root ranks pass a value of the same shape (any
    values)."""
    _guard_check("scatter")
    _check_root(root, "scatter")
    import torch
    w = world_size()
    shape = tuple(torch.as_tensor(x).shape)
    if shape[:1] != (w,):
        raise ValueError(f"scatter needs a ({w}, ...) stacked value (one "
                         f"row per rank), got shape {shape}")
    with _guard_nested():   # one user-level op = one counted op
        return broadcast(x, root=root)[rank()]


@_instrumented("gather")
def gather(x, root: int = 0):
    """Gather per-rank values to ``root``: root returns the stacked
    ``(world, ...)`` value, every other rank None (``dist.gather``,
    over the all-gather)."""
    _guard_check("gather")
    _check_root(root, "gather")
    with _guard_nested():
        out = all_gather(x)
    return out if rank() == root else None


@_instrumented("reduce")
def reduce(x, root: int = 0, op: str = "sum"):
    """Reduce across ranks to ``root``: root returns the reduced value,
    every other rank None (``dist.reduce``, over the all-reduce)."""
    _guard_check("reduce")
    _check_root(root, "reduce")
    with _guard_nested():
        out = all_reduce(x, op=op)
    return out if rank() == root else None
