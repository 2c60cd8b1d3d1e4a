"""The ``dist`` a worker seeds into the namespace: ``torch.distributed``
with its world collectives on the hang watchdog's progress stream.

The reference nbdistributed's cells call ``dist.all_reduce(t)``.  The
JAX package's watchdog reads each rank's position in the stream of
eager world collectives (``runtime/collective_guard.py``); here that
stream counts the seeded ``dist``'s collectives too, so a hung
``dist.all_reduce`` can be named as ``skew`` ("ranks 0–2 entered
all_reduce #7, rank 3 never did") and not only as a ``stall``.

Every attribute is ``torch.distributed``'s; only the names in
:data:`WORLD_COLLECTIVES` come back wrapped, and only a call on the
world group (no ``group``, or ``group.WORLD``) is counted.  The wrapper
records the entry with :func:`collective_guard.enter`, which runs no
hazard check: a subset cell calling ``dist.all_reduce`` is refused by
the pre-dispatch vetting (``%dist_lint strict``) and otherwise behaves
as before.  On an NCCL group a collective returns once enqueued, so
the exit carries a completion probe (:func:`completion_probe`) and the
entry reads as in flight until the work is done on the card.
"""

from __future__ import annotations

import functools
import inspect
import types

from . import collective_guard

# torch.distributed's world collectives (point-to-point sends and
# receives are not: a pair of ranks, not the world, takes part).
WORLD_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "all_to_all", "all_to_all_single", "barrier",
    "broadcast", "broadcast_object_list", "gather", "gather_object",
    "monitored_barrier", "reduce", "reduce_scatter",
    "reduce_scatter_tensor", "scatter", "scatter_object_list"})


def completion_probe(out=None):
    """A zero-argument callable, true once the collective just issued
    has completed, or None where the call's return already means that.
    ``out`` is the call's result: a ``Work`` (``async_op=True``) is
    asked directly; otherwise, on an NCCL default group, a CUDA event
    recorded on the current stream (which the collective's ``wait``
    made wait for the NCCL stream) is."""
    if out is not None and callable(getattr(out, "is_completed", None)):
        return out.is_completed
    import torch
    import torch.distributed as dist
    if not (dist.is_initialized() and dist.get_backend() == "nccl"
            and torch.cuda.is_available()):
        return None
    event = torch.cuda.Event()
    event.record()
    return event.query


def _on_world(sig, args, kwargs) -> bool:
    import torch.distributed as dist
    group = kwargs.get("group")
    if group is None and sig is not None and len(args) > 1:
        try:
            group = sig.bind_partial(*args, **kwargs).arguments.get("group")
        except TypeError:
            group = None
    return group is None or group is dist.group.WORLD


def _tracked(name: str, fn):
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        sig = None

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if not _on_world(sig, args, kwargs):
            return fn(*args, **kwargs)
        if not collective_guard.enter(name):
            return fn(*args, **kwargs)
        probe = None
        try:
            out = fn(*args, **kwargs)
            probe = completion_probe(out)
            return out
        finally:
            collective_guard.done(name, probe)
    return call


class TrackedDist(types.ModuleType):
    """``torch.distributed`` by attribute, its world collectives
    tracked (wrappers built once per name)."""

    def __init__(self):
        super().__init__("torch.distributed",
                         "torch.distributed, its world collectives on "
                         "the hang watchdog's progress stream")

    def __getattr__(self, name):
        import torch.distributed as dist
        value = getattr(dist, name)
        if name in WORLD_COLLECTIVES and callable(value):
            value = _tracked(name, value)
            setattr(self, name, value)
        return value

    def __dir__(self):
        import torch.distributed as dist
        return dir(dist)

    def __repr__(self):
        return "<module 'torch.distributed' (tracked collectives)>"
