"""Runtime collective-hazard guard — SURVEY §5.2's coordinator-side
check, upgraded to call-time enforcement.

The magic layer's pre-flight regex scan (magics/magic.py) warns on
textual matches only: it misses aliased or indirect collective calls
and fires on comments/strings.  This module is the RUNTIME truth:

* the coordinator stamps every execute request with its target ranks
  (``{"code": ..., "target_ranks": [...]}``);
* the worker publishes them for the duration of the cell
  (:func:`begin_cell` / :func:`end_cell` around the executor);
* every eager world-collective (parallel/collectives.py) calls
  :func:`check` on entry.

A world-collective entered by a strict subset of the mesh can never
complete — the absent ranks never join — so :func:`check` raises
:class:`CollectiveHazardError` immediately; the error surfaces
through the normal per-rank error path BEFORE the control plane
would hang waiting on a reply that cannot come.  (In-jit
``lax.psum`` over a worker-local device mesh is a different thing —
device-level, completes locally — and is deliberately not guarded.)

The cell's collective call count and code hash also ride the execute
response (``collective_ops`` / ``cell_sha1``), giving the
coordinator a per-cell record of which ranks ran collective-bearing
code; the magic layer warns on subset records too, covering calls
that happen to complete locally (e.g. a single-process world where
``all_reduce`` is the identity).

The worker's message loop is serial, so plain module state suffices;
a user thread calling a collective outside any cell sees inactive
state and passes.

Beyond the hazard check, this module is also the worker-side half of
the **hang watchdog**: every guarded entry advances a
monotonic per-process collective sequence and publishes a compact
``(seq, op, entered-at, in-flight)`` snapshot that the heartbeat
thread piggybacks on its pings.  The coordinator's watchdog compares
these positions across ranks — "ranks 0–2 entered ``all_reduce`` #7,
rank 3 never did" is the signature of a wedged rank that heartbeats
alone can never show (the process is alive; it is just stuck).  The
snapshot is a single tuple replaced atomically, so the heartbeat
thread's read can never tear against the main thread's write.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
import time


class CollectiveHazardError(RuntimeError):
    """A world-collective was invoked from a cell running on a strict
    subset of the mesh — raised at call time instead of deadlocking
    the cluster."""


_state: dict = {"targets": None, "world": 0, "ops": 0, "nested": 0}

# Collective progress stream (hang watchdog).  ``_snap`` is
# the atomically-replaced snapshot tuple ``(seq, op, entered_at_mono,
# in_flight)``; ``seq`` is monotonic over the PROCESS lifetime (not
# reset per cell) so the coordinator can order positions across cells
# without extra bookkeeping.  ``_freeze_hook`` is the chaos harness's
# injection point: called at every guarded entry with (op, seq) and
# may block — how a test freezes a rank "inside" a collective.
_snap: tuple | None = None
_freeze_hook = None
# The in-flight entry's completion probe, ``(seq, callable)`` (None:
# done on return).  ``_lock`` orders the heartbeat thread's "probe
# says complete" write after any newer entry the main thread made.
_probe = None
_lock = threading.Lock()


def set_freeze_hook(fn) -> None:
    """Install (or clear, with ``None``) the chaos freeze hook — a
    callable ``(op, seq)`` run at each guarded collective entry, on
    the cell's own thread, allowed to sleep.  Wired by the worker from
    its :class:`~nbdistributed_tpu_torch.resilience.faults.FaultPlan`."""
    global _freeze_hook
    _freeze_hook = fn


def progress() -> dict | None:
    """Compact position-in-the-collective-stream snapshot for the
    heartbeat piggyback: ``{"seq", "op", "in", "age", "cops"}`` —
    global sequence number, last op entered, whether the rank is
    still inside it, seconds since entry (monotonic clock), and the
    current cell's op count.  ``None`` before the first collective
    (keeps idle pings small)."""
    global _snap
    s = _snap
    if s is None:
        return None
    seq, op, t, in_flight = s
    pr = _probe
    if in_flight and pr is not None and pr[0] == seq:
        try:
            complete = bool(pr[1]())
        except Exception:
            complete = True     # a dead probe must not pin "in"
        if complete:
            with _lock:
                if _snap is s:
                    _snap = (seq, op, t, False)
                    in_flight = False
    return {"seq": seq, "op": op, "in": in_flight,
            "age": round(time.monotonic() - t, 3),
            "cops": _state["ops"]}


@contextlib.contextmanager
def nested():
    """Context manager for composite collectives (scatter/gather/
    reduce) delegating to guarded primitives: the composite counts
    itself once via :func:`check`, then suppresses the inner
    primitives' counts so one user-level call records one op (the
    subset raise already happened at the composite's own check)."""
    _state["nested"] += 1
    try:
        yield
    finally:
        _state["nested"] -= 1


def begin_cell(targets, world: int) -> None:
    """Publish the current cell's target ranks (``None`` = unknown —
    legacy raw-string execute requests — which disables the subset
    check but keeps the op count)."""
    _state["targets"] = None if targets is None else sorted(targets)
    _state["world"] = int(world)
    _state["ops"] = 0


def end_cell() -> int:
    """Clear the cell context; returns the number of eager
    world-collective calls the cell made."""
    ops = _state["ops"]
    _state["targets"], _state["world"], _state["ops"] = None, 0, 0
    _state["nested"] = 0
    return ops


def cell_hash(code: str) -> str:
    """Stable short id for a cell's source, reported alongside the
    collective count so the coordinator can correlate executions of
    the same cell across ranks."""
    return hashlib.sha1(code.encode()).hexdigest()[:12]


def enter(op: str) -> bool:
    """Advance the progress stream for one world-collective entry and
    run the chaos freeze hook — which may block this rank right here,
    the deterministic stand-in for "wedged inside a collective".  No
    hazard check: the seeded ``dist``'s entry point.  Returns False
    (nothing recorded) inside a composite."""
    global _snap, _probe
    if _state["nested"]:
        return False            # implementation detail of a composite
    _state["ops"] += 1
    with _lock:
        prev = _snap
        seq = (prev[0] if prev is not None else 0) + 1
        _probe = None
        _snap = (seq, op, time.monotonic(), True)
    fz = _freeze_hook
    if fz is not None:
        fz(op, seq)
    return True


def check(op: str) -> None:
    """Entry hook for each eager world-collective.  Advances the
    progress stream (the watchdog's skew signal) BEFORE the hazard
    check so even a call that raises is on record, then the hazard
    check."""
    if not enter(op):
        return
    targets, world = _state["targets"], _state["world"]
    if targets is not None and world and len(targets) < world:
        raise CollectiveHazardError(
            f"{op}() called from a cell running on ranks {targets} — "
            f"a strict subset of the {world}-rank mesh.  A "
            f"world-collective entered by a subset never completes "
            f"(the other ranks never join) and would deadlock the "
            f"cluster; run the cell on all ranks, or keep subset "
            f"cells to rank-local work.")


def done(op: str, probe=None) -> None:
    """Exit hook for each eager world-collective (called by the
    ``_instrumented`` wrapper in a ``finally``, so an op that raised
    — hazard error, interrupt — is still marked not-in-flight).
    ``probe``: a zero-argument callable true once the collective's work
    has completed (an NCCL op returns at enqueue); the entry then stays
    in flight until :func:`progress` finds it true.  Nested composite
    internals are suppressed like :func:`check`."""
    global _snap, _probe
    if _state["nested"]:
        return
    if probe is not None:
        try:
            pending = not probe()
        except Exception:
            pending = False
        if pending:
            s = _snap
            if s is not None and s[3]:
                _probe = (s[0], probe)
            return
    with _lock:
        s = _snap
        if s is not None and s[3]:
            _probe = None
            _snap = (s[0], s[1], s[2], False)


def reset_progress() -> None:
    """Test helper: forget the progress stream (and any freeze hook)
    so suites that re-enter worlds start from seq 0."""
    global _snap, _freeze_hook, _probe
    _snap = None
    _freeze_hook = None
    _probe = None
