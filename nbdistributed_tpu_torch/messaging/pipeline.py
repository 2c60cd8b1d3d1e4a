"""Async pipelined executor: spend the effects DAG on wall-clock (a
copy of ``nbdistributed_tpu/messaging/pipeline.py``).

The effects engine (``analysis/effects.py``) proves cells
collective-free and the per-session dependency DAG
(``analysis/preflight.py``) answers "is cell N+1 independent of cell
N"; without this module the coordinator still dispatched one cell,
blocked on its reply, then dispatched the next, paying a control-plane
round trip per cell.  This executor converts the proofs into overlap:
**decouple submission from completion**.  The coordinator streams
cells N+1..N+k to the workers while cell N runs; the per-rank worker
loop is serial and its channel is FIFO, so streamed cells execute
back-to-back with zero inter-cell coordinator round-trips, and every
rank sees the same order.

The in-flight window is bounded by ``NBD_ASYNC_WINDOW`` and **gated by
the deps DAG + effects verdicts** — the same analyses
``%dist_lint deps`` renders:

* a cell may enter the window only when it has **no RAW/WAR/WAW
  hazard edge** to any in-flight cell
  (:func:`~..analysis.preflight.hazard_names` — literally the function
  that draws the DAG's edges, so "no edge" and "admissible" cannot
  drift apart);
* AND it is proven collective-free, OR it is the **sole**
  collective-bearing cell in flight — the one-collective-stream
  invariant (two concurrent
  collective streams carry no cross-rank ordering guarantee under
  retries/redelivery, so at most one is ever outstanding);
* opaque / unparseable / unknown-footprint cells **drain the window
  and run serialized** (their footprint edges to everything — the
  hazard test enforces this on its own; the explicit reason string is
  for diagnosability).

A blocked submission *waits* (draining the oldest in-flight work)
rather than failing: program order is always preserved per rank by
channel FIFO, so the gate is about cross-cell result/namespace
consistency and collective-stream safety, never about reordering.

Completion is event-driven: each in-flight cell's
:class:`~.coordinator.PendingHandle` resolves its
:class:`~..magics.proxies.CellFuture` from the coordinator's IO
thread the moment the last reply lands — no waiter thread per cell,
no polling.  On each completion the executor also bumps the latency
observatory's grant stamp for every still-in-flight successor
(:meth:`~..observability.latency.LatencyObservatory.note_worker_free`)
so a pipelined cell's socket-sit time behind its predecessor is
attributed to the ``queue`` stage, not double-counted as ``wire``.

Pure-testable by construction: the only comm surface used is
``submit(...) -> handle`` with ``handle.add_done_callback`` /
``handle.wait`` — the unit tests drive the whole admission state
machine with a fake comm and hand-fired handles, zero sleeps.
"""

from __future__ import annotations

import threading
import time

from ..analysis import preflight
from ..observability import flightrec
from ..observability import metrics as obs_metrics
from ..utils import knobs

DEFAULT_WINDOW = 4

# Documented exemptions for the blocking-under-lock self-lint
# (analysis/concur.py): per-site "Class.method:op" → reason.
_LINT_BLOCKING_OK = {
    "AsyncExecutor._blocked_reason_locked:join":
        "str.join over hazard-name strings — not Thread.join; no IO",
    "AsyncExecutor.submit_cell:wait":
        "Condition.wait RELEASES the lock while blocking — the "
        "admission wait parking a held submitter until a completion "
        "notify is the designed pattern, not IO under a held lock",
}

# Documented exemptions for the lifecycle self-lint
# (analysis/lifecycle.py): per-site "Class.method:resource" → reason.
_LINT_LIFECYCLE_OK = {
    "AsyncExecutor.submit_cell:async-window":
        "the slot is released on the COMPLETION path by design (the "
        "IO thread's done callback pops the cell), and the raise "
        "edges are covered piecewise: the payload is built before "
        "window entry, nothing between the append and the wire "
        "submit can throw, and the submit's own `except "
        "BaseException` removes the cell before re-raising",
}

# Collective-admission classes (analysis.effects.collective_class).
FREE, BEARING, UNKNOWN = "free", "bearing", "unknown"


def classify_entry(entry: dict | None) -> str:
    """The three-way collective class of a recorded footprint entry
    (the dict form of ``EffectReport.as_dict()``), mirroring
    ``analysis.effects.collective_class`` for the preflight store's
    entries: missing/unparsed/opaque → unknown."""
    if not entry or not entry.get("parsed") or entry.get("opaque"):
        return UNKNOWN
    verdict = entry.get("collective_verdict")
    if verdict == "none":
        return FREE
    if verdict == "exact":
        return BEARING
    return UNKNOWN


def _opaque(entry: dict | None) -> bool:
    return not entry or not entry.get("parsed") or entry.get("opaque")


class InFlightCell:
    """One windowed cell: its footprint, admission class, future, and
    wire handle.  ``settled`` is set once its completion has run to
    the end, the ``on_result`` hook included."""

    __slots__ = ("seq", "msg_id", "sha", "entry", "collective",
                 "future", "handle", "submitted_at", "settled")

    def __init__(self, seq, msg_id, sha, entry, collective, future,
                 handle, submitted_at):
        self.seq = seq
        self.msg_id = msg_id
        self.sha = sha
        self.entry = entry
        self.collective = collective
        self.future = future
        self.handle = handle
        self.submitted_at = submitted_at
        self.settled = threading.Event()


class AsyncExecutor:
    """The bounded, DAG-gated in-flight window over one
    :class:`~.coordinator.CommunicationManager` (or anything exposing
    its ``submit``/``lat`` surface)."""

    def __init__(self, comm, *, window: int | None = None,
                 now=time.monotonic, on_hold=None, on_result=None):
        self.comm = comm
        if window is None:
            window = knobs.get_int("NBD_ASYNC_WINDOW", 0) \
                or DEFAULT_WINDOW
        self.window = max(1, int(window))
        self._now = now
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._inflight: list[InFlightCell] = []
        # Cells out of the window whose completion (hook included) is
        # still running on the thread that settled them.
        self._settling: list[InFlightCell] = []
        self._futures: list = []       # session order, bounded below
        self._seq = 0
        # Why the last submission waited, for status surfaces.
        self.on_hold = on_hold         # callable(reason_str) | None
        self.on_result = on_result     # callable(InFlightCell) | None
        self.submitted = 0
        self.completed = 0
        self.errored = 0
        self.held_total = 0

    # ------------------------------------------------------------------
    # admission predicate (pure; `_locked` = caller holds self._lock)

    def _blocked_reason_locked(self, entry: dict | None,
                               collective: str) -> str | None:
        """None when the cell may enter the window NOW, else a human
        reason naming the gate that held it."""
        if len(self._inflight) >= self.window:
            return (f"window full ({len(self._inflight)}/"
                    f"{self.window} in flight)")
        if _opaque(entry) and self._inflight:
            # The hazard test below would also catch this (opaque
            # edges to everything) — the dedicated reason names it.
            return ("opaque/unknown footprint — drains the window and "
                    "runs serialized")
        for f in self._inflight:
            names = preflight.hazard_names(f.entry or {"opaque": True},
                                           entry or {"opaque": True})
            if names:
                shown = ", ".join(names[:4])
                if len(names) > 4:
                    shown += f" +{len(names) - 4}"
                return (f"RAW/WAR/WAW hazard {{{shown}}} with "
                        f"in-flight cell #{f.seq}")
        if collective != FREE and any(f.collective != FREE
                                      for f in self._inflight):
            holder = next(f for f in self._inflight
                          if f.collective != FREE)
            return (f"one-collective-stream: in-flight cell "
                    f"#{holder.seq} already holds the collective "
                    f"stream ({holder.collective})")
        return None

    def try_admit(self, entry: dict | None,
                  collective: str | None = None) -> str | None:
        """Non-blocking admission probe (the unit-test surface):
        None = admissible now, else the blocking reason."""
        if collective is None:
            collective = classify_entry(entry)
        with self._lock:
            return self._blocked_reason_locked(entry, collective)

    # ------------------------------------------------------------------

    def submit_cell(self, code: str, ranks: list[int], *,
                    entry: dict | None = None, sha: str = "",
                    future=None, deadline_s: float | None = None,
                    repeat: int | None = None,
                    until: str | None = None,
                    vet_s: float | None = None,
                    timeout: float | None = ...):
        """Admit one cell into the window (blocking while the DAG /
        collective / depth gates hold it) and stream it to the
        workers.  Returns the resolved-later ``future`` (a
        :class:`~..magics.proxies.CellFuture` by default).

        The blocking wait is interruptible: a KeyboardInterrupt while
        held leaves the window intact and propagates (nothing was
        submitted)."""
        if future is None:
            from ..magics.proxies import CellFuture
            future = CellFuture(code, self._next_seq(), list(ranks))
        # Built BEFORE window entry: between the _inflight.append and
        # the wire submit's own repark-on-raise there must be no
        # statement that can throw, or the window slot strands
        # (lifecycle-lint bracket discipline).
        payload = {"code": code, "target_ranks": list(ranks)}
        if deadline_s is not None:
            payload["deadline_s"] = deadline_s
        if repeat is not None:
            payload["repeat"] = int(repeat)
            if until:
                payload["until"] = until
        collective = classify_entry(entry)
        cell = InFlightCell(future.seq, None, sha, entry, collective,
                            future, None, self._now())
        told = False
        while True:
            notify = None
            with self._cond:
                reason = self._blocked_reason_locked(entry, collective)
                if reason is None:
                    # Gate pass and window entry are ATOMIC — two
                    # racing submitters cannot both squeeze past the
                    # same free slot.  Registered BEFORE the wire
                    # submit: the IO thread may fire the done callback
                    # before submit() even returns on a fast (or
                    # fake) comm, and the pop must find the cell.
                    self._inflight.append(cell)
                    break
                if not told:
                    self.held_total += 1
                    notify = reason
                else:
                    # Completions notify this condition from the IO
                    # thread; the short timeout is a safety net
                    # against a missed notify, not a poll loop.
                    self._cond.wait(0.25)
            if notify is not None:
                told = True
                if self.on_hold is not None:
                    # Outside the lock: a callback that prints (or
                    # re-enters this object) must not deadlock it.
                    try:
                        self.on_hold(notify)
                    except Exception:
                        pass
            # A held submitter is the async window's retry driver:
            # nobody sits in wait() for a streamed cell, so due
            # redeliveries (and blown submit deadlines) of the cells
            # blocking us are pumped here — a lost request costs one
            # backoff interval, not "forever until %dist_wait".
            self._pump_inflight()
        try:
            # The cell identity rides the closure: the done callback
            # can fire from the IO thread BEFORE submit() returns (a
            # fast reply, a fake comm), i.e. before cell.handle is
            # even assigned — matching by handle would lose the race.
            handle = self.comm.submit(
                ranks, "execute", payload, vet_s=vet_s,
                timeout=timeout,
                on_done=lambda h: self._on_done_cell(cell, h))
        except BaseException as e:
            with self._cond:
                if cell in self._inflight:
                    self._inflight.remove(cell)
                self._cond.notify_all()
            if isinstance(e, Exception):
                future.reject(e)
                self._note_done(cell)
            cell.settled.set()
            raise
        cell.handle = handle
        cell.msg_id = handle.msg_id
        future.msg_id = handle.msg_id
        with self._lock:
            self.submitted += 1
            self._futures.append(future)
            while len(self._futures) > 256:
                self._futures.pop(0)
        flightrec.record("async_submit", msg_id=handle.msg_id,
                         seq=future.seq, window=len(self._inflight),
                         collective=collective)
        return future

    def _next_seq(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def _pump_inflight(self) -> None:
        """Drive due redeliveries / blown deadlines for every
        in-flight handle (non-blocking; see ``PendingHandle.pump``)."""
        with self._lock:
            handles = [c.handle for c in self._inflight
                       if c.handle is not None]
        for h in handles:
            try:
                h.pump()
            except Exception:
                pass  # maintenance must never break submission

    # ------------------------------------------------------------------
    # completion (IO thread)

    def _on_done_cell(self, cell: InFlightCell, handle) -> None:
        """PendingHandle done-callback: resolve the cell's future, pop
        it from the window, re-stamp successors' grant time (overlap-
        aware latency attribution), wake blocked submitters.
        Idempotent per cell — the drain path re-invokes it for
        handles whose terminal state came from wait() itself."""
        with self._cond:
            if cell not in self._inflight:
                return
            self._inflight.remove(cell)
            self._settling.append(cell)
            remaining = list(self._inflight)
            self._cond.notify_all()
        try:
            self._settle(cell, handle, remaining)
        finally:
            with self._lock:
                self._settling.remove(cell)
            cell.settled.set()

    def _settle(self, cell: InFlightCell, handle, remaining) -> None:
        if cell.msg_id is None:
            cell.msg_id = handle.msg_id
            cell.future.msg_id = handle.msg_id
        err = handle.error
        if err is not None:
            cell.future.reject(err)
        else:
            results = {}
            try:
                for r, m in (handle.results or {}).items():
                    results[r] = getattr(m, "data", m)
            except Exception:
                pass
            cell.future.resolve(results)
        with self._lock:
            self.completed += 1
            if cell.future.state == "error":
                self.errored += 1
        # The worker freed up when this cell's reply landed: every
        # still-in-flight successor has been WAITING behind it, not on
        # the wire — move its grant stamp so the latency observatory
        # books that wait as `queue`, never as `wire` (the pipelined
        # no-double-count contract).
        lat = getattr(self.comm, "lat", None)
        if lat is not None:
            for f in remaining:
                if f.msg_id is not None:
                    try:
                        lat.note_worker_free(f.msg_id)
                    except Exception:
                        pass
        obs_metrics.registry().counter(
            "nbd_async_cells_total",
            "async-window cells completed",
            {"status": cell.future.state}).inc()
        self._note_done(cell)

    def _note_done(self, cell: InFlightCell) -> None:
        if self.on_result is not None:
            try:
                self.on_result(cell)
            except Exception:
                pass

    # ------------------------------------------------------------------
    # draining (the sync points: %dist_wait, synchronous cells)

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._inflight)

    def drain(self, timeout: float | None = None) -> list:
        """Wait until the window is empty (the explicit sync point:
        ``%dist_wait`` / ``%%distributed --sync``); drives the retry
        schedule of any straggler via its handle.  Returns the futures
        that were in flight when the drain began, settled or not (on
        timeout some may still be pending)."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._lock:
            targets = list(self._inflight)
            settling = list(self._settling)
        for cell in settling:
            cell.settled.wait()
        for cell in targets:
            if deadline is None:
                if cell.handle is not None:
                    try:
                        # Full wait on the submit-time budget: drives
                        # the retry schedule for a straggler; every
                        # terminal settle (success, death, timeout)
                        # fires the done callback, which resolves the
                        # future and pops the window.
                        cell.handle.wait()
                    except Exception:
                        pass  # the outcome lives on the future
                    self._on_done_cell(cell, cell.handle)
                else:
                    cell.future.wait(None)
                # Whichever thread settled the handle runs the
                # completion; return only once it has run to the end,
                # so what its hook printed lies inside the drain (the
                # JAX package's drain can return mid-hook).
                cell.settled.wait()
            else:
                # Bounded drain is NON-destructive: wait on the
                # completion only — a cell still pending at the
                # deadline stays in flight instead of being aborted
                # the way a timed-out synchronous wait would be.
                # Pump between slices so stragglers still get their
                # due redeliveries while we watch.
                while not cell.settled.wait(
                        min(0.25, max(0.0,
                                      deadline - time.monotonic()))):
                    if time.monotonic() >= deadline:
                        break
                    self._pump_inflight()
        return [c.future for c in targets]

    def unconsumed_errors(self) -> list:
        """Errored futures nobody has looked at — the next-cell warn
        pass (each returned future is marked warned, so the nag fires
        once; the error itself stays on the future for .result())."""
        out = []
        with self._lock:
            for fut in self._futures:
                if (fut.state == "error" and not fut.consumed
                        and not fut.warned):
                    fut.warned = True
                    out.append(fut)
        return out

    def snapshot(self) -> dict:
        """The ``%dist_status`` / ``%dist_doctor`` view: window depth
        and bound, per-cell state, and which in-flight cell (if any)
        holds the collective stream."""
        with self._lock:
            cells = [{"seq": c.seq,
                      "msg_id": c.msg_id,
                      "sha": (c.sha or "")[:10],
                      "collective": c.collective,
                      "age_s": round(self._now() - c.submitted_at, 2),
                      "state": c.future.state}
                     for c in self._inflight]
            holder = next((c["seq"] for c in cells
                           if c["collective"] != FREE), None)
            return {"window": self.window,
                    "depth": len(cells),
                    "cells": cells,
                    "collective_holder": holder,
                    "submitted": self.submitted,
                    "completed": self.completed,
                    "errored": self.errored,
                    "held_total": self.held_total}
