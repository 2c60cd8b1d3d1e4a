"""Coordinator-side control-plane manager.

Equivalent of the reference's ``CommunicationManager``
(reference: communication.py:65-389), rebuilt on the sockets transport with
three structural fixes called out in SURVEY §7:

1. **Per-request expectation sets.**  The reference's completion Event only
   fires at full world size, forcing the subset path (``send_to_ranks``) to
   busy-poll every 10 ms (reference: communication.py:348-359).  Here every
   request carries its own expected-rank set and its own Event, so targeted
   and broadcast requests share one wait path with no polling.
2. **Fail-fast on worker death.**  With ``timeout=None`` the reference
   blocks forever if a worker dies mid-request
   (reference: communication.py:263-269).  The transport's disconnect
   callback (and the process manager's child monitor, via
   :meth:`mark_worker_dead`) abort all pending requests that still expect
   the dead rank.
3. **Readiness handshake.**  ``wait_for_workers`` observes HELLO
   attachments, replacing the spawn-then-``sleep(2)`` race
   (reference: process_manager.py:136-137).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable

from ..gateway.scheduler import (ACTIVE, SHED, CellRejected, CellShed,
                                 Scheduler)
from ..observability import flightrec
from ..observability import metrics as obs_metrics
from ..observability import spans as obs_spans
from ..observability.clock import ClockEstimator
from ..observability.latency import LatencyObservatory
from ..resilience.retry import RetryPolicy, class_of
from ..utils import knobs
from .codec import Message
from .native import make_listener
from .transport import TransportError


# Documented exemptions for the thread-shared-state self-lint
# (analysis/selfcheck.py): attributes with exactly one writer thread
# (or GIL-atomic mutation) that deliberately skip the lock.
_LINT_SINGLE_WRITER = {
    "CommunicationManager._notify_callbacks":
        "registered from the main thread at wiring time only; list "
        "append is atomic under the GIL and the IO thread only "
        "iterates",
}


class WorkerDied(RuntimeError):
    """A worker exited/disconnected while a request was pending on it.

    ``msg_id`` names the pending request that was aborted (when raised
    from one) — the postmortem layer matches it against the dead
    rank's recovered flight ring to find the fatal dispatch."""

    msg_id: str | None = None


class _Pending:
    __slots__ = ("expect", "responses", "event", "failure", "sent_at",
                 "msg_type", "cell_sha1", "tenant", "on_done")

    def __init__(self, expect: set[int], msg_type: str = "",
                 tenant: str | None = None):
        self.msg_type = msg_type
        # Completion hook for ASYNC submissions: invoked on
        # the IO thread right after ``event.set()`` so a pipelined
        # cell's future resolves the moment its last reply lands,
        # without a waiter thread per in-flight cell.  None on the
        # synchronous path — wait() then finalizes on the caller
        # thread exactly as before the submit/wait split.
        self.on_done = None
        # Which tenant's cell this is (gateway pools) — lets the hang
        # watchdog / doctor / %dist_top attribute an in-flight request
        # to the right tenant.  None on the single-kernel path.
        self.tenant = tenant
        self.expect = set(expect)
        self.responses: dict[int, Message] = {}
        self.event = threading.Event()
        self.failure: Exception | None = None
        # Wall clock of the FIRST delivery: the t_send of the NTP-style
        # clock samples (observability/clock.py).  Redeliveries do not
        # refresh it — a retried sample just has a big RTT and loses
        # the min-RTT filter.
        self.sent_at: float = 0.0
        # Source hash of an execute request's cell (the same value the
        # worker reports as ``cell_sha1``): lets a hang verdict on this
        # request cite the pre-dispatch lint finding for its cell.
        self.cell_sha1: str | None = None


class PendingHandle:
    """One in-flight request: the submission half of the old blocking
    ``send_to_ranks``.

    :meth:`CommunicationManager.submit` transmits the request and
    returns this handle immediately; :meth:`wait` drives the retry/
    redelivery schedule and collects the responses — today's blocking
    call is literally ``submit(...).wait()`` on the same code path, so
    the async pipeline and the synchronous magics share every wire,
    scheduler, retry, and latency-stage behavior.

    Completion is terminal and idempotent: whichever of the IO-thread
    ``on_done`` hook (async submissions), a :meth:`wait` caller, or a
    timeout settles first wins; later settlers observe the stored
    result/error.  ``add_done_callback`` fires on (or after) that
    first settle — from the IO thread for event-driven completion, so
    callbacks must be fast and non-blocking.
    """

    def __init__(self, comm: "CommunicationManager", msg: Message,
                 msg_type: str, ranks: list[int], pending: _Pending,
                 ticket, timeout: float | None, deadline: float | None,
                 tenant: str | None, span):
        self._comm = comm
        self.msg = msg
        self.msg_id = msg.msg_id
        self.msg_type = msg_type
        self.ranks = list(ranks)
        self.tenant = tenant
        self._pending = pending
        self._ticket = ticket
        self._timeout = timeout
        self._deadline = deadline
        self._span = span
        self._done_lock = threading.Lock()
        self._terminal = False
        self._result: dict[int, Message] | None = None
        self._error: Exception | None = None
        self._callbacks: list = []

    @classmethod
    def resolved(cls, result: dict) -> "PendingHandle":
        """An already-complete handle (empty rank set — nothing was
        ever on the wire, mirroring the old early ``return {}``)."""
        h = cls.__new__(cls)
        h._comm = None
        h.msg = None
        h.msg_id = None
        h.msg_type = ""
        h.ranks = []
        h.tenant = None
        h._pending = None
        h._ticket = None
        h._timeout = None
        h._deadline = None
        h._span = None
        h._done_lock = threading.Lock()
        h._terminal = True
        h._result = dict(result)
        h._error = None
        h._callbacks = []
        return h

    # ------------------------------------------------------------------

    def done(self) -> bool:
        return self._terminal or self._pending.event.is_set()

    @property
    def error(self) -> Exception | None:
        return self._error

    @property
    def results(self) -> dict[int, Message] | None:
        """The collected rank→reply map after a successful settle,
        None before (or on failure)."""
        return self._result

    def add_done_callback(self, cb) -> None:
        """``cb(handle)`` after the handle settles (immediately when it
        already has).  IO-thread dispatch for event-driven completion."""
        fire = False
        with self._done_lock:
            if self._terminal:
                fire = True
            else:
                self._callbacks.append(cb)
        if fire:
            try:
                cb(self)
            except Exception:
                pass

    # ------------------------------------------------------------------
    # settle paths (each terminal, first one wins)

    def _event_fired(self) -> None:
        """IO-thread hook (``_Pending.on_done``): the expectation set
        completed or a death aborted it — settle from pending state."""
        self._settle_from_pending()

    def _settle_from_pending(self) -> None:
        pending = self._pending
        with self._done_lock:
            if self._terminal:
                return
            if pending.failure is not None:
                self._error = pending.failure
            else:
                with self._comm._lock:
                    self._result = dict(pending.responses)
            self._terminal = True
            cbs, self._callbacks = self._callbacks, []
        self._comm._finish(self, self._error)
        for cb in cbs:
            try:
                cb(self)
            except Exception:
                pass

    def _fail(self, exc: Exception) -> None:
        with self._done_lock:
            if self._terminal:
                return
            self._error = exc
            self._terminal = True
            cbs, self._callbacks = self._callbacks, []
        self._comm._finish(self, exc)
        for cb in cbs:
            try:
                cb(self)
            except Exception:
                pass

    def _outcome(self) -> dict[int, Message]:
        if self._error is not None:
            raise self._error
        return self._result if self._result is not None else {}

    # ------------------------------------------------------------------

    def wait(self, timeout: float | None = ...) -> dict[int, Message]:
        """Collect the responses (the completion half of the old
        ``send_to_ranks``): waits on the expectation set, driving the
        retry/redelivery schedule exactly as the blocking call did.
        ``timeout=...`` keeps the budget given at submit (whose clock
        started THEN — queue time is part of the caller's wait);
        an explicit value restarts the budget from now.  Idempotent:
        a settled handle returns (or re-raises) its stored outcome."""
        if self._terminal:
            return self._outcome()
        comm, msg, pending = self._comm, self.msg, self._pending
        if timeout is ...:
            timeout, deadline = self._timeout, self._deadline
        else:
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
        policy = comm.retry_for(self.msg_type)
        attempts = policy.attempts if policy.enabled() else 1
        complete = False
        try:
            for attempt in range(1, attempts + 1):
                if self._terminal or pending.event.is_set():
                    complete = True
                    break
                if attempt > 1:
                    self._redeliver_missing(attempt - 1)
                if attempt == attempts:
                    step = (None if deadline is None
                            else max(0.0, deadline - time.monotonic()))
                else:
                    step = policy.attempt_wait_s(attempt - 1)
                    if deadline is not None:
                        step = min(step,
                                   max(0.0,
                                       deadline - time.monotonic()))
                complete = pending.event.wait(step)
                if complete:
                    break
                if (deadline is not None
                        and time.monotonic() >= deadline):
                    break
        except BaseException as e:
            # Mirror the pre-split finally blocks: a KeyboardInterrupt
            # (or anything unexpected) escaping the blocking wait must
            # still release the pending-table entry, the trace span,
            # the mesh slot, and the stage record — without this, a
            # Ctrl-C during %sync left a phantom ACTIVE request that
            # wedged every later cell behind the occupied slot.
            if isinstance(e, Exception):
                self._fail(e)
            else:
                self._fail(RuntimeError(
                    f"wait aborted by {type(e).__name__}"))
            raise
        if not complete and not self._terminal \
                and not pending.event.is_set():
            with comm._lock:  # IO thread inserts under the same lock
                got = set(pending.responses)
            missing = sorted(pending.expect - got)
            err = TimeoutError(
                f"no response from ranks {missing} within {timeout}s "
                f"for '{self.msg_type}'"
                + (f" ({attempts} deliveries)" if attempts > 1 else ""))
            self._fail(err)
            raise err
        self._settle_from_pending()
        return self._outcome()

    def _redeliver_missing(self, attempt: int) -> None:
        """One redelivery to the still-missing ranks, same msg_id (the
        worker replay cache makes this idempotent).  Shared by the
        blocking wait's retry schedule and the async window's
        :meth:`pump`."""
        comm, msg, pending = self._comm, self.msg, self._pending
        with comm._lock:
            missing_now = sorted(pending.expect
                                 - set(pending.responses))
        msg.attempt = attempt
        try:
            comm.flight.record("retry", msg_id=msg.msg_id,
                               attempt=msg.attempt,
                               ranks=missing_now)
            comm._listener.send_to_ranks(missing_now, msg)
            with comm._lock:
                # Concurrent senders (a %dist_top reader, two cells
                # in flight) share this counter: the read-modify-
                # write needs the lock.
                comm.retries_sent += 1
                for r in missing_now:
                    comm.retries_by_rank[r] = \
                        comm.retries_by_rank.get(r, 0) + 1
            obs_metrics.registry().counter(
                "nbd_retries_total",
                "request redeliveries transmitted").inc()
        except TransportError:
            pass  # disconnected rank: death callback aborts us

    def pump(self, now: float | None = None) -> None:
        """Non-blocking maintenance for an ASYNC in-flight request:
        nobody sits in :meth:`wait` for a windowed cell,
        so without this a lost request would never be redelivered and
        a submit-time deadline would never fire until an unbounded
        drain.  The async executor pumps its in-flight handles from
        its admission-wait and bounded-drain loops: a DUE redelivery
        (per the retry policy's backoff schedule, clocked from
        ``sent_at``) is transmitted, and a blown submit deadline
        fails the handle so its future rejects."""
        if self._terminal or self._pending.event.is_set():
            return
        now = time.monotonic() if now is None else now
        if self._deadline is not None and now >= self._deadline:
            with self._comm._lock:
                got = set(self._pending.responses)
            missing = sorted(self._pending.expect - got)
            self._fail(TimeoutError(
                f"no response from ranks {missing} within "
                f"{self._timeout}s for '{self.msg_type}' "
                f"(async window)"))
            return
        policy = self._comm.retry_for(self.msg_type)
        if not policy.enabled():
            return
        # The next attempt is due when the cumulative backoff since
        # the first transmission has elapsed.
        done_attempts = self.msg.attempt + 1   # deliveries so far
        if done_attempts >= policy.attempts:
            return
        elapsed = time.time() - self._pending.sent_at
        due = sum(policy.attempt_wait_s(i)
                  for i in range(done_attempts))
        if elapsed >= due:
            self._redeliver_missing(done_attempts)


class CommunicationManager:
    """Owns the control-plane listener and request/response correlation."""

    def __init__(self, num_workers: int, *, host: str = "127.0.0.1",
                 port: int = 0, timeout: float | None = None,
                 allow_pickle: bool = True, auth_token: str | None = None,
                 retry: RetryPolicy | None = None,
                 session_token: str | None = None,
                 session_epoch: int = 0,
                 scheduler: Scheduler | None = None):
        self.num_workers = num_workers
        # Mesh scheduler (gateway/scheduler.py): EVERY execute request
        # routes through it — admission, queueing, fair-share.  The
        # default is an unlimited-slot FIFO with one implicit
        # tenant, so the single-kernel path dispatches immediately and
        # behaves exactly as before while sharing the gateway's code
        # path (no fork).  A gateway passes a bounded pool policy.
        self.scheduler = scheduler or Scheduler()
        self.default_timeout = timeout  # None = wait forever (training mode)
        self.auth_token = auth_token
        # Durable-session identity (resilience/session.py): when the
        # epoch is nonzero every outgoing request is stamped with it,
        # and workers whose fleet has been handed to a NEWER epoch
        # answer our frames with a stale-coordinator error instead of
        # executing them.  Zero (the default) leaves frames unstamped —
        # the pre-epoch wire format, never rejected.
        self.session_token = session_token
        self.session_epoch = int(session_epoch or 0)
        # Redelivery policy for slow/lost responses (resilience/retry):
        # explicit argument > NBD_RETRY_* env > disabled (the exact
        # pre-retry single-attempt behavior).
        self.retry = (retry if retry is not None
                      else RetryPolicy.from_env() or RetryPolicy())
        # Per-message-class budget overrides (NBD_RETRY_CLASS_*): bulk
        # push/pull/checkpoint frames get a long-haul budget on slow
        # links while control frames keep their tight one.
        self.retry_classes = RetryPolicy.classes_from_env(self.retry)
        self.retries_sent = 0  # redeliveries actually transmitted
        self.retries_by_rank: dict[int, int] = {}  # per-rank, for the
        # per-link loss estimate in link_stats()
        # Observability: the process tracer (spans around requests,
        # off until %dist_trace start), per-rank clock offsets fed from
        # response RTTs, and wire-frame accounting into the registry.
        self.tracer = obs_spans.tracer()
        self.clock = ClockEstimator()
        # Latency observatory: stage attribution for every
        # completed execute request.  On by default (NBD_LAT=0 turns
        # it off and drops the `lt` wire header entirely); its offsets
        # come from the same clock estimator the trace merge uses.
        self.lat = LatencyObservatory()
        obs_metrics.install_wire_hook()
        # Flight recorder (always on): opening it here also mints the
        # shared run directory and exports NBD_RUN_DIR, so workers
        # spawned after this constructor land their rings next to ours.
        self.flight = flightrec.init("coordinator")
        # Push-based per-rank telemetry: the last few snapshots that
        # rode heartbeat pings (runtime/worker.py piggybacks them) —
        # the postmortem's "last known device state" for a dead rank.
        self._telemetry: dict[int, deque] = {}
        # Native C++ listener when built (see messaging/native.py), the
        # pure-Python selector listener otherwise — same protocol.
        self._listener = make_listener(host=host, port=port,
                                       allow_pickle=allow_pickle,
                                       auth_token=auth_token)
        self.port = self._listener.port
        self.flight.record("coordinator_start",
                           num_workers=num_workers, port=self.port)
        self._lock = threading.Lock()
        self._pending: dict[str, _Pending] = {}
        self._connected: set[int] = set()
        self._ever_connected: set[int] = set()
        self._dead: set[int] = set()
        # Host topology (multi-host worlds): rank -> host label, plus
        # this process's own label — fed to the listener for per-link
        # fault shaping and to the partition sentry / link_stats.
        self.hosts: dict[int, str] = {}
        self.local_host: str = knobs.get_str("NBD_HOST") or "local"
        self._listener.local_host = self.local_host
        self._ready = threading.Event()
        self._last_seen: dict[int, float] = {}
        self._last_ping: dict[int, tuple[float, dict]] = {}
        self._output_callback: Callable[[int, dict], None] | None = None
        self._notify_callbacks: list[Callable[[int, Message], None]] = []
        self._listener.on_message = self._on_message
        self._listener.on_connect = self._on_connect
        self._listener.on_disconnect = self._on_disconnect
        self._listener.start()

    # ------------------------------------------------------------------
    # wiring

    def set_output_callback(self, cb: Callable[[int, dict], None]) -> None:
        """Register the streaming-output sink (reference:
        communication.py:137-144).  Called from the IO thread — keep fast."""
        self._output_callback = cb

    def add_notify_callback(self, cb: Callable[[int, Message], None]) -> None:
        """Register a sink for unsolicited non-stream messages
        (heartbeats, profiler events, timeline marks)."""
        self._notify_callbacks.append(cb)

    def set_fault_plan(self, plan) -> None:
        """Install (or clear, with ``None``) a chaos
        :class:`~nbdistributed_tpu_torch.resilience.faults.FaultPlan` on the
        coordinator→worker send path."""
        self._listener.fault_plan = plan

    def fault_plan(self):
        return getattr(self._listener, "fault_plan", None)

    def set_host_map(self, hosts: dict[int, str]) -> None:
        """Record which host each rank runs on (multi-host worlds) —
        feeds per-link fault shaping, the partition sentry, and the
        per-host diagnosis surfaces."""
        self.hosts = dict(hosts or {})
        self._listener.host_of_rank = dict(self.hosts)

    def retry_for(self, msg_type: str) -> RetryPolicy:
        """The redelivery policy for one message type: its class
        override when configured (NBD_RETRY_CLASS_*), the base policy
        otherwise."""
        return self.retry_classes.get(class_of(msg_type), self.retry)

    # ------------------------------------------------------------------
    # readiness / liveness

    def wait_for_workers(self, timeout: float = 60.0) -> None:
        """Block until all ``num_workers`` ranks have attached."""
        if not self._ready.wait(timeout):
            missing = sorted(set(range(self.num_workers)) - self._connected)
            raise TimeoutError(
                f"workers {missing} did not attach to the control plane "
                f"within {timeout:.0f}s")

    def connected_ranks(self) -> list[int]:
        with self._lock:
            return sorted(self._connected)

    def last_seen(self, rank: int) -> float | None:
        with self._lock:
            return self._last_seen.get(rank)

    def pending_snapshot(self) -> dict[str, dict]:
        """Read-only view of in-flight requests for the hang watchdog:
        ``{msg_id: {"type", "expect", "responded", "sent_at"}}``.  A
        cell where some ranks responded while others sit on an old
        collective seq is the watchdog's skew signal — this is how it
        learns which ranks a hung request is still waiting on."""
        with self._lock:
            return {mid: {"type": p.msg_type,
                          "expect": sorted(p.expect),
                          "responded": sorted(p.responses),
                          "sent_at": p.sent_at,
                          "cell_sha1": p.cell_sha1,
                          "tenant": p.tenant}
                    for mid, p in self._pending.items()}

    def last_ping(self, rank: int) -> tuple[float, dict] | None:
        """(arrival time, payload) of the rank's latest heartbeat.  The
        payload carries the worker loop's busy state ({"busy_type",
        "busy_s"} mid-request, empty when idle) — the only liveness
        signal that does NOT go through the worker's serial request
        loop, so it works exactly when a status probe would stall
        behind a long-running cell."""
        with self._lock:
            return self._last_ping.get(rank)

    def last_telemetry(self, rank: int) -> dict | None:
        """The rank's newest heartbeat-piggybacked telemetry snapshot
        (HBM, live buffers, compile activity), or None."""
        with self._lock:
            hist = self._telemetry.get(rank)
            return hist[-1] if hist else None

    def telemetry_history(self, rank: int) -> list[dict]:
        """The last few telemetry snapshots for ``rank`` (bounded) —
        what the postmortem bundles as the dead rank's final device
        state."""
        with self._lock:
            return list(self._telemetry.get(rank) or ())

    def link_stats(self) -> dict:
        """Per-rank and per-host link health, assembled from state the
        coordinator already collects: the clock estimator's min-RTT
        samples (RTT estimate per rank), heartbeat ages, and redelivery
        counts (loss proxy — every retry is a frame some link ate or
        delayed past its class budget).  Shape::

            {"ranks": {rank: {"host", "rtt_ms", "offset_ms", "samples",
                              "hb_age_s", "retries"}},
             "hosts": {host: {"ranks", "rtt_ms" (min over ranks),
                              "hb_age_s" (max), "retries" (sum)}}}
        """
        now = time.time()
        clock = self.clock.stats()
        with self._lock:
            pings = dict(self._last_ping)
            retries = dict(self.retries_by_rank)
        ranks: dict[int, dict] = {}
        for r in range(self.num_workers):
            cs = clock.get(r) or {}
            ping = pings.get(r)
            rtt = cs.get("min_rtt_s")
            ranks[r] = {
                "host": self.hosts.get(r, "local"),
                "rtt_ms": round(rtt * 1e3, 2) if rtt is not None else None,
                "offset_ms": round((cs.get("offset_s") or 0.0) * 1e3, 2),
                "samples": cs.get("samples", 0),
                "hb_age_s": (round(now - ping[0], 1)
                             if ping is not None else None),
                "retries": retries.get(r, 0),
            }
        hosts: dict[str, dict] = {}
        for r, v in ranks.items():
            h = hosts.setdefault(v["host"], {"ranks": [], "rtt_ms": None,
                                             "hb_age_s": None,
                                             "retries": 0})
            h["ranks"].append(r)
            if v["rtt_ms"] is not None and (h["rtt_ms"] is None
                                            or v["rtt_ms"] < h["rtt_ms"]):
                h["rtt_ms"] = v["rtt_ms"]
            if v["hb_age_s"] is not None and (h["hb_age_s"] is None
                                              or v["hb_age_s"]
                                              > h["hb_age_s"]):
                h["hb_age_s"] = v["hb_age_s"]
            h["retries"] += v["retries"]
        return {"ranks": ranks, "hosts": hosts}

    def mark_worker_dead(self, rank: int) -> None:
        """Called by the process monitor when a worker process exits.
        Aborts every pending request still expecting this rank."""
        with self._lock:
            newly = rank not in self._dead
            self._dead.add(rank)
            pendings = [(mid, p) for mid, p in self._pending.items()
                        if rank in p.expect and rank not in p.responses]
        if newly:
            self.flight.record("worker_dead", rank=rank,
                               pending=[mid for mid, _ in pendings])
        for mid, p in pendings:
            failure = WorkerDied(f"worker {rank} died while a request "
                                 "was pending")
            # Which request died with it — the postmortem matches this
            # id against the dead rank's recovered dispatch events.
            failure.msg_id = mid
            p.failure = failure
            p.event.set()
            cb = p.on_done
            if cb is not None:
                # Async submission: resolve its future NOW
                # — a death must abort every in-flight windowed cell,
                # not only the one a thread happens to be waiting on.
                try:
                    cb()
                except Exception:
                    pass

    def dead_ranks(self) -> set[int]:
        """Snapshot of ranks currently marked dead (death callback or
        heartbeat verdict); a transport reconnect revives a rank out
        of the set.  Callers that must reach "everyone alive" send to
        ``range(world) - dead_ranks()`` — send_to_ranks raises on any
        dead target BEFORE transmitting to the rest."""
        with self._lock:
            return set(self._dead)

    def reset_world(self, num_workers: int, session_epoch: int) -> None:
        """Re-seed the world for an elastic resize: the old
        fleet is gone (drained, told to shut down, reaped), a new one
        of ``num_workers`` ranks is about to dial this same listener
        under ``session_epoch``.  Clears the connection/death/heartbeat
        bookkeeping and re-arms the ready barrier so
        ``wait_for_workers`` means the NEW fleet.  Any request still
        pending (the drain barrier should have left none) is failed
        loudly rather than left to hit its timeout against ranks that
        no longer exist.

        Frames from the old epoch that are still in flight need no
        handling here: every reply carries the ``ep`` header and
        ``_on_message`` fences ``epoch < session_epoch`` with an
        explicit rejected-verdict counter."""
        with self._lock:
            self.num_workers = int(num_workers)
            self.session_epoch = int(session_epoch)
            self._connected.clear()
            self._ever_connected.clear()
            self._dead.clear()
            self._ready.clear()
            self._last_seen.clear()
            self._last_ping.clear()
            self._telemetry.clear()
            stale = list(self._pending.items())
            self._pending.clear()
        self.flight.record("world_reset", num_workers=num_workers,
                           epoch=session_epoch,
                           aborted=[mid for mid, _ in stale])
        for mid, p in stale:
            failure = WorkerDied(
                f"request {mid} aborted: the fleet was resized "
                f"(epoch {session_epoch}) while it was pending")
            failure.msg_id = mid
            p.failure = failure
            p.event.set()
            cb = p.on_done
            if cb is not None:
                try:
                    cb()
                except Exception:
                    pass

    # ------------------------------------------------------------------
    # request/response

    def send_to_all(self, msg_type: str, data: Any = None, *,
                    bufs: dict | None = None,
                    timeout: float | None = ...,
                    vet_s: float | None = None) -> dict[int, Message]:
        return self.send_to_ranks(list(range(self.num_workers)), msg_type,
                                  data, bufs=bufs, timeout=timeout,
                                  vet_s=vet_s)

    def send_to_rank(self, rank: int, msg_type: str, data: Any = None, *,
                     bufs: dict | None = None,
                     timeout: float | None = ...) -> Message:
        return self.send_to_ranks([rank], msg_type, data, bufs=bufs,
                                  timeout=timeout)[rank]

    def send_to_ranks(self, ranks: list[int], msg_type: str,
                      data: Any = None, *, bufs: dict | None = None,
                      timeout: float | None = ...,
                      tenant: str | None = None, priority: int = 0,
                      msg_id: str | None = None,
                      on_verdict=None,
                      collective: str = "unknown",
                      vet_s: float | None = None
                      ) -> dict[int, Message]:
        """Send one request to ``ranks`` and collect their responses.

        ``timeout=...`` (unset) uses the manager default; ``None`` waits
        forever — but still aborts if an expected worker dies.

        With a retry policy enabled (``retry=`` / ``NBD_RETRY_*``), a
        request whose responses are slower than the per-attempt timeout
        is REDELIVERED to the still-missing ranks under the same msg_id
        with exponential backoff + jitter — the worker's replay cache
        makes redelivery idempotent, so a lost request or lost reply
        costs one backoff interval instead of the whole deadline.  The
        caller's ``timeout`` stays the total budget; the final attempt
        waits out whatever remains of it (forever when ``None``).

        ``execute`` requests route through :attr:`scheduler` first:
        the default single-tenant policy always dispatches
        immediately, a gateway's bounded policy may queue this call
        (it blocks until granted, within ``timeout``), shed it under
        overload (:class:`CellShed`), or refuse it at the tenant's
        in-flight cap (:class:`CellRejected`).  ``on_verdict(ticket)``
        fires right after admission — the gateway's hook for sending
        the explicit ``{"status": "queued", "position": n}`` reply
        instead of silently blocking.  ``tenant`` tags the wire frame
        (worker-side namespace routing + blame attribution) and is the
        scheduler's accounting key; ``msg_id`` pins the outgoing id so
        a gateway can keep tenant-side and worker-side correlation ids
        identical end to end.  ``collective`` is the cell's effects-
        admission class (``analysis.effects.collective_class``: free /
        bearing / unknown) — consulted only when the scheduler's
        effects gate is armed.  ``vet_s`` is how long the
        caller spent vetting/classifying the cell before this call —
        the latency observatory's "vet" stage (the submitter is the
        only layer that knows it).

        This is literally ``submit(...).wait()`` — the async pipeline
        calls :meth:`submit` directly and waits later.
        """
        return self.submit(ranks, msg_type, data, bufs=bufs,
                           timeout=timeout, tenant=tenant,
                           priority=priority, msg_id=msg_id,
                           on_verdict=on_verdict, collective=collective,
                           vet_s=vet_s).wait()

    def submit(self, ranks: list[int], msg_type: str,
               data: Any = None, *, bufs: dict | None = None,
               timeout: float | None = ...,
               tenant: str | None = None, priority: int = 0,
               msg_id: str | None = None,
               on_verdict=None,
               collective: str = "unknown",
               vet_s: float | None = None,
               xfer: dict | None = None,
               on_done=None) -> PendingHandle:
        """Non-blocking dispatch: admit through the
        scheduler, transmit the request, and return a
        :class:`PendingHandle` without waiting for replies — the async
        executor streams cell N+1 while cell N runs through exactly
        this path.  Admission failures (``CellRejected``/``CellShed``/
        a dead target rank / a queued-admission timeout) still raise
        HERE, synchronously: an unadmitted cell has no handle.
        ``on_done(handle)`` fires from the IO thread the moment the
        expectation set completes (or a death aborts it) — the async
        future-resolution hook; without it, completion bookkeeping
        runs on whichever thread calls :meth:`PendingHandle.wait`,
        preserving the pre-split synchronous behavior exactly."""
        if timeout is ...:
            timeout = self.default_timeout
        if not ranks:
            # An empty expectation would otherwise never complete.
            return PendingHandle.resolved({})
        msg = Message(msg_type=msg_type, data=data, bufs=bufs or {})
        if msg_id is not None:
            msg.msg_id = msg_id
        if xfer is not None:
            # Bulk-transfer chunk header (messaging/xfer.py): rides
            # the frame header so a retry redelivers the SAME chunk
            # identity (xid/seq/crc) under the same msg_id.
            msg.xfer = xfer
        if self.session_epoch:
            msg.epoch = self.session_epoch
        if tenant is not None:
            msg.tenant = tenant
        if msg_type == "execute" and self.lat.enabled:
            # Ask the workers to stamp this request (dequeue / handler
            # entry+exit / compile seconds / reply build) and open the
            # coordinator-side stage record.  One flag check when off;
            # no wire header is emitted unless enabled.
            msg.latency = 1
            self.lat.begin(msg.msg_id, msg_type, tenant, vet_s=vet_s)
        # The total budget starts NOW: time spent queued behind the
        # mesh is part of the caller's wait, not free.
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        ticket = None
        try:
            if msg_type == "execute":
                ticket = self.scheduler.submit(tenant or "local",
                                               msg.msg_id, priority,
                                               collective=collective)
                if on_verdict is not None:
                    try:
                        on_verdict(ticket)
                    except Exception:
                        pass
                v = ticket.verdict
                if v["status"] == "rejected":
                    raise CellRejected(v.get("reason", "rejected"),
                                       tenant or "local")
                if v["status"] == "shed":
                    raise CellShed(tenant or "local", msg.msg_id)
                if v["status"] == "queued":
                    wait_s = (None if deadline is None
                              else max(0.0,
                                       deadline - time.monotonic()))
                    if not ticket.event.wait(wait_s):
                        self.scheduler.cancel(msg.msg_id)
                        raise TimeoutError(
                            f"cell spent {timeout}s queued behind the "
                            f"mesh without dispatch (tenant "
                            f"{tenant or 'local'}); withdrawn")
                    if ticket.state == SHED:
                        raise CellShed(tenant or "local", msg.msg_id)
            if msg.latency is not None:
                # The mesh slot is granted (immediately on an idle
                # mesh, after the queued wait otherwise) — closes the
                # queue stage.
                self.lat.note_grant(msg.msg_id)
            return self._transmit(ranks, msg, msg_type, timeout,
                                  deadline, tenant, ticket, on_done)
        except BaseException:
            # Never-transmitted request: free the mesh slot and the
            # stage record here — there is no handle to finish them.
            # (A transmitted request's cleanup runs in _finish when
            # its handle settles — success OR failure frees the slot;
            # a dead worker must not wedge the pool.)
            if ticket is not None and ticket.state == ACTIVE:
                self.scheduler.complete(msg.msg_id)
            if msg.latency is not None:
                self.lat.drop(msg.msg_id)
            raise

    def _transmit(self, ranks: list[int], msg: Message, msg_type: str,
                  timeout: float | None, deadline: float | None,
                  tenant: str | None, ticket,
                  on_done) -> PendingHandle:
        tr = self.tracer
        span_attrs = {"ranks": list(ranks)}
        if tenant is not None:
            span_attrs["tenant"] = tenant
        span = (tr.begin(f"send/{msg_type}", kind="coordinator",
                         attrs=span_attrs)
                if tr.enabled else None)
        if span is not None:
            # The worker's handler span adopts these ids as its parent,
            # stitching the cross-process timeline together.
            msg.trace = tr.context_for(span)
        pending = _Pending(set(ranks), msg_type, tenant)
        data = msg.data
        if msg_type == "execute" and isinstance(data, dict) \
                and isinstance(data.get("code"), str):
            from ..runtime.collective_guard import cell_hash
            pending.cell_sha1 = cell_hash(data["code"])
        with self._lock:
            already_dead = pending.expect & self._dead
            self._pending[msg.msg_id] = pending
        if already_dead:
            with self._lock:
                del self._pending[msg.msg_id]
            if span is not None:
                tr.end(span)
            raise WorkerDied(f"workers {sorted(already_dead)} are dead")
        handle = PendingHandle(self, msg, msg_type, ranks, pending,
                               ticket, timeout, deadline, tenant, span)
        try:
            pending.sent_at = time.time()
            self.flight.record("send", msg_id=msg.msg_id,
                               type=msg_type, ranks=list(ranks),
                               **({"tenant": tenant}
                                  if tenant is not None else {}))
            self._listener.send_to_ranks(list(ranks), msg)
        except BaseException:
            with self._lock:
                self._pending.pop(msg.msg_id, None)
            if span is not None:
                tr.end(span)
            raise
        if on_done is not None:
            handle.add_done_callback(on_done)
            # Event-driven settle from the IO thread; attached AFTER
            # the transmit so a synchronously-failing send never
            # leaves a dangling hook.  Late attach is race-safe: an
            # event that fired in the gap settles inline here.
            pending.on_done = handle._event_fired
            if pending.event.is_set():
                handle._event_fired()
        return handle

    def _finish(self, handle: PendingHandle, error) -> None:
        """One-time completion bookkeeping for a settled handle —
        stage-record close, span end, pending-table pop, mesh-slot
        release.  Runs exactly once per handle (the settle paths are
        terminal), on whichever thread settled it: the caller thread
        for synchronous waits (pre-split behavior, byte for byte),
        the IO thread for event-driven async completion."""
        msg = handle.msg
        tr = self.tracer
        span = handle._span
        if error is None and msg.latency is not None:
            # Close the stage record: per-rank worker stamps from the
            # reply headers, corrected by the clock estimator,
            # delivery stamped NOW (the caller receives the result
            # when the wait returns / the future resolves).  Mirrored
            # as stage/* child spans of the send span while a trace
            # is active.
            self.lat.complete(
                msg.msg_id, handle._result or {}, self.clock.offset,
                tracer=tr,
                parent=(tr.context_for(span)
                        if span is not None else None))
        if span is not None:
            span.attrs["deliveries"] = msg.attempt + 1
            tr.end(span)
        with self._lock:
            self._pending.pop(msg.msg_id, None)
        if handle._ticket is not None \
                and handle._ticket.state == ACTIVE:
            # Success OR failure frees the mesh slot and promotes
            # queued work — a dead worker must not wedge the pool.
            self.scheduler.complete(msg.msg_id)
        if msg.latency is not None:
            # No-op after a completed record; forgets the stage
            # record of a timed-out / aborted cell (only COMPLETED
            # cells feed the histograms).
            self.lat.drop(msg.msg_id)

    def post(self, ranks: list[int], msg_type: str, data: Any = None, *,
             bufs: dict | None = None) -> str:
        """Fire-and-forget send (no response expected) — used for
        shutdown-style messages where the reference tolerates silence
        (reference: worker.py:205-206 sends no shutdown response).
        Returns the message id, so a caller that later needs to
        correlate (e.g. the reattach tests matching a parked result to
        the request the coordinator died holding) can."""
        msg = Message(msg_type=msg_type, data=data, bufs=bufs or {})
        if self.session_epoch:
            msg.epoch = self.session_epoch
        try:
            self._listener.send_to_ranks(list(ranks), msg)
        except TransportError:
            pass
        return msg.msg_id

    # ------------------------------------------------------------------
    # IO-thread callbacks

    def _on_connect(self, rank: int) -> None:
        with self._lock:
            reconnect = rank in self._ever_connected
            self._connected.add(rank)
            self._ever_connected.add(rank)
            self._dead.discard(rank)
            self._last_seen[rank] = time.time()
            all_in = len(self._connected) >= self.num_workers
        # Transport-level connect events land in the flight ring on
        # BOTH sides so a postmortem can tell "link flapped" (connect /
        # eof / reconnect trail) from "peer died" (eof, then nothing).
        if reconnect:
            self.flight.record("transport_reconnect", rank=rank,
                               host=self.hosts.get(rank))
            obs_metrics.registry().counter(
                "nbd_link_reconnects_total",
                "worker control-plane reconnections (link flaps, "
                "partition heals, orphan reattaches)").inc()
        else:
            self.flight.record("transport_connect", rank=rank,
                               host=self.hosts.get(rank))
        if all_in:
            self._ready.set()

    def _on_disconnect(self, rank: int) -> None:
        with self._lock:
            self._connected.discard(rank)
        self.flight.record("transport_eof", rank=rank,
                           host=self.hosts.get(rank))
        self.mark_worker_dead(rank)

    def _on_message(self, rank: int, msg: Message) -> None:
        with self._lock:
            self._last_seen[rank] = time.time()
        if msg.msg_type == "stream_output":
            # Routed straight to the display callback, never queued
            # (reference: communication.py:174-184).
            cb = self._output_callback
            if cb is not None:
                try:
                    cb(rank, msg.data)
                except Exception:
                    pass
            return
        if msg.msg_type == "response":
            # Epoch fence, worker→coordinator direction:
            # workers stamp replies with their session epoch, so a
            # result computed for a PREVIOUS tenancy — a stale-side
            # rank delivering across a healed partition after this
            # coordinator already healed replacements — is rejected
            # here, never double-applied.  Unstamped replies (epoch
            # None: pre-partition worlds) are never rejected.
            if (msg.epoch is not None and self.session_epoch
                    and msg.epoch < self.session_epoch):
                obs_metrics.registry().counter(
                    "nbd_epoch_rejected_results",
                    "stale-epoch worker replies rejected by the "
                    "coordinator").inc()
                self.flight.record("epoch_rejected_result", rank=rank,
                                   msg_id=msg.msg_id,
                                   frame_epoch=msg.epoch,
                                   epoch=self.session_epoch)
                return
            # Arrival stamp for the latency observatory's reply stage
            # (and the clock sample below) — stamped HERE, on the IO
            # thread, so a slow completion wait can't inflate it.
            msg.recv_ts = time.time()
            with self._lock:
                pending = self._pending.get(msg.msg_id)
                if pending is None:
                    return  # late response to a timed-out request
                pending.responses[rank] = msg
                complete = set(pending.responses) >= pending.expect
            if pending.sent_at:
                # NTP-style clock sample: (t_send, worker reply stamp,
                # t_recv) — the estimator's min-RTT filter keeps only
                # the cleanest of these.
                self.clock.add(rank, pending.sent_at, msg.timestamp,
                               msg.recv_ts)
            if complete:
                pending.event.set()
                cb = pending.on_done
                if cb is not None:
                    # Async submission: settle the handle
                    # from the IO thread so a pipelined cell's future
                    # resolves the moment its last reply lands.
                    try:
                        cb()
                    except Exception:
                        pass
            return
        if msg.msg_type == "ping":
            data = msg.data or {}
            with self._lock:
                self._last_ping[rank] = (time.time(), data)
                tel = data.get("tel")
                if tel is not None:
                    self._telemetry.setdefault(
                        rank, deque(maxlen=8)).append(tel)
            return
        for cb in self._notify_callbacks:
            try:
                cb(rank, msg)
            except Exception:
                pass

    # ------------------------------------------------------------------

    def shutdown(self) -> None:
        """Fail every request still pending, then tear down the listener
        (reference: communication.py:372-389): the pending requests'
        ranks are about to be torn down with this manager, so no reply
        will come.  (The JAX package's shutdown leaves them to their
        timeout: a cell the hang watchdog heals under stays blocked in
        the notebook for its ``-t``, forever without one.)"""
        self.fail_pending()
        self._listener.close()

    def fail_pending(self) -> None:
        """Fail every pending request with the shutdown's verdict
        ("aborted: the coordinator shut down while it was pending").
        A teardown calls it BEFORE it tells the ranks to leave: a
        rank's exit, or the listener's close, would otherwise fail the
        request first as a death ("worker N died while a request was
        pending"), depending on timing."""
        with self._lock:
            stale = list(self._pending.items())
            self._pending.clear()
        for mid, p in stale:
            failure = WorkerDied(f"request {mid} aborted: the coordinator "
                                 "shut down while it was pending")
            failure.msg_id = mid
            p.failure = failure
            p.event.set()
            cb = p.on_done
            if cb is not None:
                try:
                    cb()
                except Exception:
                    pass
