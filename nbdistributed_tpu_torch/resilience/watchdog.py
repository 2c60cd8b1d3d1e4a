"""Collective hang watchdog + stuck-cell doctor (a copy of
``nbdistributed_tpu/resilience/watchdog.py``; the detector, the ladder
and the report are the JAX package's, line for line).

The failure model so far has a blind spot between "alive" and "dead":
heartbeats prove the *process* lives, ``WorkerDied`` fires only on
death, and the collective-hazard guard catches subset cells *before*
launch — but a rank wedged *inside* an eager collective, a
data-dependent infinite loop, or a straggler far behind its peers
hangs the process group silently until a human notices.

Three cooperating pieces, the NCCL-flight-recorder analog for this
stack:

- **Progress** (worker side): ``runtime/collective_guard.py`` keeps a
  monotonic per-process collective sequence — ``(seq, op,
  entered-at, in-flight)`` — and the heartbeat thread piggybacks it
  (plus the in-flight request id and optional per-cell deadline) on
  every ping, so the coordinator sees each rank's position in the
  collective stream *mid-cell*, through the one channel that does not
  go through the worker's serial request loop.

- **Detection** (this module): :class:`SkewDetector` is a pure state
  machine over those positions.  Three verdict kinds, all distinct
  from "slow":

  * ``skew`` — cross-rank divergence on the same cell: peers entered
    collective #N (or already finished the cell) while a rank sits
    below #N with no progress for ``skew_s``.  The signature case —
    "ranks 0–2 entered ``all_reduce`` #7, rank 3 never did".  A rank
    still *inside* a collective its peers finished the cell without
    (``if rank != 3: dist.all_reduce(t)``) is skew too.
  * ``stall`` — a rank busy beyond ``stall_s`` with zero collective
    progress (the pure-Python infinite loop; also a collective ALL
    ranks entered that never completes).
  * ``deadline`` — the cell carried its own budget
    (``%%distributed --deadline S``) and blew it.

  A uniformly-slow cell — every rank advancing through the same
  sequence together, or every rank inside the same collective under
  ``stall_s`` — produces **no** verdict: progress resets the timers,
  and equal positions are not skew.

- **Escalation + diagnosis**: :class:`HangWatchdog` runs the detector
  on a coordinator thread and walks a configurable ladder per hung
  cell — ``warn`` (print + flight + metric) → ``dump`` (SIGUSR1 →
  per-rank faulthandler stack files under ``NBD_RUN_DIR``) →
  ``interrupt`` (SIGINT via the existing InterruptGate discipline:
  the cell aborts with a KeyboardInterrupt error reply, the worker
  survives) → ``heal`` (the supervisor's full respawn+restore).
  Every step is flight-recorded and counted.  :func:`hang_report`
  assembles the ``%dist_doctor`` bundle: per-rank collective
  positions, the skew table, busy ages, freshly-dumped stacks, and
  each ring's last flight events — naming the lagging rank(s) and
  the divergence point.

Policy comes from ``NBD_HANG_*`` env knobs (overridable by
``%dist_watchdog``)::

    NBD_HANG=0              master off switch (workers skip the
                            heartbeat piggyback; one flag check)
    NBD_HANG_POLL_S=1.0     watchdog poll cadence
    NBD_HANG_SKEW_S=20      lag persistence before a skew verdict
    NBD_HANG_STALL_S=120    busy-with-no-progress before a stall
    NBD_HANG_ESCALATE=warn,dump      the ladder (also: interrupt,heal)
    NBD_HANG_GRACE_S=15     pause between ladder steps

On the port the progress stream also counts the seeded ``dist``'s
world collectives (``runtime/collective_guard.py``: the reference
nbdistributed's idiom is ``dist.all_reduce``), and a collective on an
NCCL group stays "in" until its work completes on the card, not when
the enqueue returns: so a rank blocked at the next host sync behind a
collective its peer never joined reads as inside it, as a JAX rank
blocked in the collective itself does.

What the ladder can break on NCCL: ``interrupt`` is a SIGINT, which
Python handles only when the main thread returns to bytecode.  A cell
looping in Python (launching kernels, even) aborts and its worker
survives; a rank blocked in ``cudaStreamSynchronize`` behind an NCCL
kernel whose peer never comes does not return, and even an interrupt
that lands leaves the collective enqueued on the communicator.  Such a
hang is cleared only by ``heal``.  The process group's own timeout
(the worker's ``INIT_TIMEOUT_S``, 120 s) bounds every NCCL collective
too: when it fires, ``ProcessGroupNCCL`` aborts the communicator and
ends the rank, which the supervisor then sees as a death.  Keep the
stall window and the ladder's grace well inside it where ``heal``
should win the race.

Stdlib-only (no torch import), like the rest of this package.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass

from ..observability import flightrec
from ..observability import metrics as obs_metrics
from ..utils import knobs
from .partition import PartitionSentry

LADDER_STEPS = ("warn", "dump", "interrupt", "heal")


def _preflight_note(cell_sha1: str | None) -> dict | None:
    """The pre-dispatch lint finding recorded for this cell's source
    hash, if the analyzer flagged it (analysis/preflight) — a hang
    verdict landing on a flagged cell cites it, closing the loop
    between the static warning and the runtime failure."""
    if not cell_sha1:
        return None
    try:
        from ..analysis import preflight
        return preflight.lookup(cell_sha1)
    except Exception:
        return None


def parse_ladder(raw: str) -> tuple[str, ...]:
    """Parse a comma-separated escalation ladder; unknown step names
    are an error (a typo'd ladder must not silently never escalate —
    the FaultPlan unknown-key philosophy)."""
    steps = tuple(s.strip() for s in raw.split(",") if s.strip())
    unknown = [s for s in steps if s not in LADDER_STEPS]
    if unknown:
        raise ValueError(f"unknown escalation step(s) {unknown} "
                         f"(known: {list(LADDER_STEPS)})")
    return steps


@dataclass(frozen=True)
class HangPolicy:
    enabled: bool = True
    poll_s: float = 1.0
    skew_s: float = 20.0
    stall_s: float = 120.0
    grace_s: float = 15.0
    escalate: tuple = ("warn", "dump")
    # Pings older than this carry FROZEN busy state, not live state:
    # judging them would extrapolate busy_s without bound and flag a
    # silent-but-finished rank as stalled.  A silent rank is the
    # supervisor's degraded/dead domain, never a hang verdict.  (A
    # genuinely wedged rank keeps heartbeating — the ping thread is
    # separate — so the hang path is unaffected.)  4× the worker's
    # 2 s heartbeat cadence.
    hb_stale_s: float = 8.0

    def __post_init__(self):
        unknown = [s for s in self.escalate if s not in LADDER_STEPS]
        if unknown:
            raise ValueError(f"unknown escalation step(s) {unknown} "
                             f"(known: {list(LADDER_STEPS)})")

    @classmethod
    def from_env(cls, env=None) -> "HangPolicy":
        kw: dict = {
            "enabled": knobs.get_bool("NBD_HANG", True, env=env),
            "poll_s": knobs.get_float("NBD_HANG_POLL_S", cls.poll_s,
                                      env=env),
            "skew_s": knobs.get_float("NBD_HANG_SKEW_S", cls.skew_s,
                                      env=env),
            "stall_s": knobs.get_float("NBD_HANG_STALL_S", cls.stall_s,
                                       env=env),
            "grace_s": knobs.get_float("NBD_HANG_GRACE_S", cls.grace_s,
                                       env=env),
        }
        raw = knobs.get_str("NBD_HANG_ESCALATE", env=env)
        if raw:
            kw["escalate"] = parse_ladder(raw)
        return cls(**kw)

    @classmethod
    def from_env_lenient(cls, env=None) -> "HangPolicy":
        """:meth:`from_env`, but a malformed ``NBD_HANG_ESCALATE``
        degrades to the default ladder (numeric knobs still honored)
        instead of raising — for surfaces that must keep working when
        the env is the very problem being diagnosed (``%dist_status``,
        the doctor, ``%dist_watchdog on`` recovering from the typo).
        Auto-arming stays strict so the typo is reported once, at
        ``%dist_init``."""
        try:
            return cls.from_env(env)
        except ValueError:
            env2 = dict(os.environ if env is None else env)
            env2.pop("NBD_HANG_ESCALATE", None)
            return cls.from_env(env2)

    def describe(self) -> str:
        return (f"skew {self.skew_s:.0f}s · stall {self.stall_s:.0f}s "
                f"· poll {self.poll_s:.1f}s · ladder "
                f"{'→'.join(self.escalate) or '(none)'} "
                f"(grace {self.grace_s:.0f}s)")


# ----------------------------------------------------------------------
# detection


class SkewDetector:
    """Pure hang-detection state machine over per-rank views.

    ``observe(now, ranks, pending)`` consumes one snapshot and returns
    the verdicts active *right now* (empty list = healthy).  A rank
    view is the heartbeat piggyback, coordinator-adjusted::

        {"busy_id":  in-flight request id (None when idle),
         "busy_type": message type, "busy_s": seconds busy,
         "deadline": per-cell budget seconds or None,
         "seq": collective sequence number (0 = none yet),
         "op": last collective op entered, "in": still inside it,
         "cops": collectives this cell has made so far,
         "rep": step index of an in-flight --repeat loop (None
                otherwise; advancing steps count as progress),
         "hb_age": seconds since the last ping}

    ``pending`` is ``CommunicationManager.pending_snapshot()`` —
    which ranks already responded to the cell is the straggler
    evidence.  State is only per-rank progress timestamps, so the
    detector is trivially unit-testable with synthetic sequences and
    a fake clock.
    """

    def __init__(self, policy: HangPolicy | None = None):
        self.policy = policy or HangPolicy()
        # rank -> ((busy_id, seq, in_flight), since): the "no progress"
        # clock.  Any change — a new collective entered, a collective
        # completed, a different cell, going idle — resets it.
        self._prog: dict[int, tuple] = {}
        # (cell, rank) -> since: how long the rank has LOOKED lagging
        # (behind busy peers / wedged while peers responded).  A skew
        # verdict requires this divergence itself to persist for
        # skew_s, not just the rank's no-progress clock: heartbeats
        # propagate positions with up to a ping-interval of lag, so a
        # healthy lockstep cell with long inter-collective gaps shows
        # a one-poll phantom divergence while the slower ping is in
        # flight — phantoms clear on the next ping, real lag does not.
        self._lag: dict[tuple, float] = {}

    def reset(self) -> None:
        self._prog.clear()
        self._lag.clear()

    # ------------------------------------------------------------------

    def observe(self, now: float, ranks: dict, pending: dict | None = None
                ) -> list[dict]:
        pol = self.policy
        pending = pending or {}
        for r, v in ranks.items():
            # The "no progress" key: any change — a new collective, a
            # collective completed, a different cell, going idle, or a
            # --repeat loop advancing a step — resets the
            # stall clock.
            key = (v.get("busy_id"), v.get("seq"), v.get("in"),
                   v.get("rep"))
            prev = self._prog.get(r)
            if prev is None or prev[0] != key:
                self._prog[r] = (key, now)
        verdicts: list[dict] = []
        flagged: set = set()

        # Group busy ranks by the cell they are executing.  A busy rank
        # without a busy_id (pre-hang-protocol worker) gets a per-rank
        # pseudo-cell: no skew grouping, but stall/deadline still work.
        cells: dict = {}
        for r, v in ranks.items():
            if v.get("busy_s") is None:
                continue
            mid = v.get("busy_id") or f"?cell-rank{r}"
            cells.setdefault(mid, []).append(r)
        # Divergence clocks for finished cells are dead state.
        for key in [k for k in self._lag if k[0] not in cells]:
            del self._lag[key]

        # --- skew: divergence inside one cell -------------------------
        for mid, members in sorted(cells.items()):
            pend = pending.get(mid) or {}
            responded = sorted(pend.get("responded") or ())
            seqs = {r: int(ranks[r].get("seq") or 0) for r in members}
            # Compare CELL-LOCAL positions (collectives entered this
            # cell), not the process-lifetime sequence: lifetime seqs
            # diverge permanently and harmlessly — a hazard-raising
            # subset collective advances only the caller, a broken
            # hang leaves the laggard one behind forever — and
            # comparing them would flag every later slow-but-healthy
            # cell as skewed.  Cells are SPMD (same code on every
            # rank), so equal cell positions = in step.
            pos = {r: int(ranks[r].get("cops") or 0) for r in members}
            maxpos = max(pos.values())
            lagging, waited = [], 0.0
            for r in sorted(members):
                behind = pos[r] < maxpos
                # Straggler: peers FINISHED the cell while this rank is
                # still INSIDE a collective — wedged where nobody will
                # ever join it.  ``in`` is required: a rank merely
                # doing long rank-local work after its collectives
                # (peers responded, cops == maxpos, not inside) is
                # healthy asymmetry, not skew — if it is genuinely
                # stuck, the stall detector owns it.
                straggler = bool(responded) and bool(ranks[r].get("in"))
                key = (mid, r)
                if not (behind or straggler):
                    self._lag.pop(key, None)
                    continue
                lag_since = self._lag.setdefault(key, now)
                stale_s = now - self._prog[r][1]
                # BOTH clocks must blow the window: the rank made no
                # progress for skew_s AND has looked lagging that long
                # (see _lag above for why divergence-age matters).
                if stale_s < pol.skew_s or now - lag_since < pol.skew_s:
                    continue
                lagging.append(r)
                waited = max(waited, stale_s)
            if not lagging:
                continue
            flagged.add(mid)
            if any(pos[r] < maxpos for r in lagging):
                ahead_members = [r for r in members if pos[r] == maxpos]
                div_seq = max(seqs[r] for r in ahead_members)
                div_op = ranks[ahead_members[0]].get("op")
                ahead = sorted(set(responded) | set(ahead_members))
                detail = (f"ranks {ahead} entered {div_op or '?'} "
                          f"#{div_seq} but rank(s) "
                          f"{sorted(lagging)} never did "
                          f"(stuck at #{min(seqs[r] for r in lagging)}"
                          f" for {waited:.1f}s)")
            else:
                l0 = lagging[0]
                div_seq = seqs[l0]
                div_op = ranks[l0].get("op")
                ahead = responded
                where = (f"stuck inside {div_op or '?'} #{div_seq}"
                         if ranks[l0].get("in") else
                         f"no collective progress since "
                         f"{div_op or '?'} #{div_seq}")
                detail = (f"ranks {ahead} finished the cell but "
                          f"rank(s) {sorted(lagging)} are {where} "
                          f"({waited:.1f}s)")
            verdicts.append({"kind": "skew", "cell": mid,
                             "ranks": sorted(lagging), "peers": ahead,
                             "seq": div_seq, "op": div_op,
                             "waited_s": round(waited, 1),
                             "detail": detail})

        # --- stall: busy beyond the window with zero progress ---------
        stall_cells: dict = {}
        for r, v in ranks.items():
            if v.get("busy_s") is None:
                continue
            mid = v.get("busy_id") or f"?cell-rank{r}"
            if mid in flagged:
                continue
            stale_s = now - self._prog[r][1]
            if v["busy_s"] > pol.stall_s and stale_s > pol.stall_s:
                stall_cells.setdefault(mid, []).append(r)
        for mid, rs in sorted(stall_cells.items()):
            flagged.add(mid)
            v0 = ranks[rs[0]]
            busy = max(ranks[r].get("busy_s") or 0 for r in rs)
            col = (f" (last collective {v0.get('op')} "
                   f"#{v0.get('seq')})" if v0.get("seq") else
                   " (no collectives this cell)")
            verdicts.append({
                "kind": "stall", "cell": mid, "ranks": sorted(rs),
                "peers": sorted(pending.get(mid, {})
                                .get("responded") or ()),
                "seq": v0.get("seq"), "op": v0.get("op"),
                "waited_s": round(busy, 1),
                "detail": (f"rank(s) {sorted(rs)} busy "
                           f"{busy:.1f}s with no collective "
                           f"progress{col} — beyond the "
                           f"{pol.stall_s:.0f}s stall window")})

        # --- deadline: the cell blew its own budget -------------------
        dl_cells: dict = {}
        for r, v in ranks.items():
            dl = v.get("deadline")
            if not dl or v.get("busy_s") is None:
                continue
            mid = v.get("busy_id") or f"?cell-rank{r}"
            if mid in flagged:
                continue
            if v["busy_s"] > dl:
                dl_cells.setdefault(mid, []).append(r)
        for mid, rs in sorted(dl_cells.items()):
            busy = max(ranks[r].get("busy_s") or 0 for r in rs)
            dl = max(ranks[r].get("deadline") or 0 for r in rs)
            verdicts.append({
                "kind": "deadline", "cell": mid, "ranks": sorted(rs),
                "peers": sorted(pending.get(mid, {})
                                .get("responded") or ()),
                "seq": ranks[rs[0]].get("seq"),
                "op": ranks[rs[0]].get("op"),
                "waited_s": round(busy, 1),
                "detail": (f"rank(s) {sorted(rs)} busy {busy:.1f}s — "
                           f"past the cell's --deadline "
                           f"{dl:.0f}s budget")})
        return verdicts


# ----------------------------------------------------------------------
# the watchdog thread


class HangWatchdog:
    """Coordinator-side hang watchdog: polls heartbeat piggybacks,
    runs the :class:`SkewDetector`, and walks the escalation ladder
    per hung cell.  Lifecycle mirrors the Supervisor: ``attach(comm,
    pm)`` starts (or re-binds) the thread, ``stop()`` ends it; the
    ``heal`` callable — optional, wired by the magics to the
    supervisor/%dist_heal machinery — may return a fresh ``(comm,
    pm)`` pair to re-bind to."""

    def __init__(self, policy: HangPolicy | None = None, *,
                 heal=None, clock=time.time):
        self.policy = policy or HangPolicy()
        self._heal_fn = heal
        self._clock = clock
        self.detector = SkewDetector(self.policy)
        self.events: deque[dict] = deque(maxlen=256)
        # Monotonic totals (the deque is bounded — display only).
        self.verdicts_total = 0
        self.cells_flagged = 0
        self.cells_resolved = 0
        self.escalations: dict[str, int] = {}
        self.last_verdicts: list[dict] = []
        self._hangs: dict = {}  # cell -> {"step","next_ts","first_ts","verdict"}
        self._sentry: PartitionSentry | None = None
        self._comm = None
        self._pm = None
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------
    # lifecycle

    def attach(self, comm, pm=None) -> None:
        hosts = dict(getattr(pm, "hosts", None) or {})
        with self._lock:
            self._comm, self._pm = comm, pm
            self._hangs.clear()
            self.detector.reset()
            self.last_verdicts = []
            # Host-level failure domains: whole-host
            # heartbeat loss is a suspected partition — those ranks'
            # silence is the supervisor's problem (and their apparent
            # lag frozen data), never grounds for a hang verdict.
            self._sentry = PartitionSentry(
                hosts, local_host=getattr(comm, "local_host", "local"),
                source="watchdog", clock=self._clock)
            if not self._sentry.active:
                self._sentry = None
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop,
                                            name="nbd-hang-watchdog",
                                            daemon=True)
            self._thread.start()

    def set_policy(self, policy: HangPolicy) -> None:
        """Reconfigure IN PLACE: active-hang ladder progress, counters,
        and event history survive a policy change (stopping and
        replacing the watchdog mid-hang would re-run ladder steps
        already taken).  The loop reads ``policy.poll_s`` each
        iteration, so the new cadence applies from the next poll."""
        with self._lock:
            self.policy = policy
            self.detector.policy = policy

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5)

    def on_own_thread(self) -> bool:
        return threading.current_thread() is self._thread

    def _loop(self) -> None:
        while not self._stop.wait(self.policy.poll_s):
            try:
                self.poll_once()
            except Exception:
                # The watchdog must survive its own bugs — a dead
                # watchdog is exactly the silent failure mode this
                # subsystem exists to eliminate.
                import traceback
                traceback.print_exc()

    # ------------------------------------------------------------------
    # one assessment

    def rank_views(self, now: float | None = None) -> dict:
        """Build the detector's per-rank views from the coordinator's
        heartbeat state (dead processes excluded — they are the
        supervisor's domain, not a hang)."""
        now = self._clock() if now is None else now
        with self._lock:
            comm, pm = self._comm, self._pm
        if comm is None:
            return {}
        alive = None
        if pm is not None:
            try:
                alive = set(pm.alive_ranks())
            except Exception:
                alive = None
        views: dict = {}
        for r in range(comm.num_workers):
            if alive is not None and r not in alive:
                continue
            ping = comm.last_ping(r)
            if ping is None:
                continue
            arrival, data = ping
            data = data or {}
            age = max(0.0, now - arrival)
            v: dict = {"hb_age": round(age, 3)}
            if (data.get("busy_s") is not None
                    and age <= self.policy.hb_stale_s):
                # Extrapolate to "now": the ping said busy_s as of its
                # send; the rank has been busy for the ping age since.
                # Pings past hb_stale_s are frozen data — the rank may
                # long have finished — and are excluded from verdicts
                # (the supervisor owns silent ranks).
                v["busy_s"] = float(data["busy_s"]) + age
                v["busy_type"] = data.get("busy_type")
                v["busy_id"] = data.get("busy_id")
                v["deadline"] = data.get("busy_deadline")
            col = data.get("col") or {}
            if col:
                v["seq"] = col.get("seq")
                v["op"] = col.get("op")
                v["in"] = col.get("in")
                v["col_age"] = (col.get("age") or 0) + age
                v["cops"] = col.get("cops")
            rep = data.get("rep") or {}
            if rep:
                # Step-loop progress: a --repeat cell
                # advancing through steps is healthy forward motion —
                # the detector folds this into its progress key so a
                # long collective-free training loop never reads as a
                # stall while it is actually stepping.
                v["rep"] = rep.get("i")
            views[r] = v
        return views

    def poll_once(self, now: float | None = None) -> list[dict]:
        """One detection + escalation pass (the loop body, callable
        directly by tests and the doctor)."""
        now = self._clock() if now is None else now
        with self._lock:
            comm = self._comm
        if comm is None:
            return []
        views = self.rank_views(now)
        suspected: set = set()
        sentry = self._sentry
        if sentry is not None:
            silent: set = set()
            fresh: set = set()
            for r in range(comm.num_workers):
                ping = comm.last_ping(r)
                if ping is None:
                    continue
                (fresh if now - ping[0] <= self.policy.hb_stale_s
                 else silent).add(r)
            for ev in sentry.observe(silent, set(), fresh, now=now):
                self._event("partition",
                            f"host {ev['host']}: {ev['event']} "
                            f"(ranks {ev['ranks']})")
            suspected = sentry.suspected_ranks()
        try:
            pending = comm.pending_snapshot()
        except Exception:
            pending = {}
        verdicts = self.detector.observe(now, views, pending)
        # Tenant attribution (gateway pools): pending requests are
        # tenant-tagged, so a verdict on a pooled cell names the one
        # notebook whose cell wedged the mesh — blame lands on the
        # right tenant, not the pool.
        for v in verdicts:
            tn = (pending.get(v["cell"]) or {}).get("tenant")
            if tn and not v.get("tenant"):
                v["tenant"] = tn
                v["detail"] = f"[tenant {tn}] " + v["detail"]
        if suspected:
            # A suspected-partition host's ranks are unreachable, not
            # hung: their apparent lag is frozen data.  Verdicts that
            # blame only them are suppressed (the supervisor's
            # partition machinery owns that failure domain).
            verdicts = [v for v in verdicts
                        if not set(v["ranks"]) <= suspected]
        reg = obs_metrics.registry()
        due_steps: list[tuple] = []
        with self._lock:
            self.last_verdicts = verdicts
            active = {v["cell"]: v for v in verdicts}
            for cell, v in active.items():
                st = self._hangs.get(cell)
                if st is None:
                    # Newly HUNG — distinct from slow, by construction.
                    st = {"step": 0, "next_ts": now, "first_ts": now,
                          "verdict": v}
                    # The analyzer told you so: when the hung cell was
                    # flagged pre-dispatch, the verdict carries the
                    # finding (the doctor and postmortem render it).
                    note = _preflight_note(
                        (pending.get(cell) or {}).get("cell_sha1"))
                    if note:
                        st["preflight"] = note["summary"]
                    self._hangs[cell] = st
                    self.cells_flagged += 1
                    self.verdicts_total += 1
                    reg.counter("nbd_hang_verdicts_total",
                                "cells flagged HUNG by the watchdog",
                                {"kind": v["kind"]}).inc()
                    flightrec.record("hang_verdict", kind=v["kind"],
                                     cell=str(cell)[:16],
                                     ranks=v["ranks"], seq=v.get("seq"),
                                     op=v.get("op"),
                                     tenant=v.get("tenant"),
                                     preflight=st.get("preflight"))
                    self._event("verdict", v["detail"], cell=cell,
                                kind=v["kind"], ranks=v["ranks"])
                    if "preflight" in st:
                        self._event(
                            "preflight",
                            "pre-flight lint had flagged this cell "
                            "before dispatch: " + st["preflight"],
                            cell=cell)
                st["verdict"] = v
                if "preflight" in st:
                    v["preflight"] = st["preflight"]
                ladder = self.policy.escalate
                if st["step"] < len(ladder) and now >= st["next_ts"]:
                    step = ladder[st["step"]]
                    st["step"] += 1
                    st["next_ts"] = now + self.policy.grace_s
                    due_steps.append((step, cell, v))
            for cell in [c for c in self._hangs if c not in active]:
                st = self._hangs.pop(cell)
                self.cells_resolved += 1
                flightrec.record("hang_resolved", cell=str(cell)[:16],
                                 after_steps=st["step"])
                self._event("resolved",
                            f"hang cleared after "
                            f"{st['step']} ladder step(s)", cell=cell)
            reg.gauge("nbd_hang_active",
                      "cells currently flagged HUNG").set(
                len(self._hangs))
        # Ladder steps run OUTSIDE the lock: a step can print, signal
        # processes, or run a minutes-long heal — none of which may
        # block status()/describe() readers (%dist_status during a
        # heal must still render).
        for step, cell, v in due_steps:
            self._run_step(step, cell, v)
        return verdicts

    # ------------------------------------------------------------------
    # escalation ladder

    def _event(self, event: str, detail: str, **extra) -> None:
        # Callers arrive with and without the lock held; the RLock
        # makes re-acquiring free for the former.  The concurrency
        # self-lint (analysis/concur.py) records this as a reentrant
        # self-edge in the lock-order graph — a plain Lock here would
        # fail CI as a self-deadlock.
        with self._lock:
            self.events.append({"ts": self._clock(), "event": event,
                                "detail": detail, **extra})

    def _run_step(self, step: str, cell, verdict: dict) -> None:
        with self._lock:
            self.escalations[step] = self.escalations.get(step, 0) + 1
        obs_metrics.registry().counter(
            "nbd_hang_escalations_total",
            "escalation ladder steps executed",
            {"step": step}).inc()
        flightrec.record("hang_escalation", step=step,
                         cell=str(cell)[:16], ranks=verdict["ranks"])
        self._event("escalation", f"{step}: {verdict['detail']}",
                    cell=cell, step=step)
        try:
            if step == "warn":
                print(f"\n⚠️ hang watchdog [{verdict['kind'].upper()}]: "
                      f"{verdict['detail']} — %dist_doctor for the "
                      f"full report")
                if verdict.get("preflight"):
                    print(f"   ↳ pre-flight lint flagged this cell "
                          f"before dispatch: {verdict['preflight']}")
            elif step == "dump":
                pm = self._pm
                if pm is not None and hasattr(pm, "dump_stacks"):
                    signaled = pm.dump_stacks(None)
                    self._event("stacks",
                                f"SIGUSR1 stack dump → ranks "
                                f"{signaled} (stacks-rank*.txt under "
                                f"{knobs.get_str('NBD_RUN_DIR', '?')})",
                                cell=cell)
            elif step == "interrupt":
                # Interrupt ALL ranks, not just the laggards: peers
                # blocked inside the same collective must abort too,
                # or the subset-interrupt footgun (%dist_interrupt's
                # documented caveat) leaves them wedged.
                pm = self._pm
                if pm is not None:
                    signaled = pm.interrupt(None)
                    print(f"🛑 hang watchdog: interrupted ranks "
                          f"{signaled} to break the hung cell")
            elif step == "heal":
                heal = self._heal_fn
                if heal is None:
                    self._event("heal-skipped",
                                "heal step reached but no heal "
                                "callback wired", cell=cell)
                    return
                result = heal()
                if result is not None:
                    comm, pm = result
                    with self._lock:
                        self._comm, self._pm = comm, pm
                        self._hangs.clear()
                        self.detector.reset()
        except Exception as e:
            self._event("step-failed", f"{step} failed: {e}", cell=cell)

    # ------------------------------------------------------------------
    # reporting

    def status(self) -> dict:
        sentry = self._sentry
        with self._lock:
            return {
                "policy": self.policy.describe(),
                "suspected_hosts": (sentry.suspected_hosts()
                                    if sentry is not None else {}),
                "active": {str(c): {"kind": st["verdict"]["kind"],
                                    "ranks": st["verdict"]["ranks"],
                                    "steps_taken": st["step"],
                                    "since": st["first_ts"]}
                           for c, st in self._hangs.items()},
                "cells_flagged": self.cells_flagged,
                "cells_resolved": self.cells_resolved,
                "escalations": dict(self.escalations),
                "last_verdicts": list(self.last_verdicts),
                "events": list(self.events),
            }

    def describe(self) -> str:
        st = self.status()
        lines = [f"🐕 hang watchdog: {st['policy']} · flagged "
                 f"{st['cells_flagged']} · resolved "
                 f"{st['cells_resolved']}"
                 + (f" · escalations {st['escalations']}"
                    if st["escalations"] else "")]
        for c, a in st["active"].items():
            lines.append(f"   ⚠ HUNG [{a['kind']}] cell {c[:12]}… "
                         f"ranks {a['ranks']} "
                         f"({a['steps_taken']} ladder step(s) taken)")
        for ev in list(st["events"])[-4:]:
            lines.append(
                f"   {time.strftime('%H:%M:%S', time.localtime(ev['ts']))} "
                f"{ev['event']}: {ev['detail'][:110]}")
        return "\n".join(lines)


# ----------------------------------------------------------------------
# the stuck-cell doctor


def _stack_file(run_dir: str, rank: int) -> str | None:
    """Newest per-pid stack file for ``rank`` (file names carry the
    writer pid, like the flight rings, so a healed rank never clobbers
    its dead predecessor's dumps)."""
    prefix = f"stacks-rank{rank}."
    try:
        names = [n for n in os.listdir(run_dir)
                 if n.startswith(prefix) and n.endswith(".txt")]
    except OSError:
        return None
    if not names:
        return None
    paths = [os.path.join(run_dir, n) for n in names]
    paths.sort(key=lambda p: (os.path.getmtime(p), p), reverse=True)
    return paths[0]


def _stack_tail(run_dir: str, rank: int,
                lines: int) -> tuple[str, str] | None:
    """(path, last-N-lines) of the rank's newest stack dump, or None.
    One lookup serves both: resolving the path twice would double the
    directory scan AND risk labeling the tail with a different file
    than the one read (a heal can mint a newer one in between)."""
    path = _stack_file(run_dir, rank)
    if path is None:
        return None
    try:
        with open(path) as f:
            content = f.read()
    except OSError:
        return None
    if not content.strip():
        return None
    return path, "\n".join(content.rstrip().splitlines()[-lines:])


def hang_report(comm, pm=None, watchdog: HangWatchdog | None = None, *,
                dump_stacks: bool = True, stack_wait_s: float = 0.8,
                stack_lines: int = 30, flight_lines: int = 6,
                async_window: dict | None = None) -> str:
    """Assemble the ``%dist_doctor`` report: per-rank collective
    positions and busy ages, the skew table naming lagging rank(s)
    and the divergence point, active watchdog verdicts, freshly
    dumped per-rank stacks (SIGUSR1 → faulthandler), and each flight
    ring's last events.  Read-mostly: the only cluster interaction is
    the optional stack-dump signal — nothing goes through the
    workers' (possibly wedged) serial request loops.

    ``async_window`` (an ``AsyncExecutor.snapshot()``) names the
    async-pipelined cells among the in-flight requests:
    with >1 cell in flight, "which request is the mesh actually
    executing and which are streamed behind it" is exactly what a
    hang report must answer."""
    now = time.time()
    wd = watchdog
    # Lenient env parse: a typo'd NBD_HANG_ESCALATE is exactly why the
    # watchdog failed to auto-start — the DIAGNOSTIC must still run.
    policy = (wd.policy if wd is not None
              else HangPolicy.from_env_lenient())
    # Detection-READ-ONLY on purpose: the doctor reports the standing
    # watchdog's latest assessment (at most poll_s stale) instead of
    # driving poll_once itself — a poll executes due escalation-ladder
    # steps (interrupt! heal!), and a report/postmortem capture must
    # never perturb the very state it is recording.
    if wd is not None:
        views = wd.rank_views(now)
        verdicts = list(wd.last_verdicts)
    else:
        tmp = HangWatchdog(policy)
        tmp._comm, tmp._pm = comm, pm
        views = tmp.rank_views(now)
        verdicts = []
    lines = [
        "nbdistributed_tpu_torch stuck-cell doctor",
        "=" * 41,
        f"time    : {time.strftime('%Y-%m-%dT%H:%M:%S')}",
        f"world   : {getattr(comm, 'num_workers', '?')} workers",
        f"policy  : {policy.describe()}",
    ]
    # Multi-host worlds: per-host link health (RTT from the clock
    # estimator's min-RTT samples, heartbeat ages, redeliveries as the
    # loss proxy) plus any partition suspicion — "which link is sick"
    # before "which rank is stuck".
    hosts_map = dict(getattr(pm, "hosts", None) or {})
    if len(set(hosts_map.values()) | {getattr(comm, "local_host",
                                              "local")}) > 1:
        try:
            ls = comm.link_stats()
        except Exception:
            ls = None
        if ls:
            from .partition import format_link_suffix
            lines.append("")
            lines.append("hosts / links (rtt = min clock-sample RTT; "
                         "retries ≈ frames a link ate):")
            for h, hs in sorted(ls["hosts"].items()):
                lines.append(f"   {h:<14} ranks {hs['ranks']} · "
                             f"{format_link_suffix(hs)}")
        sentry = getattr(wd, "_sentry", None) if wd is not None else None
        if sentry is not None:
            note = sentry.describe()
            if note:
                lines.append(f"   {note}")
    lines += [
        "",
        f"{'rank':<5}{'busy':<22}{'hb-age':<8}{'col#':<6}"
        f"{'op':<22}{'in':<4}{'col-age':<9}{'cell-ops':<8}",
    ]
    lines.append("─" * len(lines[-1]))
    world = getattr(comm, "num_workers", 0) or 0
    seqs: dict[int, int] = {}
    for r in range(world):
        v = views.get(r)
        if v is None:
            state = "(no heartbeat — dead or never attached)"
            lines.append(f"{r:<5}{state}")
            continue
        busy = "-"
        if v.get("busy_s") is not None:
            busy = f"{v.get('busy_type')} {v['busy_s']:.1f}s"
            if v.get("deadline"):
                busy += f"/{v['deadline']:.0f}s"
        seqs[r] = int(v.get("seq") or 0)
        col_age = v.get("col_age")
        col_age_s = f"{col_age:.1f}" if col_age is not None else "-"
        lines.append(
            f"{r:<5}{busy:<22}{v.get('hb_age', 0):<8.1f}"
            f"{str(v.get('seq', '-')):<6}{str(v.get('op') or '-'):<22}"
            f"{('y' if v.get('in') else '-'):<4}"
            f"{col_age_s:<9}{str(v.get('cops', '-')):<8}")
    # Skew table: who is behind whom, among BUSY ranks only and by
    # CELL-LOCAL position (process-lifetime seqs diverge permanently
    # and harmlessly after a hazard-raise or a broken hang — they are
    # shown per-rank above, but must not be called "lagging").
    pos = {r: int((views[r].get("cops") or 0))
           for r in range(world)
           if views.get(r) is not None
           and views[r].get("busy_s") is not None}
    lines.append("")
    if pos:
        maxpos = max(pos.values())
        lag = sorted(r for r, p in pos.items() if p < maxpos)
        if lag and maxpos:
            lines.append(
                f"skew    : busy ranks' max cell position #{maxpos} "
                f"(global seq #{max(seqs.get(r, 0) for r in pos)}); "
                f"lagging rank(s) {lag} at "
                f"{sorted(set(pos[r] for r in lag))}")
        else:
            lines.append(f"skew    : none — all busy ranks at cell "
                         f"position #{maxpos}")
    else:
        lines.append("skew    : (no busy ranks)")
    # In-flight requests.
    try:
        pend = comm.pending_snapshot()
    except Exception:
        pend = {}
    async_cells = {c.get("msg_id"): c
                   for c in (async_window or {}).get("cells", ())
                   if c.get("msg_id")}
    if pend:
        lines.append("")
        lines.append("in-flight requests:")
        for mid, p in sorted(pend.items()):
            missing = sorted(set(p["expect"]) - set(p["responded"]))
            age = (f"{now - p['sent_at']:.1f}s" if p.get("sent_at")
                   else "?")
            who = (f" · tenant {p['tenant']}" if p.get("tenant")
                   else "")
            ac = async_cells.get(mid)
            tag = ""
            if ac is not None:
                tag = (f" · ⧗ async cell #{ac['seq']}"
                       + (" (holds the collective stream)"
                          if ac.get("collective") != "free" else ""))
            lines.append(f"   {mid[:12]}… {p.get('type') or '?'} "
                         f"age {age} · responded {p['responded']} · "
                         f"waiting on {missing}{who}{tag}")
            note = _preflight_note(p.get("cell_sha1"))
            if note:
                lines.append(f"      ↳ pre-flight lint flagged this "
                             f"cell before dispatch: "
                             f"{note['summary']}")
    if async_window and async_window.get("depth"):
        lines.append(
            f"async   : window {async_window['depth']}/"
            f"{async_window['window']} in flight — the per-rank loop "
            f"is serial, so streamed cells behind the busy one are "
            f"QUEUED on the worker, not hung")
    # Verdicts.
    lines.append("")
    if verdicts:
        lines.append("verdicts:")
        for v in verdicts:
            lines.append(f"   ⚠ HUNG [{v['kind']}] {v['detail']}")
            if v.get("preflight"):
                lines.append(f"      ↳ pre-flight lint flagged this "
                             f"cell before dispatch: {v['preflight']}")
    elif wd is not None:
        lines.append("verdicts: none — nothing HUNG by current policy")
    else:
        lines.append("verdicts: (no watchdog attached — positions "
                      "only; %dist_watchdog on)")
    if wd is not None and wd.escalations:
        lines.append(f"escalations so far: {dict(wd.escalations)}")
    # Stacks: freshly dumped, then read back.
    run_d = knobs.get_str("NBD_RUN_DIR") or ""
    if dump_stacks and pm is not None and hasattr(pm, "dump_stacks"):
        signaled = pm.dump_stacks(None)
        if signaled:
            time.sleep(stack_wait_s)  # let faulthandler write
        lines.append("")
        lines.append(f"stacks (SIGUSR1 → ranks {signaled}):")
        for r in range(world):
            res = _stack_tail(run_d, r, stack_lines) if run_d else None
            if res is None:
                lines.append(f"-- rank {r}: no stack file")
                continue
            path, tail = res
            lines.append(f"-- rank {r} ({path}):")
            lines.append(tail)
    # Flight-ring tails.
    if run_d:
        lines.append("")
        lines.append("last flight events:")
        import json as _json
        for key in [*range(world), "coordinator"]:
            proc = key if key == "coordinator" else f"rank{key}"
            ring = flightrec.read_latest(run_d, proc)
            if ring is None:
                lines.append(f"-- {proc}: no ring")
                continue
            lines.append(f"-- {proc} ({ring['recovered']} events"
                         + (", TORN tail" if ring.get("torn_tail")
                            else "") + "):")
            for ev in ring["events"][-flight_lines:]:
                ts = time.strftime("%H:%M:%S",
                                   time.localtime(ev.get("ts", 0)))
                detail = {k: v for k, v in ev.items()
                          if k not in ("t", "ts")}
                lines.append(f"     {ts} {ev.get('t', '?'):<20} "
                             f"{_json.dumps(detail, default=str)[:100]}")
    return "\n".join(lines)
