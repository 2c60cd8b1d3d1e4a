"""Auto-heal supervisor: from manual ``%dist_heal`` to a control loop
(a copy of ``nbdistributed_tpu/resilience/supervisor.py``).

Consumes the two liveness signals the stack already produces —
``ProcessManager`` death callbacks (authoritative: the child exited)
and coordinator-side heartbeat freshness (``last_ping``/``last_seen``)
— and maintains a per-rank state machine:

    alive ⇄ degraded          (heartbeats stale / resumed — a slow or
                               wedged host, NOT grounds for restart)
    alive|degraded → dead     (process exit; only this triggers heal)
    dead → healing → alive    (auto-heal under the restart budget)

A ``torch.distributed`` process group is fixed-membership — a dead
rank cannot rejoin a live NCCL communicator or gloo context — so
healing is always a FULL restart + state restore (replay the
recorded ``%dist_init``, restore the last checkpoint), never a
single-rank rejoin.  A respawned rank takes the same GPU and joins a
fresh rendezvous port; the kernels' libraries load from the build
directory, not rebuilt.  The heal callback
is pluggable: the magic layer wires ``%dist_heal`` replay; tests wire
a direct cluster rebuild.

The restart budget (``max_restarts`` per ``restart_window_s``) caps
crash-loops: a world that keeps dying stops being restarted and the
transition log says so, instead of burning GPU time respawning a
broken program forever.  Every transition lands in a bounded event log
surfaced by ``%dist_status``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

from ..observability import flightrec
from .partition import PartitionSentry

ALIVE = "alive"
DEGRADED = "degraded"
DEAD = "dead"
HEALING = "healing"
# Host-level partition suspicion: every rank on one host
# went silent/dead together while the rest of the fleet is fine.  NOT
# grounds for healing until the partition grace expires — the far side
# is (probably) alive, orphaned, and holding state.
SUSPECT = "suspect-partition"
# Training-integrity quarantine suspicion: the rank's
# TrainGuard kept landing in the audit minority — its arithmetic is
# producing different bits than the rest of the replica set (SDC-class
# hardware suspicion).  ADVISORY and STICKY: the rank stays in the
# liveness state machine (it is alive and being repaired), the label
# rides %dist_status until a heal replaces the world — it never
# triggers healing by itself.
QUARANTINE = "quarantine-suspect"


@dataclass(frozen=True)
class SupervisorPolicy:
    degraded_after_s: float = 6.0     # 3 missed heartbeats
    poll_s: float = 0.5
    max_restarts: int = 3
    restart_window_s: float = 600.0
    auto_heal: bool = True
    # Assemble a postmortem bundle (observability/postmortem.py) for
    # newly-dead ranks BEFORE healing replaces the world — the heal is
    # what destroys the evidence a human would want afterwards.
    postmortem: bool = True
    # Partition grace (multi-host worlds): how long whole-host silence
    # is ridden out as a SUSPECTED partition before the host is
    # declared lost and healing proceeds.  None = NBD_PARTITION_GRACE_S
    # (default 30 s).  Must stay below the workers' orphan TTL, or a
    # healed link finds its orphans already self-terminated.
    partition_grace_s: float | None = None


class Supervisor:
    """One supervision loop over a (comm, pm) pair.

    ``heal()`` — required for auto-heal — must rebuild the world and
    restore state; it may return a fresh ``(comm, pm)`` pair (the
    usual case: healing replaces both) which the supervisor rebinds
    to.  It runs on the supervisor's own thread, never on the process
    monitor's callback thread.
    """

    def __init__(self, policy: SupervisorPolicy | None = None, *,
                 heal=None, clock=time.time):
        self.policy = policy or SupervisorPolicy()
        self._heal_fn = heal
        self._clock = clock
        self.events: deque[dict] = deque(maxlen=256)
        # Monotonic count of recorded events: the deque above is
        # bounded (display/debugging), so totals must not be derived
        # from its length (a crash-looping world would saturate at the
        # maxlen and report a frozen number).
        self.transitions = 0
        self.heals_done = 0
        self.heals_failed = 0
        # Newest postmortem bundle manifest captured by this
        # supervisor (None until a death is processed).
        self.last_postmortem: dict | None = None
        self._postmortem_pending: set[int] = set()
        self._state: dict[int, str] = {}
        # Advisory quarantine suspicions: rank → detail.
        # Parallel to the liveness states on purpose — a quarantined
        # rank is alive and supervised normally; this is a sticky
        # label, not a lifecycle stage.
        self._quarantined: dict[int, str] = {}
        self._sentry: PartitionSentry | None = None
        self._restarts: deque[float] = deque()
        self._comm = None
        self._pm = None
        self._pm_hooked: int | None = None  # id(pm) with our callback
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._pending_heal = False
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------
    # lifecycle

    def _hook_pm(self, pm) -> None:
        """Move the death callback to ``pm`` (lock held).  Detaching
        from the previous ProcessManager matters even though a healed
        world's old pm is dying anyway: a stopped-and-reattached cycle
        on the SAME pm must not accumulate callbacks to retired state."""
        if self._pm_hooked == id(pm):
            return
        old = self._pm
        if old is not None and self._pm_hooked == id(old):
            remove = getattr(old, "remove_death_callback", None)
            if remove is not None:
                remove(self._on_death)
        pm.add_death_callback(self._on_death)
        self._pm_hooked = id(pm)

    def attach(self, comm, pm) -> None:
        """Bind to a live cluster and start (or resume, after a
        ``stop()``) supervising.  Multi-host worlds (the process
        manager carries a rank→host map with ≥2 hosts) get a
        :class:`~.partition.PartitionSentry`: whole-host silence is a
        suspected partition, not N deaths."""
        hosts = dict(getattr(pm, "hosts", None) or {})
        with self._lock:
            self._hook_pm(pm)
            self._comm, self._pm = comm, pm
            self._state = {r: ALIVE for r in range(comm.num_workers)}
            self._quarantined = {}
            self._pending_heal = False
            self._sentry = PartitionSentry(
                hosts, local_host=getattr(comm, "local_host", "local"),
                grace_s=self.policy.partition_grace_s,
                source="supervisor", clock=self._clock)
            if not self._sentry.active:
                self._sentry = None
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._wake.clear()
            self._thread = threading.Thread(target=self._loop,
                                            name="nbd-supervisor",
                                            daemon=True)
            self._thread.start()

    def stop(self) -> None:
        with self._lock:
            pm = self._pm
            if pm is not None and self._pm_hooked == id(pm):
                remove = getattr(pm, "remove_death_callback", None)
                if remove is not None:
                    remove(self._on_death)
            self._pm_hooked = None
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5)

    def on_own_thread(self) -> bool:
        return threading.current_thread() is self._thread

    # ------------------------------------------------------------------
    # inputs

    def _on_death(self, rank: int, rc: int | None) -> None:
        """ProcessManager monitor callback — must not block: record and
        wake the supervisor thread, which owns the (slow) heal."""
        with self._lock:
            if self._state.get(rank) in (DEAD, HEALING):
                return
            self._transition(rank, DEAD, f"process exit (code {rc})")
            self._pending_heal = True
            self._postmortem_pending.add(rank)
        self._wake.set()

    def _transition(self, rank, to: str, detail: str = "") -> None:
        # Callers hold the lock; re-acquiring the RLock here costs
        # nothing and keeps the method safe for the stray direct call.
        # The concurrency self-lint (analysis/concur.py) records this
        # as a reentrant self-edge in the lock-order graph — a plain
        # Lock here would fail CI as a self-deadlock.
        with self._lock:
            frm = self._state.get(rank)
            if frm == to:
                return
            if rank is not None:
                self._state[rank] = to
            self.transitions += 1
            self.events.append({"ts": self._clock(), "rank": rank,
                                "from": frm, "to": to, "detail": detail})
        # Mirror every transition into the crash-surviving flight ring:
        # the in-memory event deque dies with the coordinator process.
        flightrec.record("supervisor_transition", rank=rank,
                         frm=frm, to=to, detail=detail)

    def note_quarantine_suspect(self, rank: int, detail: str = "") -> None:
        """Mark ``rank`` as a training-integrity quarantine suspect
       .  Advisory + sticky + idempotent: recorded once in
        the event log / flight ring, surfaced by ``%dist_status``, and
        cleared only when a new world attaches or a heal replaces the
        fleet.  Never schedules a heal — a rank producing wrong bits
        is still a live rank, and the repair path (majority
        re-broadcast) already fixed its state; this is the operator
        signal to retire the hardware."""
        with self._lock:
            if rank in self._quarantined:
                return
            self._quarantined[rank] = detail
            self.transitions += 1
            self.events.append({"ts": self._clock(), "rank": rank,
                                "from": self._state.get(rank),
                                "to": QUARANTINE, "detail": detail})
        flightrec.record("supervisor_transition", rank=rank,
                         frm=None, to=QUARANTINE, detail=detail)

    # ------------------------------------------------------------------
    # loop

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.policy.poll_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self._scan_staleness()
                self._scan_guard()
                self._scan_partitions()
                self._capture_postmortems()
                if self.policy.auto_heal and self._heal_needed():
                    self._heal_once()
            except Exception:
                # The supervision loop must survive its own bugs —
                # a dead supervisor is exactly the failure mode this
                # subsystem exists to prevent.
                import traceback
                traceback.print_exc()

    def _scan_staleness(self) -> None:
        with self._lock:
            comm = self._comm
            ranks = [r for r, s in self._state.items()
                     if s in (ALIVE, DEGRADED)]
        if comm is None:
            return
        now = self._clock()
        for rank in ranks:
            ping = comm.last_ping(rank)
            seen = comm.last_seen(rank)
            candidates = [t for t in ((ping[0] if ping else None), seen)
                          if t is not None]
            if not candidates:
                continue  # never heard from it; bring-up owns that
            age = now - max(candidates)
            with self._lock:
                st = self._state.get(rank)
                if age > self.policy.degraded_after_s and st == ALIVE:
                    self._transition(rank, DEGRADED,
                                     f"no heartbeat for {age:.1f}s")
                elif age <= self.policy.degraded_after_s \
                        and st == DEGRADED:
                    self._transition(rank, ALIVE, "heartbeat resumed")

    def _scan_guard(self) -> None:
        """Harvest training-integrity quarantine suspects from the
        heartbeat ``tg`` piggyback — pings only, no status
        probe: a worker mid-cell still reports.  Any rank's guard may
        name any suspect (verdicts are computed identically on every
        rank), so the union over all pings is taken."""
        with self._lock:
            comm = self._comm
        if comm is None:
            return
        for r in range(comm.num_workers):
            ping = comm.last_ping(r)
            if not ping:
                continue
            tg = (ping[1] or {}).get("tg")
            if not isinstance(tg, dict):
                continue
            for suspect in tg.get("qr") or ():
                if isinstance(suspect, int):
                    self.note_quarantine_suspect(
                        suspect, f"rank {r}'s guard reports repeated "
                                 f"audit divergence (tg.qr)")

    # ------------------------------------------------------------------
    # partition suspicion (multi-host worlds)

    def _scan_partitions(self) -> None:
        """Feed the sentry one liveness snapshot and apply its
        transitions: whole-host silence → SUSPECT (heal deferred),
        recovery → ALIVE, grace expiry → DEAD + heal."""
        sentry = self._sentry
        if sentry is None:
            return
        with self._lock:
            comm = self._comm
            states = dict(self._state)
        if comm is None:
            return
        now = self._clock()
        silent: set[int] = set()
        fresh: set[int] = set()
        for r in range(comm.num_workers):
            ping = comm.last_ping(r)
            seen = comm.last_seen(r)
            ts = [t for t in ((ping[0] if ping else None), seen)
                  if t is not None]
            if not ts:
                continue  # never heard from; bring-up owns it
            if now - max(ts) <= self.policy.degraded_after_s:
                fresh.add(r)
            else:
                silent.add(r)
        dead = {r for r, s in states.items() if s == DEAD}
        events = sentry.observe(silent, dead, fresh, now=now)
        if not events:
            return
        with self._lock:
            for ev in events:
                if ev["event"] == "suspected":
                    for r in ev["ranks"]:
                        # Known process-deaths keep their DEAD state
                        # (that fact survives the suspicion); the heal
                        # deferral works off the sentry's host state,
                        # not the rank label.
                        if self._state.get(r) != DEAD:
                            self._transition(
                                r, SUSPECT,
                                f"host {ev['host']}: every rank silent "
                                f"at once — suspected partition; heal "
                                f"deferred {sentry.grace_s:.0f}s")
                elif ev["event"] == "healed":
                    for r in ev["ranks"]:
                        st = self._state.get(r)
                        # A DEAD rank only resurrects if IT was heard
                        # from: one sibling's ping proves the LINK is
                        # back, not that a rank whose process exited
                        # mid-partition lives — resurrecting it here
                        # would clear the pending heal and leave the
                        # fleet permanently short.
                        if st in (SUSPECT, DEGRADED) \
                                or (st == DEAD and r in fresh):
                            self._transition(
                                r, ALIVE,
                                f"host {ev['host']}: partition healed "
                                f"— rank heard from again")
                elif ev["event"] == "expired":
                    for r in ev["ranks"]:
                        self._transition(
                            r, DEAD,
                            f"host {ev['host']}: partition grace "
                            f"expired — treating host as lost")
                        self._postmortem_pending.add(r)
                    self._pending_heal = True
        self._wake.set()

    def _heal_needed(self) -> bool:
        """Is a heal both pending and currently allowed?  Deferred
        while every unhealthy rank sits behind a link the sentry still
        suspects (the far side is riding its orphan grace); cleared
        entirely when the world recovered on its own (a healed
        partition must not trigger a respawn of a healthy fleet)."""
        with self._lock:
            if not self._pending_heal:
                return False
            dead = [r for r, s in self._state.items() if s == DEAD]
            unhealthy = {r for r, s in self._state.items()
                         if s in (DEAD, SUSPECT)}
            if not dead and not unhealthy:
                self._pending_heal = False
                return False
            if not dead:
                # Only SUSPECT ranks remain: the sentry owns them.
                return False
        sentry = self._sentry
        if sentry is not None and unhealthy and \
                unhealthy <= sentry.suspected_ranks():
            return False
        return True

    # ------------------------------------------------------------------
    # postmortems

    def _capture_postmortems(self) -> None:
        """Bundle the newly-dead ranks' black boxes on the supervisor's
        own thread, BEFORE any heal replaces the world.  Best-effort by
        contract: a full postmortem disk must never block recovery."""
        with self._lock:
            dead = sorted(self._postmortem_pending)
            self._postmortem_pending.clear()
            comm = self._comm
        if not dead or not self.policy.postmortem or comm is None:
            return
        try:
            from ..observability import postmortem as pm_mod
            manifest = pm_mod.capture(
                comm, dead, reason=f"supervisor: ranks {dead} died")
        except Exception:
            manifest = None
        if manifest is not None:
            self.last_postmortem = manifest
            with self._lock:
                self.transitions += 1
                self.events.append({
                    "ts": self._clock(), "rank": None,
                    "from": DEAD, "to": DEAD,
                    "detail": f"postmortem → {manifest['dir']}"})

    # ------------------------------------------------------------------
    # healing

    def _heal_once(self) -> None:
        with self._lock:
            self._pending_heal = False
            now = self._clock()
            while (self._restarts and now - self._restarts[0]
                    > self.policy.restart_window_s):
                self._restarts.popleft()
            if len(self._restarts) >= self.policy.max_restarts:
                self.transitions += 1
                self.events.append({
                    "ts": now, "rank": None, "from": DEAD, "to": DEAD,
                    "detail": (f"restart budget exhausted "
                               f"({self.policy.max_restarts} per "
                               f"{self.policy.restart_window_s:.0f}s); "
                               f"manual %dist_heal required")})
                return
            self._restarts.append(now)
            dead = sorted(r for r, s in self._state.items() if s == DEAD)
            for r in list(self._state):
                self._transition(r, HEALING,
                                 f"auto-heal (dead ranks {dead})")
        heal = self._heal_fn
        try:
            result = heal() if heal is not None else None
        except Exception as e:
            with self._lock:
                self.heals_failed += 1
                for r in list(self._state):
                    self._transition(r, DEAD, f"heal failed: {e}")
                # Transient respawn failures (port in TIME_WAIT, slow
                # attach) must not silently end supervision: retry on
                # the next poll, bounded by the restart budget — each
                # attempt consumed a slot, so a genuinely broken world
                # stops at "budget exhausted", not in a tight loop.
                self._pending_heal = True
            return
        if self._stop.is_set():
            # stop() raced the (slow) respawn: the heal callback may
            # have brought a world up that nobody is supervising now.
            # Don't rebind — surface it so the operator can decide.
            with self._lock:
                self.transitions += 1
                self.events.append({
                    "ts": self._clock(), "rank": None,
                    "from": HEALING, "to": ALIVE,
                    "detail": "heal completed AFTER supervisor stop — "
                              "the respawned world is unsupervised; "
                              "shut it down manually if unwanted"})
            return
        with self._lock:
            if result is not None:
                comm, pm = result
                self._hook_pm(pm)
                self._comm, self._pm = comm, pm
                self._state = {r: HEALING
                               for r in range(comm.num_workers)}
            for r in list(self._state):
                self._transition(r, ALIVE, "healed")
            # A heal replaces the processes (and their state was
            # restored from a good checkpoint): stale quarantine
            # suspicions would smear the fresh world.
            self._quarantined = {}
            self.heals_done += 1
            comm, pm = self._comm, self._pm
        # Durable-session manifest upkeep: the healed fleet's pids and
        # endpoint must replace the dead ones, or a later %dist_attach
        # would adopt corpses.  (The magic-layer heal path rewrites the
        # manifest through %dist_init anyway; this covers direct
        # Supervisor embeddings.)  Best-effort by contract.
        if comm is not None and pm is not None:
            try:
                from . import session as session_mod
                session_mod.refresh_after_heal(comm, pm)
            except Exception:
                pass

    # ------------------------------------------------------------------
    # reporting

    def healthy(self) -> bool:
        with self._lock:
            return (bool(self._state)
                    and all(s == ALIVE for s in self._state.values()))

    def status(self) -> dict:
        sentry = self._sentry
        with self._lock:
            return {"states": dict(self._state),
                    "restarts_used": len(self._restarts),
                    "max_restarts": self.policy.max_restarts,
                    "auto_heal": self.policy.auto_heal,
                    "heals_done": self.heals_done,
                    "heals_failed": self.heals_failed,
                    "transitions": self.transitions,
                    "suspected_hosts": (sentry.suspected_hosts()
                                        if sentry is not None else {}),
                    "quarantined": dict(self._quarantined),
                    "last_postmortem": (self.last_postmortem or {})
                    .get("dir"),
                    "events": list(self.events)}

    def describe(self) -> str:
        """Human-readable block for ``%dist_status``."""
        st = self.status()
        icon = {ALIVE: "●", DEGRADED: "◐", DEAD: "✖", HEALING: "🩹",
                SUSPECT: "⚡", QUARANTINE: "🔶"}
        quarantined = st["quarantined"]
        ranks = " ".join(
            ("🔶" if r in quarantined else "") +
            f"{icon.get(s, '?')}{r}:{s}"
            for r, s in sorted(st["states"].items()))
        lines = [f"🛡  supervisor: {ranks or '(no ranks)'} · "
                 f"restarts {st['restarts_used']}/{st['max_restarts']} "
                 f"in window · heals {st['heals_done']} ok"
                 + (f", {st['heals_failed']} failed"
                    if st["heals_failed"] else "")
                 + ("" if st["auto_heal"] else " · auto-heal OFF")]
        if self._sentry is not None:
            note = self._sentry.describe()
            if note:
                lines.append(f"   {note}")
        if quarantined:
            lines.append("   🔶 quarantine suspects: " + ", ".join(
                f"rank {r} ({d})" if d else f"rank {r}"
                for r, d in sorted(quarantined.items())))
        for ev in list(st["events"])[-5:]:
            rank = "world" if ev["rank"] is None else f"rank {ev['rank']}"
            lines.append(f"   {time.strftime('%H:%M:%S', time.localtime(ev['ts']))} "
                         f"{rank}: {ev['from']} → {ev['to']}"
                         + (f" ({ev['detail']})" if ev["detail"] else ""))
        return "\n".join(lines)
