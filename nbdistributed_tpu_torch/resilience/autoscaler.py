"""Pressure-driven pool autoscaling policy (counterpart of
``nbdistributed_tpu/resilience/autoscaler.py``).

``PoolAutoscaler`` is the decision half of elastic pools: it watches
the three load signals that already exist — scheduler queue depth,
serving backlog, and the latency observatory's queue-stage p95 — and
answers "should the world grow or shrink, and to what size".  It is a
pure fake-clock state machine in the ``SkewDetector`` mold: no
threads, no IO, no ``time.time()`` — the gateway daemon feeds it
snapshots on its own cadence and executes whatever it decides through
the resize path (drain barrier + epoch bump + respawn).

Flap resistance is structural, not tuned: pressure must be *sustained*
for ``sustain_s`` before a grow (a single spike resets the clock when
it clears), idleness must be sustained for ``idle_s`` before a shrink,
and every executed resize opens a ``cooldown_s`` window during which
no new decision fires.  Min/max clamping is absolute — a world outside
the band is pulled back in without waiting for sustain.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from ..utils import knobs


@dataclass
class AutoscalePolicy:
    """Thresholds; defaults from the ``NBD_AUTOSCALE_*`` knobs."""
    min_workers: int = 1
    max_workers: int = 8
    interval_s: float = 5.0      # daemon poll cadence (not used here)
    up_queue: int = 4            # queued cells that count as pressure
    up_backlog: int = 8          # pending serve requests ditto
    up_p95_s: float = 2.0        # queue-stage p95 ditto
    sustain_s: float = 15.0      # pressure persistence before a grow
    idle_s: float = 120.0        # idle persistence before a shrink
    cooldown_s: float = 60.0     # post-resize decision blackout

    @classmethod
    def from_env(cls, env=None) -> "AutoscalePolicy":
        return cls(
            min_workers=knobs.get_int("NBD_AUTOSCALE_MIN", 1, env=env),
            max_workers=knobs.get_int("NBD_AUTOSCALE_MAX", 8, env=env),
            interval_s=knobs.get_float("NBD_AUTOSCALE_INTERVAL_S", 5.0,
                                       env=env),
            up_queue=knobs.get_int("NBD_AUTOSCALE_UP_QUEUE", 4,
                                   env=env),
            up_backlog=knobs.get_int("NBD_AUTOSCALE_UP_BACKLOG", 8,
                                     env=env),
            up_p95_s=knobs.get_float("NBD_AUTOSCALE_UP_P95_S", 2.0,
                                     env=env),
            sustain_s=knobs.get_float("NBD_AUTOSCALE_SUSTAIN_S", 15.0,
                                      env=env),
            idle_s=knobs.get_float("NBD_AUTOSCALE_IDLE_S", 120.0,
                                   env=env),
            cooldown_s=knobs.get_float("NBD_AUTOSCALE_COOLDOWN_S",
                                       60.0, env=env),
        )

    def describe(self) -> str:
        return (f"band {self.min_workers}:{self.max_workers} · "
                f"grow on queue>{self.up_queue} | "
                f"backlog>{self.up_backlog} | "
                f"queue-p95>{self.up_p95_s:.1f}s sustained "
                f"{self.sustain_s:.0f}s · shrink after "
                f"{self.idle_s:.0f}s idle · cooldown "
                f"{self.cooldown_s:.0f}s")


@dataclass
class Decision:
    action: str        # "grow" | "shrink"
    target: int        # new world size
    reason: str        # human-readable signal, flight-recorded
    # The full structured audit record behind this verdict:
    # pressure inputs, sustain/cooldown state, clamp flag — what the
    # daemon flight-records and postmortem bundles carry.
    record: dict | None = field(default=None, compare=False)


class PoolAutoscaler:
    """Pure decision loop: ``observe(now, ...)`` consumes one load
    snapshot and returns a :class:`Decision` or None.  The caller
    (the daemon's autoscale thread) reports execution back through
    :meth:`note_resized` — failed resizes too, so a wedged grow can't
    be retried at poll frequency."""

    def __init__(self, policy: AutoscalePolicy | None = None):
        self.policy = policy or AutoscalePolicy()
        self._pressure_since: float | None = None
        self._idle_since: float | None = None
        self._cooldown_until: float = 0.0
        self.decisions_total = 0
        # Audit trail: one structured record per observe()
        # call — inputs, pressure signals, sustain/cooldown state,
        # verdict — rendered by ``%dist_pool status --autoscale`` and
        # carried into postmortem bundles via the daemon's flight
        # records.  Same thread discipline as the rest of the state
        # machine: the daemon's autoscale thread is the only writer.
        self._decisions: deque = deque(maxlen=128)

    def decisions(self, last: int | None = None) -> list[dict]:
        """Recent audit records, oldest first."""
        recs = list(self._decisions)
        return recs[-last:] if last else recs

    def note_resized(self, now: float) -> None:
        """A resize just executed (or failed): open the cooldown and
        drop the persistence clocks — the new world starts clean."""
        self._cooldown_until = now + self.policy.cooldown_s
        self._pressure_since = None
        self._idle_since = None

    # ------------------------------------------------------------------

    def observe(self, now: float, *, world_size: int, queued: int = 0,
                active: int = 0, backlog: int = 0,
                queue_p95_s: float = 0.0) -> Decision | None:
        pol = self.policy
        # Audit record: every observation leaves one —
        # verdict or hold — naming the inputs and clock state that
        # drove it, so a resize (or its absence) is explainable after
        # the fact.
        rec = {
            "ts": round(now, 3),
            "world": int(world_size),
            "inputs": {"queued": int(queued), "active": int(active),
                       "backlog": int(backlog),
                       "queue_p95_s": round(float(queue_p95_s), 3)},
            "pressure": [],
            "sustain_s": 0.0,
            "idle_for_s": 0.0,
            "cooldown_s": round(max(0.0, self._cooldown_until - now),
                                1),
            "verdict": "hold", "target": None, "reason": None,
            "clamp": False,
        }

        def _audit(d: Decision | None,
                   clamp: bool = False) -> Decision | None:
            if d is not None:
                self.decisions_total += 1
                rec["verdict"] = d.action
                rec["target"] = d.target
                rec["reason"] = d.reason
                rec["clamp"] = clamp
                d.record = rec
            self._decisions.append(rec)
            return d

        # Band clamping is unconditional: a world outside min:max is
        # wrong regardless of load and regardless of cooldown (the arm
        # moment itself may find a too-small pool).
        if world_size < pol.min_workers:
            return _audit(Decision("grow", pol.min_workers,
                                   f"world {world_size} below min "
                                   f"{pol.min_workers}"), clamp=True)
        if world_size > pol.max_workers:
            return _audit(Decision("shrink", pol.max_workers,
                                   f"world {world_size} above max "
                                   f"{pol.max_workers}"), clamp=True)

        if now < self._cooldown_until:
            # Blackout: no decision, AND no clock arming — load seen
            # during the cooldown is tainted by the resize itself (the
            # drain barrier accumulates queue by design), so pressure
            # must re-sustain against the new world.
            rec["reason"] = "cooldown"
            return _audit(None)

        pressure = rec["pressure"]
        if pol.up_queue and queued > pol.up_queue:
            pressure.append(f"queue {queued}>{pol.up_queue}")
        if pol.up_backlog and backlog > pol.up_backlog:
            pressure.append(f"backlog {backlog}>{pol.up_backlog}")
        if pol.up_p95_s and queue_p95_s > pol.up_p95_s:
            pressure.append(f"queue-p95 {queue_p95_s:.2f}s"
                            f">{pol.up_p95_s:.1f}s")
        idle = not pressure and queued == 0 and active == 0 \
            and backlog == 0

        # Persistence clocks: a signal that clears resets its clock —
        # that is the whole no-flap-on-a-spike story.
        if pressure:
            if self._pressure_since is None:
                self._pressure_since = now
        else:
            self._pressure_since = None
        if idle:
            if self._idle_since is None:
                self._idle_since = now
        else:
            self._idle_since = None
        if self._pressure_since is not None:
            rec["sustain_s"] = round(now - self._pressure_since, 1)
        if self._idle_since is not None:
            rec["idle_for_s"] = round(now - self._idle_since, 1)

        if (pressure and self._pressure_since is not None
                and now - self._pressure_since >= pol.sustain_s
                and world_size < pol.max_workers):
            target = min(pol.max_workers, max(world_size + 1,
                                              world_size * 2))
            return _audit(Decision(
                "grow", target,
                f"{', '.join(pressure)} sustained "
                f"{now - self._pressure_since:.0f}s"))

        if (idle and self._idle_since is not None
                and now - self._idle_since >= pol.idle_s
                and world_size > pol.min_workers):
            target = max(pol.min_workers, world_size // 2)
            return _audit(Decision(
                "shrink", target,
                f"idle {now - self._idle_since:.0f}s"))
        return _audit(None)
