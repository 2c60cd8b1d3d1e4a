"""Pool membership, split out from scheduling (counterpart of
``nbdistributed_tpu/gateway/membership.py``).

The scheduler answers "which cell runs next"; this module answers
"which workers exist right now, and under which epoch did each join".
Keeping the two separate is what lets either change at runtime: a
resize rewrites membership while the scheduler merely pauses, and the
scheduler can shed/queue without ever caring that rank 3 is mid-drain.

``PoolMembership`` is pure bookkeeping — no IO, no spawning, no
clock of its own (callers pass ``now``) — so every transition is
unit-testable the way ``SkewDetector`` and the scheduler are.  The
daemon drives it through exactly three moves::

    begin_resize(target, new_epoch)   # all current ranks -> draining
    complete_resize(world, epoch)     # new active set, generation+1
    abort_resize()                    # drain failed: restore active

A resize in this design is an attach-like epoch bump with a re-seeded
mesh (the torch.distributed world and every rank's world_size are fixed
at spawn, so the fleet restarts at the new size under epoch N+1); the
membership record is what makes that visible as a *transition* instead
of a blink — ``%dist_pool status`` renders the generation and each
rank's join-epoch, and a half-completed resize shows ``draining``
ranks rather than dead ones.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

# Rank lifecycle states.  RETIRED records live only in the bounded
# history (describe() shows the live set plus the in-flight drain).
ACTIVE = "active"
DRAINING = "draining"
RETIRED = "retired"

_HISTORY_MAX = 16   # retired epoch-sets kept for postmortems


@dataclass
class RankRecord:
    """One worker's membership row."""
    rank: int
    join_epoch: int
    state: str = ACTIVE
    joined_ts: float = 0.0

    def describe(self) -> dict:
        return {"join_epoch": self.join_epoch, "state": self.state,
                "joined_ts": self.joined_ts}


class PoolMembership:
    """Generation-stamped ownership of the pooled fleet.

    Thread-safe: the daemon mutates it from the resize thread while
    ``status()`` reads it from the listener thread.  The generation
    bumps once per *completed* resize; the per-epoch worker sets
    (``epoch_set``) are what lets a late frame's ``ep`` header be
    explained — "that rank belonged to epoch 2, which retired at
    generation 3".
    """

    def __init__(self, world_size: int = 0, epoch: int = 1, *,
                 now: float = 0.0):
        self._lock = threading.Lock()
        self.generation = 1
        self._epoch = int(epoch)
        self._ranks: dict[int, RankRecord] = {}
        self._transition: dict | None = None
        self._history: list[dict] = []
        if world_size:
            self._install_locked(world_size, epoch, now)

    # -- internals (callers hold self._lock) ---------------------------

    def _install_locked(self, world_size: int, epoch: int,
                        now: float) -> None:
        self._epoch = int(epoch)
        self._ranks = {r: RankRecord(r, int(epoch), ACTIVE, now)
                       for r in range(world_size)}

    # -- transitions ---------------------------------------------------

    def begin_resize(self, target: int, new_epoch: int, *,
                     reason: str = "manual",
                     now: float = 0.0) -> dict:
        """Start a resize: every current rank enters ``draining`` and
        the in-flight transition is recorded (one at a time — a second
        begin while one is open raises, the daemon's resize lock should
        have prevented it)."""
        with self._lock:
            if self._transition is not None:
                raise RuntimeError(
                    f"resize already in flight: {self._transition}")
            for rec in self._ranks.values():
                rec.state = DRAINING
            self._transition = {
                "from_world": len(self._ranks),
                "to_world": int(target),
                "from_epoch": self._epoch,
                "to_epoch": int(new_epoch),
                "reason": reason, "started_ts": now,
            }
            return dict(self._transition)

    def complete_resize(self, world_size: int, epoch: int, *,
                        now: float = 0.0) -> int:
        """The new fleet is up: retire the old epoch-set into history,
        install the new active set, bump the generation.  Returns the
        new generation."""
        with self._lock:
            if self._ranks:
                self._history.append({
                    "epoch": self._epoch,
                    "generation": self.generation,
                    "ranks": sorted(self._ranks),
                    "retired_ts": now,
                })
                del self._history[:-_HISTORY_MAX]
            self._install_locked(world_size, epoch, now)
            self._transition = None
            self.generation += 1
            return self.generation

    def abort_resize(self) -> None:
        """Drain failed or the respawn never came up: the old fleet is
        still the fleet."""
        with self._lock:
            for rec in self._ranks.values():
                if rec.state == DRAINING:
                    rec.state = ACTIVE
            self._transition = None

    # -- views ---------------------------------------------------------

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._transition is not None

    def transition(self) -> dict | None:
        with self._lock:
            return dict(self._transition) if self._transition else None

    def rank_state(self, rank: int) -> str | None:
        with self._lock:
            rec = self._ranks.get(rank)
            return rec.state if rec else None

    def active_ranks(self) -> list[int]:
        with self._lock:
            return sorted(r for r, rec in self._ranks.items()
                          if rec.state == ACTIVE)

    def epoch_set(self, epoch: int) -> list[int]:
        """The worker set that served ``epoch`` (current or retired);
        empty when unknown."""
        with self._lock:
            if epoch == self._epoch:
                return sorted(self._ranks)
            for h in reversed(self._history):
                if h["epoch"] == epoch:
                    return list(h["ranks"])
            return []

    def describe(self) -> dict:
        """The ``%dist_pool status`` membership block."""
        with self._lock:
            return {
                "generation": self.generation,
                "epoch": self._epoch,
                "transition": (dict(self._transition)
                               if self._transition else None),
                "ranks": {str(r): rec.describe()
                          for r, rec in sorted(self._ranks.items())},
                "retired_epochs": [h["epoch"] for h in self._history],
            }
