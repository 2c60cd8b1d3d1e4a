"""Tenant identity, fencing, and parked-result partitions (counterpart
of ``nbdistributed_tpu/gateway/tenancy.py``).

Per-tenant reuse of the durable-session machinery: every tenant
gets its own session **token** (minted with
:func:`~nbdistributed_tpu_torch.resilience.session.mint_token`) and its own
monotonically increasing **epoch**.  A tenant kernel that crashes and
reattaches (``%dist_attach --tenant``) proves the token and bumps the
epoch — from then on, frames from the dead kernel's old connection
(stamped with the older epoch) are rejected with ``stale_epoch``,
exactly the stale-coordinator fence, scoped to one tenant.  Results
that finish while a tenant has no live connection park in that
tenant's own
:class:`~nbdistributed_tpu_torch.resilience.dedup.ResultMailbox` partition;
a reattach drains them destructively — exactly once.

The registry is also the **admission** gate for the pool's tenant
count (``max_tenants``): the per-tenant in-flight cap and queue-depth
backpressure live in the :class:`~.scheduler.Scheduler`; the headcount
lives here, at hello time, where a new tenant can be refused before it
costs anything.
"""

from __future__ import annotations

import os
import threading
import time

from ..resilience.dedup import ResultMailbox
from ..resilience.session import mint_token, token_fingerprint


def _tenant_spill_dir(name: str) -> str | None:
    """Run-dir spill partition for one tenant's mailbox (best-effort:
    a gateway without a run dir just keeps the in-memory bound)."""
    try:
        from ..observability import flightrec
        safe = "".join(c for c in name if c.isalnum() or c in "-_")
        return os.path.join(flightrec.run_dir(), f"spill-tenant-{safe}")
    except Exception:
        return None


class TenantRejected(RuntimeError):
    def __init__(self, reason: str, name: str):
        super().__init__(f"tenant {name!r} rejected: {reason}")
        self.reason = reason


class Tenant:
    __slots__ = ("name", "token", "epoch", "client_id", "mailbox",
                 "priority", "admitted_ts", "last_seen", "reattaches",
                 "cells_submitted", "cells_done", "cells_failed",
                 "parked_total", "ns_unsafe", "ns_lock")

    def __init__(self, name: str, token: str, priority: int = 0):
        self.name = name
        self.token = token
        self.epoch = 1
        self.client_id: int | None = None   # live tenant-plane conn
        # This tenant's parked-reply partition.  Shares the bulk-plane
        # spill path: a slow/detached client's oversized
        # results land on disk under the run dir with explicit
        # too_large/disk_full verdicts instead of evicting the
        # tenant's whole 32 MB mailbox.
        self.mailbox = ResultMailbox(spill_dir=_tenant_spill_dir(name))
        self.priority = int(priority)
        # Ambient names (np/time/builtins…) a dispatched cell of THIS
        # tenant rebound: the effect analyzer must not prove a later
        # cell collective-free on the assumption they still denote
        # their modules (analysis/effects.ambient_poison).  ns_lock
        # scopes the read-classify-poison to this tenant, so one
        # tenant's big-cell analysis never stalls the daemon-wide
        # plane.
        self.ns_unsafe: frozenset = frozenset()
        self.ns_lock = threading.Lock()
        self.admitted_ts = time.time()
        self.last_seen = time.time()
        self.reattaches = 0
        self.cells_submitted = 0
        self.cells_done = 0
        self.cells_failed = 0
        self.parked_total = 0

    @property
    def attached(self) -> bool:
        return self.client_id is not None

    def describe(self) -> dict:
        return {"name": self.name,
                "token_fp": token_fingerprint(self.token),
                "epoch": self.epoch,
                "attached": self.attached,
                "priority": self.priority,
                "reattaches": self.reattaches,
                "cells_submitted": self.cells_submitted,
                "cells_done": self.cells_done,
                "cells_failed": self.cells_failed,
                "parked": len(self.mailbox),
                "parked_total": self.parked_total,
                "last_seen_age_s": round(time.time() - self.last_seen,
                                         1)}


class TenantRegistry:
    """Name -> :class:`Tenant`, with the hello/fence state machine."""

    def __init__(self, max_tenants: int = 8):
        self.max_tenants = max(1, int(max_tenants))
        self._lock = threading.Lock()
        self._tenants: dict[str, Tenant] = {}
        self._by_client: dict[int, str] = {}

    # ------------------------------------------------------------------

    def hello(self, name: str, token: str | None, client_id: int, *,
              priority: int | None = None) -> tuple[Tenant, dict]:
        """Admit or reattach a tenant connection.

        - Unknown ``name``: admit (minting a token) unless the pool is
          at ``max_tenants`` — admission control's headcount bound.
        - Known ``name`` + matching token: **reattach** — bump the
          tenant epoch (fencing out the previous connection) and
          rebind the live client id.
        - Known ``name`` + wrong/absent token: rejected — a tenant
          name cannot be hijacked without its session token.

        Returns ``(tenant, reply_data)``; raises
        :class:`TenantRejected` on refusal.
        """
        with self._lock:
            t = self._tenants.get(name)
            if t is None:
                if len(self._tenants) >= self.max_tenants:
                    raise TenantRejected(
                        f"pool is at max_tenants={self.max_tenants}",
                        name)
                t = Tenant(name, token or mint_token(),
                           priority=priority if priority is not None
                           else 0)
                self._tenants[name] = t
                event = "admitted"
            else:
                if token != t.token:
                    raise TenantRejected(
                        "session token mismatch (not this tenant's "
                        "session)", name)
                t.epoch += 1
                t.reattaches += 1
                # A DECLARED priority wins on reattach (`%dist_attach
                # --tenant NAME --priority N` after a crash used to be
                # silently ignored); an OMITTED one (None) keeps the
                # tenant's current value — the argparse default must
                # not demote a priority-5 tenant to 0 on every plain
                # reattach.
                if priority is not None:
                    t.priority = priority
                event = "reattached"
            # The previous connection's client id stays mapped to this
            # tenant ON PURPOSE: its frames must resolve to the tenant
            # so the epoch fence can answer them with an explicit
            # ``stale_epoch`` (not a generic no-hello error).  The
            # mapping dies with the connection (detach_client on EOF).
            t.client_id = client_id
            self._by_client[client_id] = name
            t.last_seen = time.time()
            return t, {"status": event, "tenant": name,
                       "token": t.token, "epoch": t.epoch,
                       "parked": t.mailbox.ids()}

    def fence(self, tenant: Tenant, frame_epoch: int | None) -> bool:
        """True when a frame stamped ``frame_epoch`` is STALE for this
        tenant (an older connection's traffic after a reattach bumped
        the epoch).  Unstamped frames are never fenced — same contract
        as the session-epoch fence."""
        return frame_epoch is not None and frame_epoch < tenant.epoch

    # ------------------------------------------------------------------

    def by_client(self, client_id: int) -> Tenant | None:
        with self._lock:
            name = self._by_client.get(client_id)
            return self._tenants.get(name) if name else None

    def get(self, name: str) -> Tenant | None:
        with self._lock:
            return self._tenants.get(name)

    def detach_client(self, client_id: int) -> Tenant | None:
        """The tenant's connection dropped (kernel crash or exit):
        keep the tenant — its queued/in-flight work and mailbox survive
        for reattach — but stop routing replies to the dead socket.

        Returns the tenant only when this client id WAS its live
        connection; a superseded (fenced) old connection finally
        EOF-ing returns None, so callers never count a reattached
        tenant as detached."""
        with self._lock:
            name = self._by_client.pop(client_id, None)
            t = self._tenants.get(name) if name else None
            if t is not None and t.client_id == client_id:
                t.client_id = None
                return t
            return None

    def evict(self, name: str) -> bool:
        """Forget a DEPARTED tenant outright, freeing its
        ``max_tenants`` slot.  The daemon calls this only on a clean
        detach with an empty mailbox and nothing queued/active —
        without it, a rotation of N distinct tenant names would wedge
        the pool's admission forever.  A crashed tenant (or one with
        parked/in-flight work) keeps its slot for reattach."""
        with self._lock:
            t = self._tenants.get(name)
            if t is None or t.attached:
                return False
            self._by_client = {c: n
                               for c, n in self._by_client.items()
                               if n != name}
            del self._tenants[name]
            return True

    # ------------------------------------------------------------------
    # migration: export/import/release move a tenant's
    # durable identity — token, epoch, priority, parked results —
    # between pools.  Export is non-destructive and import is
    # idempotent, so the sequence survives a router (or source pool)
    # death at any point: re-running it converges.

    def export_tenant(self, name: str) -> dict | None:
        """Snapshot a tenant's durable state for migration.  Parked
        replies travel as ``{msg_id: data}`` — the same shape a
        mailbox drain sends — and stay parked HERE until
        :meth:`release`; exactly-once holds because only one pool's
        mailbox is ever drained by the kernel."""
        with self._lock:
            t = self._tenants.get(name)
            if t is None:
                return None
            return {"tenant": t.name, "token": t.token,
                    "epoch": t.epoch, "priority": t.priority,
                    "reattaches": t.reattaches,
                    "parked": {mid: getattr(r, "data", None)
                               for mid, r in
                               t.mailbox.peek_all().items()}}

    def import_tenant(self, snap: dict) -> tuple[Tenant | None, str]:
        """Adopt an exported tenant.  Idempotent: a re-import of the
        same snapshot (router retry after a crash) merges instead of
        failing — epochs take the max, so the fence never regresses.
        Returns ``(tenant, why)``; tenant is None on refusal."""
        name = str(snap.get("tenant") or "").strip()
        token = snap.get("token")
        if not name or not token:
            return None, "snapshot missing tenant name or token"
        with self._lock:
            t = self._tenants.get(name)
            if t is None:
                if len(self._tenants) >= self.max_tenants:
                    return None, (f"pool is at max_tenants="
                                  f"{self.max_tenants}")
                try:
                    prio = int(snap.get("priority") or 0)
                except (TypeError, ValueError):
                    prio = 0
                t = Tenant(name, str(token), priority=prio)
                self._tenants[name] = t
            elif t.token != token:
                return None, ("tenant name in use with a different "
                              "session token")
            try:
                t.epoch = max(t.epoch, int(snap.get("epoch") or 1))
            except (TypeError, ValueError):
                pass
            return t, "imported"

    def release(self, name: str, *, force: bool = False) -> bool:
        """Forget a tenant whose export was imported elsewhere.
        Unlike :meth:`evict`, parked results do NOT pin the slot —
        the destination pool owns them now.  A live connection does,
        unless ``force``: then the epoch is bumped first so the old
        kernel's frames fence with ``stale_epoch`` instead of
        resolving against a ghost."""
        with self._lock:
            t = self._tenants.get(name)
            if t is None:
                return False
            if t.attached:
                if not force:
                    return False
                t.epoch += 1        # fence the still-live connection
                t.client_id = None
            self._by_client = {c: n
                               for c, n in self._by_client.items()
                               if n != name}
            del self._tenants[name]
            return True

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._tenants)

    def describe(self) -> dict:
        with self._lock:
            return {"max_tenants": self.max_tenants,
                    "tenants": {n: t.describe()
                                for n, t in sorted(
                                    self._tenants.items())}}

    def manifest_block(self) -> dict:
        """The ``tenants`` block of the gateway manifest: enough for a
        local kernel to reattach by name (token + epoch), mirroring
        how ``session.json`` records the single-kernel session token."""
        with self._lock:
            return {n: {"token": t.token, "epoch": t.epoch,
                        "attached": t.attached}
                    for n, t in sorted(self._tenants.items())}
