"""Multi-pool routing and chaos-safe tenant migration (counterpart of
``nbdistributed_tpu/gateway/router.py``).

A machine (or a shared runs root) can host several gateway pools.
:class:`PoolDirectory` discovers them the way ``discover_gateway``
finds one — gateway manifests under the runs root, pid-probed for
liveness — then probes each for load so :meth:`PoolDirectory.place`
can put a new tenant on the least-loaded pool.

:func:`migrate_tenant` moves a tenant between pools using the durable
primitives that already carry it across crashes: the export/import/
release admin plane (``tenancy.export_tenant`` et al.) plus the
serving journal.  The sequence is crash-ordered —

1. **export** at the source (non-destructive: parked results stay
   parked there, the serve journal is read, nothing is consumed);
2. **import** at the destination (idempotent: a retry converges,
   epochs only ever ratchet up);
3. **release** at the source (the only destructive step, last).

A death at any point leaves a recoverable state: before (3) the
tenant simply still lives at the source; after (3) it lives at the
destination.  Exactly-once delivery of parked results holds because
the kernel's destructive mailbox drain only ever runs against ONE
pool — the one its reattach lands on — and release removes the
source's copy before the manifest advertises the move.

When the source pool was SIGKILLed mid-migration (the chaos case),
the live export path is impossible — so the fallback reads what the
dead pool durably published: the tenant's token/epoch from its
on-disk gateway manifest and the serve journal from its run dir.
Parked results that lived only in the dead daemon's memory die with
it, exactly as they would have without a migration in flight; every
journaled serving request survives and re-admits at the destination.
"""

from __future__ import annotations

import os

from ..observability import metrics as obs_metrics
from ..resilience import session as session_mod
from . import client as client_mod
from .daemon import gateway_alive, read_gateway_manifest
from .serving import export_tenant_journal


class MigrationError(RuntimeError):
    pass


class PoolDirectory:
    """Discovery + placement over every live pool under a runs root.

    Stateless between calls (the manifests on disk ARE the state), so
    a router crash loses nothing — construct a fresh one and re-scan.
    """

    def __init__(self, runs_root: str | None = None):
        self.runs_root = runs_root or session_mod.default_runs_root()

    def discover(self) -> dict[str, dict]:
        """``{run_dir: manifest}`` for every live gateway under the
        root.  Dead manifests (stale pid) are skipped, not raised —
        a half-torn-down pool must not break placement for the rest."""
        out: dict[str, dict] = {}
        try:
            names = os.listdir(self.runs_root)
        except OSError:
            return out
        for name in sorted(names):
            d = os.path.join(self.runs_root, name)
            m = read_gateway_manifest(d)
            if gateway_alive(m):
                out[d] = m
        return out

    def probe(self, manifest: dict, *,
              timeout: float = 10.0) -> dict | None:
        """Live load snapshot of one pool (its ``pool_status``
        payload), or None when it stopped answering — discovery's pid
        probe can race a shutdown."""
        tp = manifest.get("tenant_plane") or {}
        try:
            return client_mod.pool_status_probe(
                tp.get("host") or "127.0.0.1", int(tp.get("port")),
                manifest.get("pool_token"), timeout=timeout)
        except Exception:
            return None

    @staticmethod
    def load_score(manifest: dict, status: dict | None) -> float:
        """Smaller is better: tenants per admission slot, plus the
        scheduler's queue pressure when the pool answered its probe."""
        tenants = len(manifest.get("tenants") or {})
        slots = max(1, int(manifest.get("max_tenants") or 1))
        score = tenants / slots
        if status:
            sched = status.get("scheduler") or {}
            score += (int(sched.get("queued") or 0)
                      + int(sched.get("active") or 0)) / 10.0
        return score

    def place(self, *, exclude: str | None = None,
              timeout: float = 10.0) -> tuple[str, dict] | None:
        """The least-loaded live pool ``(run_dir, manifest)`` — where
        a new (or migrating) tenant should land.  ``exclude`` drops
        the source pool from consideration."""
        best: tuple[float, str, dict] | None = None
        for d, m in self.discover().items():
            if exclude and os.path.abspath(d) == os.path.abspath(
                    exclude):
                continue
            score = self.load_score(m, self.probe(m, timeout=timeout))
            if best is None or score < best[0]:
                best = (score, d, m)
        return (best[1], best[2]) if best else None


def _dead_pool_snapshot(src_dir: str, tenant: str) -> dict:
    """Rebuild a migration snapshot from what a SIGKILLed source pool
    durably published: its gateway manifest's tenants block (token +
    epoch — the same record a reattaching kernel would use) and the
    tenant's on-disk serve journal."""
    m = read_gateway_manifest(src_dir)
    rec = ((m or {}).get("tenants") or {}).get(tenant)
    if not isinstance(rec, dict) or not rec.get("token"):
        raise MigrationError(
            f"tenant {tenant!r} is not recorded in the dead pool's "
            f"manifest at {src_dir} — nothing durable to migrate")
    snap: dict = {"tenant": tenant, "token": rec["token"],
                  "epoch": rec.get("epoch") or 1}
    journal = export_tenant_journal(src_dir, tenant)
    if journal:
        snap["serve_journal"] = journal
    return snap


def migrate_tenant(tenant: str, src_dir: str, dst_dir: str, *,
                   force: bool = False,
                   timeout: float = 60.0) -> dict:
    """Move ``tenant`` from the pool at ``src_dir`` to the one at
    ``dst_dir``.  Returns a summary dict; raises
    :class:`MigrationError` on refusal.  Safe to re-run after any
    partial failure — every step is idempotent except the final
    release, which is the commit point."""
    if os.path.abspath(src_dir) == os.path.abspath(dst_dir):
        raise MigrationError("source and destination are the same "
                             "pool")
    dst = read_gateway_manifest(dst_dir)
    if not gateway_alive(dst):
        raise MigrationError(f"no live gateway at {dst_dir}")
    src = read_gateway_manifest(src_dir)
    src_alive = gateway_alive(src)

    if src_alive:
        tp = src.get("tenant_plane") or {}
        out = client_mod.tenant_export(
            tp.get("host") or "127.0.0.1", int(tp.get("port")),
            src.get("pool_token"), tenant, timeout=timeout)
        if out.get("error"):
            raise MigrationError(f"export refused: {out['error']}")
        snap = out.get("snapshot") or {}
    else:
        # Chaos path: the source was SIGKILLed.  Its manifest and the
        # serve journal are on disk; memory-only parked results died
        # with the daemon (as they would have with no migration in
        # flight).
        snap = _dead_pool_snapshot(src_dir, tenant)

    dtp = dst.get("tenant_plane") or {}
    out = client_mod.tenant_import(
        dtp.get("host") or "127.0.0.1", int(dtp.get("port")),
        dst.get("pool_token"), snap, timeout=timeout)
    if out.get("error"):
        raise MigrationError(f"import refused: {out['error']}")

    released = False
    if src_alive:
        try:
            rel = client_mod.tenant_release(
                (src.get("tenant_plane") or {}).get("host")
                or "127.0.0.1",
                int((src.get("tenant_plane") or {}).get("port")),
                src.get("pool_token"), tenant, force=force,
                timeout=timeout)
            released = rel.get("status") == "released"
        except Exception:
            # The import already committed; a failed release means
            # the tenant exists at BOTH pools until the source's
            # operator re-runs the migration (idempotent) or the
            # source dies.  The kernel's reattach picks ONE pool, so
            # exactly-once still holds; we surface the state instead
            # of hiding it.
            released = False
    obs_metrics.registry().counter(
        "nbd_tenant_migrations_total",
        "tenant migrations by direction",
        {"direction": "routed"}).inc()
    return {"status": "migrated", "tenant": tenant,
            "src": src_dir, "dst": dst_dir,
            "src_alive": src_alive, "released": released,
            "parked_moved": len(snap.get("parked") or {}),
            "journal_moved": bool(snap.get("serve_journal")),
            "epoch": out.get("epoch")}
