"""Session gateway: N notebook kernels sharing one pooled worker fleet
(counterpart of ``nbdistributed_tpu/gateway/__init__.py``).

A :class:`~.daemon.GatewayDaemon` owns the GPU ranks and a second,
tenant-facing listener over the same authenticated codec; notebook
kernels attach as *tenants* (:class:`~.client.TenantClient`,
``%dist_attach --tenant``), and their cells are admitted, queued, and
scheduled onto the mesh by the :class:`~.scheduler.Scheduler` — the
same object the single-kernel path routes through inside
``CommunicationManager.send_to_ranks``.  Per-tenant session tokens and
epochs (:mod:`~.tenancy`) fence a stale or crashed tenant, a crashed
tenant's in-flight results park in its own mailbox partition for
exactly-once redelivery on reattach, and overload sheds the
lowest-priority queued cells with a visible verdict.  The serving
plane (``serving``) runs continuous-batching generation for a tenant,
and ``router`` moves a tenant with its serving journal between pools.
"""

from .scheduler import (CellRejected, CellShed, SchedPolicy,  # noqa: F401
                        Scheduler, Ticket)
from .tenancy import Tenant, TenantRegistry  # noqa: F401

# daemon/client are lazy (PEP 562): the coordinator imports
# .scheduler at startup, and daemon.py imports the coordinator back —
# an eager import here would be a cycle.  They also pull in the
# manager/transport stack, which scheduler-only consumers (every
# single-kernel session) should not pay for.
_LAZY = {
    "GatewayDaemon": "daemon", "read_gateway_manifest": "daemon",
    "gateway_manifest_path": "daemon", "gateway_alive": "daemon",
    "discover_gateway": "daemon", "GATEWAY_MANIFEST_NAME": "daemon",
    "TenantClient": "client", "CellSubmitError": "client",
    "GatewayGone": "client", "TenantFenced": "client",
    "pool_status_probe": "client", "pool_shutdown": "client",
    "ServingManager": "serving", "ServeJournal": "serving",
    "merge_emission": "serving", "journal_path": "serving",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)
