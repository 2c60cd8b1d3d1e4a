"""The gateway daemon: one pooled worker fleet, N tenant kernels
(counterpart of ``nbdistributed_tpu/gateway/daemon.py``).

``GatewayDaemon`` is a headless coordinator.  It owns the workers the
way ``%dist_init`` does — a :class:`CommunicationManager` (wired with
the pool's bounded :class:`~.scheduler.Scheduler` policy) plus a
:class:`ProcessManager` — and opens a SECOND listener, the *tenant
plane*, speaking the same authenticated codec the workers do.
Notebook kernels dial it as tenants (:class:`~.client.TenantClient`,
``%dist_attach --tenant``); their cells are admitted by the
:class:`~.tenancy.TenantRegistry`, scheduled by the shared
``Scheduler``, executed tenant-tagged on the mesh, and their replies
routed back — or, when the tenant kernel has crashed, parked in that
tenant's own mailbox partition for exactly-once redelivery on
reattach.

Robustness contract (what the chaos tests pin):

- a tenant connection death detaches the tenant but destroys nothing:
  queued and in-flight cells finish, results park, the tenant name +
  token + epoch survive for ``%dist_attach --tenant``;
- a reattach bumps the tenant epoch, so the dead kernel's old
  connection (were it to twitch again) is fenced with ``stale_epoch``
  — the durable session's stale-coordinator fence, scoped to one
  tenant;
- admission control is explicit: a full pool refuses the hello, a
  tenant at its in-flight cap gets ``{"status": "rejected"}``, a busy
  mesh replies ``{"status": "queued", "position": n}`` instead of
  silently blocking, and overload sheds the lowest-priority queued
  cell with a visible ``{"status": "shed"}`` verdict — the mesh never
  wedges behind one tenant's flood.

The daemon also writes a **gateway manifest** (``gateway.json`` under
the run dir, next to the workers' ``session.json``): the tenant-plane
endpoint + pool token a kernel needs to attach, the per-tenant
token/epoch table a *crashed* kernel's successor reads to reattach by
name, and the daemon pid that ``gc_runs`` probes so a live pool's run
dir is never swept.

A port rank owns one GPU (``manager/topology.py``) and NCCL refuses two
ranks of one communicator on one device, so a ``gpu`` pool never holds
more ranks than the host has cards: a start or a resize past them is
refused before anything is spawned or torn down.  The serving plane
(``serve_*`` frames, :class:`~.serving.ServingManager`) runs a tenant's
generation requests on the pool's ranks, and the router's migration
plane (``tenant_export``/``tenant_import``/``tenant_release``) moves a
tenant, with its serving journal, to another pool.

Run it as ``python -m nbdistributed_tpu_torch.gateway.daemon -n 4`` or via
``tools/nbd_torch_gateway.py`` / ``%dist_pool start``.  Its device is the
GPU unless ``--backend cpu`` asks for gloo on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time

from ..observability import flightrec
from ..observability import metrics as obs_metrics
from ..resilience import session as session_mod
from ..utils import knobs
from .membership import PoolMembership
from .scheduler import CellRejected, CellShed, SchedPolicy, Scheduler
from .tenancy import TenantRegistry, TenantRejected

GATEWAY_MANIFEST_NAME = "gateway.json"

# Documented exemptions for the blocking-call-under-lock self-lint
# (analysis/concur.py; the JAX package's table, site for site).  The
# manifest lock EXISTS to serialize the manifest's file IO between the
# writer thread and close(): it guards
# nothing else, is never nested under the hot ``_lock``, and moving
# the IO outside it would reopen the torn-.tmp race it closes.
_LINT_BLOCKING_OK = {
    "GatewayDaemon._write_manifest_sync:open-write":
        "the manifest lock serializes exactly this write against "
        "close()'s removal; it is a cold-path IO lock, never taken "
        "on the park/claim/serve plane",
    "GatewayDaemon._write_manifest_sync:json.dump":
        "same manifest-IO serialization as open-write above",
    "GatewayDaemon._write_manifest_sync:os.replace":
        "the atomic-publish os.replace must happen inside the same "
        "critical section as the .tmp write, or two publishers can "
        "replace each other's torn file",
    # The resize lock EXISTS to serialize whole drain-barrier resizes
    # (minutes of teardown + respawn): overlapping resizes would race
    # two fleets onto one control port.  It is a cold-path admin lock,
    # never taken on the park/claim/serve plane, and never nested
    # under the hot _lock.
    "GatewayDaemon.resize:wait":
        "the drain barrier's bounded wait is the resize's phase 1; "
        "the resize lock must span it or a second resize could flip "
        "the fleet mid-drain",
    "GatewayDaemon.resize:join":
        "fleet teardown (pm.quiesce) is phase 2 of the serialized "
        "resize — same cold-path admin lock",
    "GatewayDaemon.resize:post":
        "the graceful shutdown broadcast to the draining fleet is "
        "part of the serialized flip",
    "GatewayDaemon.resize:time.sleep":
        "the settle sleeps (shutdown drain, stale-EOF drain) are "
        "part of the serialized flip",
    "GatewayDaemon.resize:request":
        "pm.shutdown's host-agent requests are part of the "
        "serialized flip",
    "GatewayDaemon.resize:send_to_ranks":
        "template replay warms the NEW fleet before the scheduler "
        "resumes — running it outside the resize lock would let a "
        "second resize tear the fleet down mid-warm",
}

# The world-reset abort path fails stale pendings (firing their
# on_done callbacks) while the resize lock is held: those callbacks
# are the latency observatory's stage stamps and the serve threads'
# wakeups — none re-enter the daemon's resize path.
_LINT_CALLBACK_OK = {
    "GatewayDaemon.resize:cb":
        "reset_world's pending-abort callbacks (latency stamps, "
        "ticket wakeups) never re-enter the resize plane; deferring "
        "them would leave serve threads parked until after the flip "
        "— exactly the hang the abort exists to prevent",
}


def gpu_refusal(backend: str, world_size: int) -> str | None:
    """Why a ``gpu`` pool of ``world_size`` ranks cannot run on this
    host, or None.  A port rank owns one GPU and NCCL refuses two ranks
    of one communicator on one device, so the pool holds at most one
    rank a card (the JAX pool's worker owns all its chips instead)."""
    if backend != "gpu":
        return None
    from ..manager import topology
    have = topology.available_gpus()
    if have < 1:
        return ("no CUDA GPU on this host: pass backend='cpu' to run "
                "the pool's ranks on the CPU (gloo)")
    if world_size > have:
        return (f"a gpu pool runs one rank a GPU and this host has "
                f"{have}: {world_size} ranks refused")
    return None

# Tenant-plane request types a connection may send BEFORE its
# tenant_hello: status probes and the admin plane need no tenant slot
# (the transport-level pool token already authenticated the peer; the
# mutating ones re-prove the pool token in their payload, like
# pool_shutdown always has).  pool_resize/pool_template are the
# elastic-pool controls; tenant_export/import/release are the router's
# migration plane.
_PRE_HELLO = frozenset({"tenant_hello", "pool_status", "pool_shutdown",
                        "pool_resize", "pool_template",
                        "tenant_export", "tenant_import",
                        "tenant_release"})

# Serving-plane request types, served off-listener like
# execute/mailbox: submit journals to disk, start dispatches a model
# spec, and none of that may stall other tenants' frames.
_SERVE_TYPES = frozenset({"serve_start", "serve_stop", "serve_status",
                          "serve_submit", "serve_result",
                          "serve_stream"})


def gateway_manifest_path(run_dir: str) -> str:
    return os.path.join(run_dir, GATEWAY_MANIFEST_NAME)


def read_gateway_manifest(run_dir: str) -> dict | None:
    """The run dir's gateway manifest, or None (missing/torn — same
    lenient contract as :func:`~..resilience.session.read_manifest`)."""
    try:
        with open(gateway_manifest_path(run_dir)) as f:
            m = json.load(f)
    except (OSError, ValueError):
        return None
    return m if isinstance(m, dict) else None


def gateway_alive(manifest: dict | None) -> bool:
    """True when the manifest's daemon pid is a live process — the
    ``gc_runs`` liveness probe that keeps a pooled fleet's run dir."""
    if not manifest:
        return False
    try:
        pid = int(manifest.get("pid") or 0)
    except (TypeError, ValueError):
        return False
    return bool(pid) and session_mod.pid_alive(pid)


def discover_gateway(run_dir: str | None = None) -> str | None:
    """Best pool to attach to when the caller names none: the env run
    dir if it holds a live gateway manifest, else the newest live one
    under the runs root — the ``discover_run_dir`` analog."""
    if run_dir:
        return run_dir if read_gateway_manifest(run_dir) else None
    env = knobs.get_str("NBD_RUN_DIR")
    if env and gateway_alive(read_gateway_manifest(env)):
        return env
    root = session_mod.default_runs_root()
    best: tuple[float, str] | None = None
    try:
        names = os.listdir(root)
    except OSError:
        return None
    for name in names:
        d = os.path.join(root, name)
        m = read_gateway_manifest(d)
        if not gateway_alive(m):
            continue
        ts = m.get("updated_ts") or m.get("created_ts") or 0.0
        if best is None or ts > best[0]:
            best = (ts, d)
    return best[1] if best else None


class GatewayDaemon:
    """Owns the pooled fleet and serves the tenant plane.

    Constructing it spawns (and waits for) the workers; ``close()``
    tears everything down and removes the manifests.  All tenant-plane
    callbacks run on the listener's IO thread and must not block —
    ``execute`` is served on its own thread per request (bounded by
    the scheduler's admission control, which is the point).
    """

    def __init__(self, world_size: int, *, backend: str = "gpu",
                 host: str = "127.0.0.1", tenant_port: int = 0,
                 policy: SchedPolicy | None = None,
                 max_tenants: int | None = None,
                 request_timeout: float | None = None,
                 attach_timeout: float = 180.0,
                 pool_token: str | None = None,
                 watchdog: bool = True,
                 metrics_port: int | None = None):
        from ..manager import ProcessManager, wait_until_ready
        from ..manager import topology
        from ..messaging import CommunicationManager

        # "auto" is the GPU, raising on a host without one: the CPU
        # runs only when the caller asks for it.
        if backend == "auto":
            backend = topology.detect_backend()
        refusal = gpu_refusal(backend, world_size)
        if refusal:
            raise RuntimeError(refusal)
        self.policy = policy or SchedPolicy.pool_from_env()
        if max_tenants is None:
            max_tenants = knobs.get_int("NBD_POOL_MAX_TENANTS", 8)
        self.registry = TenantRegistry(max_tenants=max_tenants)
        # The pool token authenticates the tenant plane (transport
        # preamble digest) and authorizes pool_shutdown.  Kernels read
        # it from the gateway manifest — same-filesystem trust, like
        # the session manifest's auth_token.
        self.pool_token = pool_token or session_mod.mint_token()
        self.request_timeout = request_timeout
        self._lock = threading.Lock()   # mailbox park/claim + serving
        # Manifest publishing gets its OWN lock: it serializes two
        # writers sharing one .tmp path, and file IO under the hot
        # _lock would stall every park/claim/serve-count behind disk.
        self._manifest_lock = threading.Lock()
        self._manifest_dirty = threading.Event()
        self._closed = threading.Event()    # set AFTER teardown done
        # Per-tenant count of execute serve threads between spawn and
        # their post-_deliver exit.  Eviction consults it: the
        # scheduler marks a cell complete BEFORE _deliver parks its
        # reply, so "scheduler idle + mailbox empty" alone can evict
        # a tenant whose result is mid-park and lose it.
        self._serving: dict[str, int] = {}
        # The serving plane: one ServingManager per daemon, created by
        # serve_start.  Plain rebinds under _lock.
        self._serve_mgr = None
        self._close_lock = threading.Lock()
        self._close_started = False
        # One process, one black box: the CommunicationManager created
        # below re-inits the process-global recorder as "coordinator"
        # (the name postmortem bundles recover), CLOSING any recorder
        # opened before it.  A separate init("gateway") here used to be
        # silently dead after that — every daemon record dropped — so
        # the daemon binds to the comm's live recorder instead (below).
        self.flight = flightrec.init("gateway")
        self.run_dir = flightrec.run_dir()

        # Elastic pools: membership — who owns which ranks,
        # generation-stamped — is split from scheduling so both can
        # change at runtime.  A resize is an attach-like epoch bump:
        # session_epoch advances, the old epoch's frames fence on the
        # existing ``ep`` header, and membership records which rank
        # set belonged to which epoch for late-frame forensics.
        self.membership = PoolMembership(world_size, epoch=1,
                                         now=time.time())
        self.session_epoch = 1
        self._resize_lock = threading.Lock()   # one resize at a time
        self._backend = backend
        self._attach_timeout = attach_timeout
        # Template namespaces: admin-registered cells re-run on every
        # epoch's fresh fleet so resized-in workers start warm.
        self._templates: dict[str, str] = {}
        self._autoscaler = None
        self._autoscale_stop = threading.Event()
        self._autoscale_thread = None

        session_token = session_mod.mint_token()
        self._session_token = session_token
        self.comm = CommunicationManager(
            num_workers=world_size, timeout=request_timeout,
            session_token=session_token, session_epoch=1,
            scheduler=Scheduler(self.policy))
        # See the note above: the comm's "coordinator" ring is the
        # live one now; record into it so resize/autoscale/tenant
        # events actually persist and reach postmortem bundles.
        self.flight = self.comm.flight
        self.pm = ProcessManager()
        self.pm.add_death_callback(
            lambda r, rc: self.comm.mark_worker_dead(r))
        try:
            self.pm.start_workers(
                world_size, self.comm.port, backend=backend,
                extra_env=self._worker_env(1))
            wait_until_ready(self.comm, self.pm, attach_timeout)
            self.comm.set_output_callback(self._on_stream)
            self.world_size = world_size

            # Workers' session manifest: the fleet outlives this
            # daemon exactly like a single-kernel fleet outlives its
            # kernel — a future coordinator (or replacement gateway)
            # can adopt it.
            try:
                session_mod.write_manifest(
                    self.run_dir, session_mod.make_manifest(
                        world_size=world_size,
                        control_host="127.0.0.1",
                        control_port=self.comm.port,
                        token=session_token, epoch=1,
                        pids={r: p.pid
                              for r, p in self.pm.processes.items()},
                        backend=self.pm.backend,
                        dist_port=self.pm.dist_port))
            except OSError:
                pass

            # Tenant plane: same listener class + codec as the worker
            # plane, authenticated with the pool token.  Inside the
            # same guard as the spawn: a bad --tenant-port must not
            # orphan the already-running fleet.
            from ..messaging.native import make_listener
            self._tenants_listener = make_listener(
                host=host, port=tenant_port,
                auth_token=self.pool_token)
            self._tenants_listener.on_message = self._on_tenant_message
            self._tenants_listener.on_disconnect = self._on_tenant_gone
            self._tenants_listener.start()
        except BaseException:
            # BaseException: a SIGTERM handler raising SystemExit
            # mid-spawn (the %dist_pool start timeout path) must
            # still reap the half-started fleet, same as any error.
            self.pm.shutdown()
            self.comm.shutdown()
            raise
        self.tenant_host = host
        self.tenant_port = self._tenants_listener.port

        # Live scrape endpoint: /metrics, /healthz,
        # /latency.json — token-gated with the pool token, like the
        # admin plane.  Off unless --metrics-port / NBD_METRICS_PORT
        # asks for it; a NEGATIVE port means "bind an ephemeral port"
        # (read it back from the manifest) — callers wanting an
        # OS-assigned port must not pre-claim one and re-bind it, the
        # classic TOCTOU a busy CI box loses.  A requested-but-
        # unbindable port fails the start loudly (a deployment that
        # asked to be scraped must not come up silently unscrapeable),
        # reaping the fleet like any other construction failure.
        self._metrics_httpd = None
        mp = (metrics_port if metrics_port is not None
              else knobs.get_int("NBD_METRICS_PORT", 0))
        if mp:
            from ..observability import httpd as obs_httpd
            try:
                self._metrics_httpd = obs_httpd.start_for_comm(
                    self.comm, port=max(0, mp), host=host,
                    token=self.pool_token,
                    extra_health=self._health_extra,
                    extra_latency=self._latency_extra)
            except BaseException:
                self._tenants_listener.close()
                self.pm.shutdown()
                self.comm.shutdown()
                raise

        # Hang watchdog over the pool: verdicts carry the tenant of
        # the hung cell (pending snapshots are tenant-tagged), so
        # blame lands on the right notebook.
        self._watchdog = None
        if watchdog and knobs.get_bool("NBD_HANG", True):
            try:
                from ..resilience.watchdog import (HangPolicy,
                                                   HangWatchdog)
                self._watchdog = HangWatchdog(
                    HangPolicy.from_env_lenient())
                self._watchdog.attach(self.comm, self.pm)
            except Exception:
                self._watchdog = None

        self.flight.record("gateway_start", world_size=world_size,
                           tenant_port=self.tenant_port,
                           policy=self.policy.describe())
        # First publish is synchronous — READY implies a readable
        # manifest; later republishes go through the writer thread.
        self._write_manifest_sync()
        threading.Thread(target=self._manifest_writer, daemon=True,
                         name="nbd-gw-manifest").start()

    # ------------------------------------------------------------------
    # manifest

    def _write_manifest(self) -> None:
        """Request a manifest publish.  The write itself happens on a
        dedicated writer thread — hello/detach call this from the
        tenant-plane listener IO thread, and json.dump + os.replace
        there stalled every other tenant's frames behind disk on a
        slow runs root."""
        self._manifest_dirty.set()

    def _manifest_writer(self) -> None:
        while True:
            self._manifest_dirty.wait()
            if self._close_started:
                return      # close() removes the manifest; stop here
            self._manifest_dirty.clear()
            self._write_manifest_sync()

    def _write_manifest_sync(self) -> None:
        m = {
            "kind": "gateway",
            "pid": os.getpid(),
            "world_size": self.world_size,
            # Elastic pools: the epoch fences stale frames after a
            # resize, the generation stamps the membership view, and
            # gc_runs keeps a recently-bumped manifest even when the
            # pid probe races a restart (the mid-resize keep-rule).
            "epoch": self.session_epoch,
            "generation": self.membership.generation,
            "membership": self.membership.describe(),
            "tenant_plane": {"host": self.tenant_host,
                             "port": self.tenant_port},
            "pool_token": self.pool_token,
            "policy": self.policy.describe(),
            "max_tenants": self.registry.max_tenants,
            "created_ts": getattr(self, "_created_ts", None)
            or time.time(),
            "updated_ts": time.time(),
            "tenants": self.registry.manifest_block(),
        }
        if self._metrics_httpd is not None:
            # Where to scrape this pool (token = the pool token the
            # manifest already carries).
            m["metrics"] = {"host": self.tenant_host,
                            "port": self._metrics_httpd.port}
        self._created_ts = m["created_ts"]
        path = gateway_manifest_path(self.run_dir)
        tmp = path + ".tmp"
        # Serialized: hello (listener thread) and eviction (its own
        # thread) both publish — two unserialized writers share the
        # one .tmp path and can os.replace torn JSON into place.
        with self._manifest_lock:
            if self._close_started:
                return      # don't resurrect a manifest close removes
            try:
                with open(tmp, "w") as f:
                    json.dump(m, f, indent=1)
                os.replace(tmp, path)
            except OSError:
                pass

    # ------------------------------------------------------------------
    # elastic pools: resize, templates, autoscale

    def _worker_env(self, epoch: int) -> dict:
        # Warm starts need nothing here: every rank of every epoch
        # loads the kernels from the checkout's shared build directory
        # (ops/_build.py), so a resized-in fleet runs no nvcc.
        return {"NBD_SESSION_TOKEN": self._session_token,
                "NBD_SESSION_EPOCH": str(epoch)}

    def resize(self, target: int, *, reason: str = "manual") -> dict:
        """Change the pool's world size: a two-phase drain barrier
        followed by an attach-like epoch bump with a re-seeded fleet.

        Phase 1 (drain): the scheduler stops promoting (queued cells
        HOLD — they are not lost, their serve threads stay parked on
        their tickets), the serving driver parks between ticks, and
        we wait — bounded by ``NBD_RESIZE_DRAIN_TIMEOUT_S`` — for
        in-flight cells to finish.  Phase 2 (flip): the old fleet is
        torn down, the coordinator's world is reset under
        ``epoch+1``, and a fresh fleet spawns against the SAME
        control port; it loads the kernels already built, and template
        replay warms its namespaces.  Anything still in flight past the drain
        timeout is aborted with an explicit WorkerDied verdict (the
        tenant sees an error reply, never a hang), and any frame the
        old fleet emits afterwards is fenced by the ``ep`` header —
        the same stale-epoch fence a durable-session reattach uses.

        Stated limit: tenant worker namespaces do not survive the
        flip (the processes die).  Tenant identity, mailboxes, queued
        cells, and the serve journal all do; namespaces are lazily
        re-seeded by the next cell, which template replay makes
        cheap.

        A ``gpu`` pool never grows past the host's cards (one GPU a
        rank): such a target is refused here, before the drain, and
        the pool keeps serving at its old size."""
        from ..manager import wait_until_ready
        target = int(target)
        if target < 1:
            return {"status": "error",
                    "error": f"cannot resize to {target} workers"}
        refusal = gpu_refusal(self._backend, target)
        if refusal:
            self.flight.record("resize_refused", target=target,
                               error=refusal)
            return {"status": "error", "error": refusal}
        reg = obs_metrics.registry()
        with self._resize_lock:
            if self._close_started:
                return {"status": "error",
                        "error": "gateway is shutting down"}
            if target == self.world_size:
                return {"status": "noop",
                        "world_size": self.world_size,
                        "epoch": self.session_epoch}
            new_epoch = self.session_epoch + 1
            t0 = time.monotonic()
            plan = self.membership.begin_resize(
                target, new_epoch, reason=reason, now=time.time())
            self.flight.record("resize_begin", **plan)
            self._write_manifest()   # publish the DRAINING view early
            # Phase 1: drain barrier.
            self.comm.scheduler.pause(f"resize:{reason}")
            mgr = self._serve_mgr
            if mgr is not None:
                mgr.pause(timeout=30.0)
            deadline = time.monotonic() + knobs.get_float(
                "NBD_RESIZE_DRAIN_TIMEOUT_S", 120.0)
            drained = False
            while time.monotonic() < deadline:
                if self.comm.scheduler.active_count() == 0:
                    drained = True
                    break
                if self._closed.wait(0.25):
                    break
            drain_s = time.monotonic() - t0
            self.flight.record("resize_drained", drained=drained,
                               drain_s=round(drain_s, 3))
            # Phase 2: flip the fleet under the new epoch.
            wd, self._watchdog = self._watchdog, None
            if wd is not None:
                try:
                    # A draining fleet must never be blamed as hung.
                    wd.stop()
                except Exception:
                    pass
            try:
                self.pm.quiesce()
                try:
                    self.comm.post(self.comm.connected_ranks(),
                                   "shutdown")
                    time.sleep(0.3)
                except Exception:
                    pass
                self.pm.shutdown()
                # Let the old sockets' disconnect events finish
                # draining before the world resets, so a stale EOF
                # can't mark a NEW rank dead.
                time.sleep(0.5)
                self.comm.reset_world(target, new_epoch)
                self.pm.start_workers(
                    target, self.comm.port, backend=self._backend,
                    extra_env=self._worker_env(new_epoch))
                wait_until_ready(self.comm, self.pm,
                                 self._attach_timeout)
            except Exception as e:
                # The old fleet is gone and the new one failed: this
                # pool is down, not half-up.  Leave membership in its
                # draining state (status shows the stuck transition),
                # resume the scheduler so queued work fails loudly
                # instead of waiting forever, and report.
                reg.counter("nbd_pool_resizes_total",
                            "pool resizes by outcome",
                            {"outcome": "failed"}).inc()
                self.flight.record("resize_failed", target=target,
                                   error=f"{type(e).__name__}: {e}")
                self.comm.scheduler.resume()
                return {"status": "error",
                        "error": f"resize to {target} failed mid-"
                                 f"flip: {type(e).__name__}: {e} — "
                                 f"the pool needs a restart"}
            self.session_epoch = new_epoch
            self.world_size = target
            gen = self.membership.complete_resize(target, new_epoch,
                                                  now=time.time())
            # Republish both manifests BEFORE resuming: a gc or a
            # reattach racing the flip must see the new epoch.
            try:
                session_mod.write_manifest(
                    self.run_dir, session_mod.make_manifest(
                        world_size=target, control_host="127.0.0.1",
                        control_port=self.comm.port,
                        token=self._session_token, epoch=new_epoch,
                        pids={r: p.pid
                              for r, p in self.pm.processes.items()},
                        backend=self.pm.backend,
                        dist_port=self.pm.dist_port))
            except OSError:
                pass
            self._write_manifest()
            if wd is not None and knobs.get_bool("NBD_HANG", True):
                try:
                    from ..resilience.watchdog import (HangPolicy,
                                                       HangWatchdog)
                    self._watchdog = HangWatchdog(
                        HangPolicy.from_env_lenient())
                    self._watchdog.attach(self.comm, self.pm)
                except Exception:
                    self._watchdog = None
            # Resume the scheduler BEFORE template replay and the
            # serving re-seed: both run ordinary ``execute`` cells,
            # which admission would otherwise queue against the still-
            # paused scheduler — a self-inflicted drain barrier that
            # stalls the resize for the cells' full timeout.  The
            # serving driver itself stays parked (its own pause flag)
            # until resume_after_resize below, so no decode tick can
            # race the re-seed.
            promoted = self.comm.scheduler.resume()
            self._replay_templates()
            if mgr is not None:
                mgr.resume_after_resize(target)
            wall_s = time.monotonic() - t0
            a = self._autoscaler
            if a is not None:
                a.note_resized(time.time())
            reg.counter("nbd_pool_resizes_total",
                        "pool resizes by outcome",
                        {"outcome": "grown" if target
                         > plan["from_world"] else "shrunk"}).inc()
            self.flight.record(
                "resize_done", world_size=target, epoch=new_epoch,
                generation=gen, drained=drained,
                drain_s=round(drain_s, 3), wall_s=round(wall_s, 3),
                promoted=promoted, reason=reason)
            return {"status": "resized", "world_size": target,
                    "epoch": new_epoch, "generation": gen,
                    "drained": drained, "drain_s": round(drain_s, 3),
                    "wall_s": round(wall_s, 3)}

    def _replay_templates(self) -> None:
        """Re-run every registered template cell on the fresh fleet so
        resized-in workers' first real cell finds a warm namespace (and
        the compile cache primed).  Failures are recorded, not raised —
        a broken template must not fail the resize."""
        with self._lock:
            templates = dict(self._templates)
        for name, code in templates.items():
            try:
                ranks = list(range(self.world_size))
                self.comm.send_to_ranks(
                    ranks, "execute",
                    {"code": code, "target_ranks": ranks},
                    tenant=f"_tpl_{name}", timeout=600.0)
                self.flight.record("template_replayed", template=name)
            except Exception as e:
                self.flight.record("template_replay_failed",
                                   template=name,
                                   error=f"{type(e).__name__}: {e}")

    def run_template(self, name: str, code: str) -> dict:
        """Register + run a template cell on all live ranks now."""
        with self._lock:
            self._templates[name] = code
        try:
            live = sorted(set(range(self.world_size))
                          - self.comm.dead_ranks())
            resps = self.comm.send_to_ranks(
                live, "execute", {"code": code, "target_ranks": live},
                tenant=f"_tpl_{name}", timeout=600.0)
            errs = {str(r): (m.data or {}).get("error")
                    for r, m in resps.items()
                    if (m.data or {}).get("error")}
            self.flight.record("template_stored", template=name,
                               errors=len(errs))
            if errs:
                return {"status": "error", "template": name,
                        "errors": errs}
            return {"status": "ok", "template": name, "ranks": live}
        except Exception as e:
            return {"status": "error", "template": name,
                    "error": f"{type(e).__name__}: {e}"}

    def start_autoscale(self, policy=None) -> None:
        """Arm the pressure-driven autoscaler (``--autoscale min:max``
        / ``%dist_pool start --autoscale``)."""
        from ..resilience.autoscaler import (AutoscalePolicy,
                                             PoolAutoscaler)
        self._autoscaler = PoolAutoscaler(policy
                                          or AutoscalePolicy.from_env())
        self.flight.record("autoscale_armed",
                           policy=self._autoscaler.policy.describe())
        self._autoscale_thread = threading.Thread(
            target=self._autoscale_loop, name="nbd-gw-autoscale",
            daemon=True)
        self._autoscale_thread.start()

    def _autoscale_loop(self) -> None:
        a = self._autoscaler
        while not self._autoscale_stop.wait(a.policy.interval_s):
            if self._close_started:
                return
            try:
                sched = self.comm.scheduler.snapshot()
                backlog = 0
                mgr = self._serve_mgr
                if mgr is not None:
                    d = mgr.describe()
                    backlog = (int(d.get("pending") or 0)
                               + int(d.get("decoding") or 0))
                summ = self.comm.lat.summary()
                p95_ms = ((summ.get("stages") or {}).get("queue")
                          or {}).get("p95", 0)
                decision = a.observe(
                    time.time(), world_size=self.world_size,
                    queued=int(sched.get("queued") or 0),
                    active=int(sched.get("active") or 0),
                    backlog=backlog,
                    queue_p95_s=float(p95_ms) / 1000.0)
                if decision is None:
                    continue
                # Full audit record on the flight ring:
                # the pressure inputs and sustain/cooldown state that
                # drove the verdict, not just the verdict — this is
                # what postmortem bundles carry.
                self.flight.record("autoscale_decision",
                                   action=decision.action,
                                   target=decision.target,
                                   reason=decision.reason,
                                   **({"audit": decision.record}
                                      if decision.record else {}))
                obs_metrics.registry().counter(
                    "nbd_autoscale_decisions_total",
                    "autoscaler grow/shrink decisions",
                    {"action": decision.action}).inc()
                self.resize(decision.target,
                            reason=f"autoscale: {decision.reason}")
                # resize() already ran note_resized on success; run it
                # here too so a FAILED resize still opens the cooldown
                # instead of retrying a wedged flip at poll frequency.
                a.note_resized(time.time())
            except Exception as e:
                self.flight.record("autoscale_error",
                                   error=f"{type(e).__name__}: {e}")

    # ------------------------------------------------------------------
    # tenant plane (listener IO thread — keep fast, never block)

    def _send_to_client(self, client_id: int, msg) -> bool:
        from ..messaging.transport import TransportError
        try:
            self._tenants_listener.send_to_rank(client_id, msg)
            return True
        except TransportError:
            return False

    def _on_tenant_gone(self, client_id: int) -> None:
        t = self.registry.detach_client(client_id)
        if t is not None:
            self.flight.record("tenant_detached", tenant=t.name)
            obs_metrics.registry().counter(
                "nbd_tenant_detaches_total",
                "tenant detaches by kind (clean = explicit goodbye, "
                "lost = connection dropped: kernel crash or exit)",
                {"tenant": t.name, "kind": "lost"}).inc()
            self._write_manifest()

    def _on_tenant_message(self, client_id: int, msg) -> None:
        mt = msg.msg_type
        tenant = self.registry.by_client(client_id)
        if tenant is None and mt not in _PRE_HELLO:
            self._send_to_client(client_id, msg.reply(
                data={"error": "no tenant_hello on this connection"}))
            return
        if tenant is not None and self.registry.fence(tenant,
                                                      msg.epoch):
            # A reattach bumped this tenant's epoch: the old kernel's
            # connection is fenced exactly like a stale coordinator.
            obs_metrics.registry().counter(
                "nbd_tenant_epoch_rejected_total",
                "frames rejected from a stale tenant epoch",
                {"tenant": tenant.name}).inc()
            self.flight.record("tenant_epoch_rejected",
                               tenant=tenant.name, frame_epoch=msg.epoch,
                               epoch=tenant.epoch)
            self._send_to_client(client_id, msg.reply(
                data={"error": f"stale tenant epoch {msg.epoch} "
                               f"(this tenant reattached at epoch "
                               f"{tenant.epoch}); request ignored",
                      "stale_epoch": True}))
            return
        if mt == "tenant_hello":
            self._handle_hello(client_id, msg)
        elif mt == "execute":
            # Counted HERE (listener thread, before detach can be
            # processed on this connection) — not in the serve thread,
            # which may not have started when a detach lands.
            with self._lock:
                self._serving[tenant.name] = self._serving.get(
                    tenant.name, 0) + 1
            threading.Thread(target=self._serve_execute,
                             args=(tenant, msg, client_id),
                             name=f"nbd-gw-{tenant.name}",
                             daemon=True).start()
        elif mt in _SERVE_TYPES:
            # Off the listener thread (submit journals to disk, start
            # runs a model-spec cell); counted like execute so a
            # detach cannot evict the tenant mid-request.
            with self._lock:
                self._serving[tenant.name] = self._serving.get(
                    tenant.name, 0) + 1
            threading.Thread(target=self._serve_plane,
                             args=(tenant, msg, client_id),
                             name=f"nbd-gw-srv-{tenant.name}",
                             daemon=True).start()
        elif mt == "mailbox":
            # Off the listener thread: a drain reply carries up to the
            # whole mailbox (32 MB in-memory bound; oversized parked
            # results live in the tenant's run-dir spill partition and
            # are materialized per claim) and a slow
            # client's full socket buffer would block sendall —
            # wedging every other tenant's hellos/executes/detaches
            # behind it.  Counted
            # here (listener thread) like execute so a detach can't
            # evict the tenant while its claimed results are mid-send.
            with self._lock:
                self._serving[tenant.name] = self._serving.get(
                    tenant.name, 0) + 1
            threading.Thread(target=self._serve_mailbox,
                             args=(tenant, msg, client_id),
                             name=f"nbd-gw-mb-{tenant.name}",
                             daemon=True).start()
        elif mt == "pool_status":
            self._send_to_client(client_id, msg.reply(
                data=self.status()))
        elif mt == "detach":
            t = self.registry.detach_client(client_id)
            evicted = False
            if t is not None:
                # A clean goodbye with nothing parked and nothing in
                # flight frees the tenant's admission slot; anything
                # recoverable keeps the slot for reattach.
                with self._lock:
                    serving = self._serving.get(t.name, 0)
                if (serving == 0 and len(t.mailbox) == 0
                        and self.comm.scheduler.tenant_idle(t.name)):
                    # Eviction runs on its own thread AFTER the
                    # worker-namespace GC broadcast: until the evict
                    # lands, a new same-name hello is refused (wrong
                    # token against the still-registered tenant), so
                    # the late tenant_gc frame can never delete a NEW
                    # tenant's freshly created namespace.  Off the
                    # listener thread: send_to_ranks blocks.
                    evicted = True
                    threading.Thread(
                        target=self._evict_after_gc,
                        args=(t.name,), daemon=True,
                        name=f"nbd-gw-gc-{t.name}").start()
                self.flight.record("tenant_detached", tenant=t.name,
                                   clean=True, evicted=evicted)
                obs_metrics.registry().counter(
                    "nbd_tenant_detaches_total",
                    "tenant detaches by kind (clean = explicit "
                    "goodbye, lost = connection dropped: kernel "
                    "crash or exit)",
                    {"tenant": t.name, "kind": "clean"}).inc()
                self._write_manifest()
            self._send_to_client(client_id, msg.reply(
                data={"status": "detached", "evicted": evicted}))
        elif mt == "pool_shutdown":
            if (msg.data or {}).get("token") != self.pool_token:
                self._send_to_client(client_id, msg.reply(
                    data={"error": "pool token mismatch"}))
                return
            self._send_to_client(client_id, msg.reply(
                data={"status": "stopping"}))
            # Off-thread: close() joins the listener's IO thread —
            # the very thread running this callback.
            threading.Thread(target=self.close,
                             name="nbd-gw-stop", daemon=True).start()
        elif mt == "pool_resize":
            data = msg.data or {}
            if data.get("token") != self.pool_token:
                self._send_to_client(client_id, msg.reply(
                    data={"error": "pool token mismatch"}))
                return
            try:
                target = int(data.get("workers"))
            except (TypeError, ValueError):
                self._send_to_client(client_id, msg.reply(
                    data={"error": "pool_resize needs workers: int"}))
                return
            reason = str(data.get("reason") or "manual")

            def _do_resize():
                try:
                    out = self.resize(target, reason=reason)
                except Exception as e:
                    out = {"status": "error",
                           "error": f"{type(e).__name__}: {e}"}
                self._send_to_client(client_id, msg.reply(data=out))

            # Off the listener thread: a resize blocks for the whole
            # drain + respawn (minutes) and the listener must keep
            # serving other tenants' frames meanwhile.
            threading.Thread(target=_do_resize, name="nbd-gw-resize",
                             daemon=True).start()
        elif mt == "pool_template":
            data = msg.data or {}
            if data.get("token") != self.pool_token:
                self._send_to_client(client_id, msg.reply(
                    data={"error": "pool token mismatch"}))
                return
            code = data.get("code")
            if not isinstance(code, str) or not code.strip():
                with self._lock:
                    names = sorted(self._templates)
                self._send_to_client(client_id, msg.reply(
                    data={"status": "ok", "templates": names}))
                return
            tpl = str(data.get("name") or "default")

            def _do_template():
                self._send_to_client(client_id, msg.reply(
                    data=self.run_template(tpl, code)))

            threading.Thread(target=_do_template,
                             name="nbd-gw-template",
                             daemon=True).start()
        elif mt == "tenant_export":
            data = msg.data or {}
            if data.get("token") != self.pool_token:
                self._send_to_client(client_id, msg.reply(
                    data={"error": "pool token mismatch"}))
                return
            name = str(data.get("tenant") or "")
            snap = self.registry.export_tenant(name)
            if snap is None:
                self._send_to_client(client_id, msg.reply(
                    data={"error": f"no tenant {name!r} in this "
                                   "pool"}))
                return
            # The tenant's serving history rides along: its lines are
            # filtered out of every serving journal under the run dir
            # (a serving plane's journal interleaves all submitters),
            # and the destination's serving plane re-admits the
            # unfinished ones.
            from .serving import export_tenant_journal
            journal = export_tenant_journal(self.run_dir, name)
            if journal:
                snap["serve_journal"] = journal
            self.flight.record("tenant_exported", tenant=name,
                               parked=len(snap.get("parked") or {}))
            self._send_to_client(client_id, msg.reply(
                data={"status": "ok", "snapshot": snap}))
        elif mt == "tenant_import":
            data = msg.data or {}
            if data.get("token") != self.pool_token:
                self._send_to_client(client_id, msg.reply(
                    data={"error": "pool token mismatch"}))
                return
            snap = data.get("snapshot")
            if not isinstance(snap, dict):
                self._send_to_client(client_id, msg.reply(
                    data={"error": "tenant_import needs a snapshot"}))
                return
            t, why = self.registry.import_tenant(snap)
            if t is None:
                self._send_to_client(client_id, msg.reply(
                    data={"error": f"tenant_import refused: {why}"}))
                return
            from ..messaging.codec import Message
            with self._lock:
                for mid, d in sorted(
                        (snap.get("parked") or {}).items()):
                    # park() refreshes an existing msg_id in place, so
                    # a router retry re-importing the same snapshot
                    # converges instead of duplicating.
                    t.mailbox.park(mid, Message(
                        msg_type="response", msg_id=mid, data=d))
            journal = snap.get("serve_journal")
            if isinstance(journal, str) and journal:
                from .serving import migrated_journal_path
                jp = migrated_journal_path(self.run_dir, t.name)
                # Staged, not live: this pool's serving plane adopts
                # the stash (re-journal + re-admit) at its next
                # start.  Write-if-absent keeps the import idempotent:
                # a router retry must not clobber a stash the serving
                # plane may be mid-adoption on.
                if not os.path.exists(jp):
                    try:
                        with open(jp, "w") as f:
                            f.write(journal)
                    except OSError:
                        pass
            self.flight.record("tenant_imported", tenant=t.name,
                               epoch=t.epoch,
                               parked=len(snap.get("parked") or {}))
            obs_metrics.registry().counter(
                "nbd_tenant_migrations_total",
                "tenant migrations by direction",
                {"direction": "in"}).inc()
            self._write_manifest()
            self._send_to_client(client_id, msg.reply(
                data={"status": "imported", "tenant": t.name,
                      "epoch": t.epoch,
                      "parked": len(snap.get("parked") or {})}))
        elif mt == "tenant_release":
            data = msg.data or {}
            if data.get("token") != self.pool_token:
                self._send_to_client(client_id, msg.reply(
                    data={"error": "pool token mismatch"}))
                return
            name = str(data.get("tenant") or "")
            ok = self.registry.release(name,
                                       force=bool(data.get("force")))
            if ok:
                self.comm.scheduler.forget_tenant(name)
                obs_metrics.registry().remove_label_series("tenant",
                                                           name)
                obs_metrics.registry().counter(
                    "nbd_tenant_migrations_total",
                    "tenant migrations by direction",
                    {"direction": "out"}).inc()
                self.flight.record("tenant_released", tenant=name)
                self._write_manifest()
            self._send_to_client(client_id, msg.reply(
                data={"status": "released" if ok else "error",
                      **({} if ok else
                         {"error": f"tenant {name!r} not released "
                                   "(unknown, or attached without "
                                   "force)"})}))
        else:
            self._send_to_client(client_id, msg.reply(
                data={"error": f"unknown tenant-plane request "
                               f"{mt!r}"}))

    def _handle_hello(self, client_id: int, msg) -> None:
        data = msg.data or {}
        name = str(data.get("tenant") or "").strip()
        if not name:
            self._send_to_client(client_id, msg.reply(
                data={"error": "tenant_hello needs a tenant name"}))
            return
        prio = data.get("priority")
        if prio is not None:
            try:
                prio = int(prio)
            except (TypeError, ValueError):
                prio = None   # absent/garbage: keep current priority
        existing = self.registry.by_client(client_id)
        if existing is not None and existing.name != name:
            # One tenant identity per connection: a re-hello under a
            # DIFFERENT name would overwrite the client map while the
            # first tenant's client_id stayed pointing here — forever
            # "attached", unevictable, its slot and namespaces leaked.
            self._send_to_client(client_id, msg.reply(data={
                "error": f"connection already attached as tenant "
                         f"{existing.name!r} — open a new connection "
                         "to attach another tenant",
                "rejected": True}))
            return
        try:
            t, reply = self.registry.hello(
                name, data.get("token"), client_id, priority=prio)
        except TenantRejected as e:
            obs_metrics.registry().counter(
                "nbd_tenant_rejected_total",
                "tenant hellos refused (admission control / bad "
                "token)", {"reason": e.reason.split("=")[0][:32]}).inc()
            self.flight.record("tenant_rejected", tenant=name,
                               reason=e.reason)
            self._send_to_client(client_id, msg.reply(
                data={"error": str(e), "rejected": True}))
            return
        reply["world_size"] = self.world_size
        reply["policy"] = self.policy.describe()
        self.flight.record("tenant_" + reply["status"], tenant=name,
                           epoch=t.epoch)
        obs_metrics.registry().counter(
            "nbd_tenant_attaches_total",
            "tenant hellos accepted",
            {"tenant": name, "kind": reply["status"]}).inc()
        self._send_to_client(client_id, msg.reply(data=reply))
        self._write_manifest()

    def _handle_mailbox(self, client_id: int, tenant, msg) -> None:
        action = (msg.data or {}).get("action", "status")
        if action == "drain":
            with self._lock:
                claimed = tenant.mailbox.claim_all()
            try:
                ok = self._send_to_client(client_id, msg.reply(
                    data={"status": "ok",
                          "results": {mid: getattr(r, "data", None)
                                      for mid, r in claimed.items()}}))
            except BaseException:
                # The claim is destructive: a throwing serve thread
                # (reply construction, encode) must repark before
                # unwinding or the results are lost on BOTH sides —
                # the exactly-once contract survives only the
                # explicit ok/not-ok path below without this.
                with self._lock:
                    for mid, r in claimed.items():
                        tenant.mailbox.park(mid, r)
                self.flight.record("tenant_mailbox_reparked",
                                   tenant=tenant.name, n=len(claimed),
                                   reason="serve-thread-raise")
                raise
            if ok:
                self.flight.record("tenant_mailbox_drained",
                                   tenant=tenant.name, n=len(claimed))
            elif claimed:
                # The drain reply never left the gateway: put the
                # results back (oldest first, preserving order) so the
                # claim stays exactly-once instead of silently
                # becoming at-most-once on a dead socket.
                with self._lock:
                    for mid, r in claimed.items():
                        tenant.mailbox.park(mid, r)
                self.flight.record("tenant_mailbox_reparked",
                                   tenant=tenant.name, n=len(claimed))
                # A successor kernel may have attached in the
                # claim/repark window — its hello saw an EMPTY
                # mailbox, so nudge it (the dead drain requester is
                # excluded; no successor, no notice).
                self._notify_parked(tenant, exclude_cid=client_id)
            return
        with self._lock:
            parked = tenant.mailbox.ids()
            counters = tenant.mailbox.counters()
        self._send_to_client(client_id, msg.reply(
            data={"status": "ok", "parked": parked,
                  "counters": counters}))

    # ------------------------------------------------------------------
    # cell routing (one thread per in-flight tenant request)

    def _serve_done(self, name: str) -> None:
        """Release one serve-counter slot (incremented on the
        listener thread before the serve thread spawned)."""
        with self._lock:
            n = self._serving.get(name, 1) - 1
            if n <= 0:
                self._serving.pop(name, None)
            else:
                self._serving[name] = n

    def _serve_mailbox(self, tenant, msg, client_id: int) -> None:
        try:
            self._handle_mailbox(client_id, tenant, msg)
        finally:
            # Held until the claimed results are sent or REPARKED —
            # a clean detach racing the drain must not evict the
            # tenant while its mailbox claim is in flight.
            self._serve_done(tenant.name)

    def _serve_execute(self, tenant, msg, submit_cid: int) -> None:
        try:
            self._serve_execute_inner(tenant, msg, submit_cid)
        finally:
            # Decremented only after _deliver has sent or PARKED the
            # reply — until then the tenant must not be evictable.
            self._serve_done(tenant.name)

    def _classify_effects(self, code, tenant) -> str:
        """The cell's effects-admission class for the scheduler
        (``free`` / ``bearing`` / ``unknown``), counted in
        ``nbd_effects_{proven,unknown}_total`` and remembered in the
        preflight store.  Only called when ``policy.effects`` is on;
        anything the analyzer cannot read is ``unknown`` — the gate
        must never promote on a guess.

        Session soundness: a proof is only per-cell if the ambient
        names it leans on (``np``, ``time``, builtins…) still denote
        their modules.  A tenant cell that rebinds one poisons the
        assumption for that tenant's LATER cells
        (``tenant.ns_unsafe``, fed by ``ambient_poison``) — without
        this, ``np = weird; np.x(y)`` across two cells would be
        falsely proven free.  The read-classify-poison of
        ``tenant.ns_unsafe`` happens in ONE ``tenant.ns_lock`` section
        so that concurrent serve threads of the same tenant
        (mesh_slots > 1 with an async client) always classify against
        the latest recorded poison, never a stale snapshot — scoped
        per tenant so a big cell's analysis never stalls the
        daemon-wide ``self._lock`` plane."""
        reg = obs_metrics.registry()

        def count(cls):
            if cls == "unknown":
                reg.counter(
                    "nbd_effects_unknown_total",
                    "cells whose collective footprint the effect "
                    "analyzer could not prove (opaque or "
                    "tainted)").inc()
            else:
                reg.counter(
                    "nbd_effects_proven_total",
                    "cells with a proven collective footprint",
                    {"footprint": cls}).inc()
            return cls

        if not isinstance(code, str):
            return count("unknown")
        try:
            from ..analysis import effects as effects_mod
            from ..analysis import preflight
            with tenant.ns_lock:
                # Read-classify-poison atomically: a sibling serve
                # thread's just-recorded rebind must be visible to
                # this classification (the analyzer is pure CPU on a
                # small cell, so the hold is short).
                rep = effects_mod.infer_effects(
                    code, assume_unsafe=tenant.ns_unsafe)
                cls = effects_mod.collective_class(rep)
                poison = effects_mod.ambient_poison(rep)
                if poison:
                    tenant.ns_unsafe = tenant.ns_unsafe | poison
            from ..runtime.collective_guard import cell_hash
            preflight.note_effects(cell_hash(code), rep)
        except Exception:
            return count("unknown")
        return count(cls)

    def _serve_execute_inner(self, tenant, msg,
                             submit_cid: int) -> None:
        name = tenant.name
        mgr = self._serve_mgr
        if mgr is not None and name == mgr.tenant:
            # Serving-tenant mode: a cell queued behind the decode
            # loop would wait forever (the driver ticks continuously)
            # and could clobber the DecodeServer's params mid-decode.
            # Refuse with the serving front door named instead.
            obs_metrics.registry().counter(
                "nbd_tenant_cells_total",
                "tenant cells by terminal status",
                {"tenant": name, "status": "rejected"}).inc()
            self._deliver(tenant, msg.reply(data={
                "status": "rejected", "reason": "serving-tenant",
                "error": f"tenant {name!r} is the serving plane's "
                         "tenant — %%distributed cells cannot run "
                         "behind its decode loop; submit generation "
                         "requests with %dist_serve submit, or "
                         "attach under a different tenant name"}),
                submit_cid)
            return
        with self._lock:
            # Serve threads of the SAME tenant run concurrently when
            # mesh_slots > 1: the counter bumps are read-modify-writes.
            tenant.cells_submitted += 1
        tenant.last_seen = time.time()
        data = msg.data if isinstance(msg.data, dict) else {
            "code": msg.data}
        ranks = data.get("target_ranks")
        if not isinstance(ranks, list) or not ranks or not all(
                isinstance(r, int) and 0 <= r < self.world_size
                for r in ranks):
            ranks = list(range(self.world_size))
            data = dict(data)
            data["target_ranks"] = ranks
        try:
            prio = int(data.get("priority", tenant.priority))
        except (TypeError, ValueError):
            prio = tenant.priority
        reg = obs_metrics.registry()
        # Effects classification is the gateway's pre-submit analysis —
        # the latency observatory's "vet" stage; measured here because
        # only this layer knows how long it took.
        vet_s = None
        if self.policy.effects:
            t_vet = time.monotonic()
            eff_cls = self._classify_effects(data.get("code"), tenant)
            vet_s = time.monotonic() - t_vet
        else:
            eff_cls = "unknown"

        def on_verdict(ticket):
            v = ticket.verdict
            if v.get("status") == "queued":
                # The explicit backpressure reply: the kernel learns
                # its position instead of silently blocking.
                reg.counter("nbd_tenant_queued_total",
                            "tenant cells that waited in the pool "
                            "queue", {"tenant": name}).inc()
                reason = v.get("reason")
                if reason:
                    # Effects admission held the cell while slots were
                    # free: proof-gated serialization, named.
                    reg.counter(
                        "nbd_effects_serialized_total",
                        "cells serialized by effects admission "
                        "(unproven overlap)", {"tenant": name}).inc()
                    self.flight.record("effects_serialized",
                                       tenant=name, msg_id=msg.msg_id,
                                       reason=reason)
                # Only the SUBMITTING connection understands this
                # msg_id; after a reattach the notice is just noise.
                if tenant.client_id == submit_cid:
                    notice = {"status": "queued",
                              "position": v.get("position"),
                              "msg_id": msg.msg_id}
                    if reason:
                        notice["reason"] = reason
                    self._send_to_client(submit_cid, msg.reply(
                        msg_type="queued", data=notice))

        status = "ok"
        try:
            resps = self.comm.send_to_ranks(
                ranks, "execute", data, tenant=name, priority=prio,
                msg_id=msg.msg_id, on_verdict=on_verdict,
                collective=eff_cls, vet_s=vet_s,
                timeout=self.request_timeout)
            results = {str(r): m.data for r, m in resps.items()}
            if any(isinstance(d, dict) and d.get("error")
                   for d in results.values()):
                status = "error"
            reply = msg.reply(data={"status": status,
                                    "results": results})
        except CellShed:
            status = "shed"
            reg.counter("nbd_tenant_shed_total",
                        "tenant cells shed under overload",
                        {"tenant": name}).inc()
            reply = msg.reply(data={
                "status": "shed", "reason": "overload",
                "error": "cell shed under overload: the pool queue "
                         "was full and this was the lowest-priority "
                         "queued cell — retry, or raise priority"})
        except CellRejected as e:
            status = "rejected"
            reply = msg.reply(data={
                "status": "rejected", "reason": e.reason,
                "error": f"cell rejected: {e.reason} — wait for "
                         f"in-flight cells to finish"})
        except Exception as e:
            status = "error"
            reply = msg.reply(data={"status": "error",
                                    "error": f"{type(e).__name__}: "
                                             f"{e}"})
        if status == "ok":
            with self._lock:
                tenant.cells_done += 1
        elif status == "error":
            with self._lock:
                tenant.cells_failed += 1
        reg.counter("nbd_tenant_cells_total",
                    "tenant cells by terminal status",
                    {"tenant": name, "status": status}).inc()
        self._deliver(tenant, reply, submit_cid)

    # ------------------------------------------------------------------
    # serving plane

    def _serve_plane(self, tenant, msg, client_id: int) -> None:
        """Dispatch one serve_* request (its own thread).  Replies go
        straight to the requesting connection — a dead requester's
        SUBMIT still stands (the request is journaled and will decode;
        its terminal result parks), only the verdict frame is lost."""
        try:
            data = msg.data if isinstance(msg.data, dict) else {}
            mt = msg.msg_type
            if mt == "serve_start":
                reply = self._serve_start(tenant, data)
            else:
                mgr = self._serve_mgr
                if mgr is None:
                    reply = {"status": "off",
                             "error": "no serving plane is running "
                                      "(start one: %dist_serve start)"}
                elif mt == "serve_submit":
                    reply = mgr.submit(
                        tenant.name, data.get("prompt") or (),
                        int(data.get("max_new_tokens") or 0),
                        priority=int(data["priority"])
                        if data.get("priority") is not None
                        else tenant.priority)
                elif mt == "serve_result":
                    reply = mgr.result(str(data.get("rid")))
                elif mt == "serve_stream":
                    reply = mgr.stream(str(data.get("rid")),
                                       int(data.get("from") or 0))
                elif mt == "serve_status":
                    reply = {"status": "serving", **mgr.describe()}
                else:  # serve_stop
                    with self._lock:
                        self._serve_mgr = None
                    mgr.stop()
                    self.flight.record("serving_stopped",
                                       tenant=mgr.tenant,
                                       by=tenant.name)
                    reply = {"status": "stopped", **mgr.describe()}
        except Exception as e:
            reply = {"status": "error",
                     "error": f"{type(e).__name__}: {e}"}
        finally:
            # The decrement must be unconditional (its siblings
            # _serve_execute/_serve_mailbox do the same): a reply that
            # fails to encode/send must not leak a _serving slot and
            # make the tenant unevictable forever.
            try:
                self._send_to_client(client_id, msg.reply(data=reply))
            finally:
                self._serve_done(tenant.name)

    def _serve_start(self, tenant, data: dict) -> dict:
        from .serving import ServingManager
        name = str(data.get("tenant") or "serve").strip() or "serve"
        if self.registry.get(name) is not None:
            return {"status": "error",
                    "error": f"tenant name {name!r} is in use by an "
                             f"attached tenant — pick another serving "
                             f"tenant name"}
        # Constructed OUTSIDE the lock (it opens the journal file);
        # the claim below is the race arbiter.
        mgr = ServingManager(
            self.comm, self.run_dir, tenant=name,
            params_name=data.get("params") or "params",
            cfg_name=data.get("cfg") or "cfg",
            spec=data.get("spec"),
            max_batch=data.get("max_batch"),
            max_len=data.get("max_len"),
            pad_to=int(data.get("pad_to") or 16),
            eos_id=data.get("eos_id"),
            temperature=float(data.get("temperature") or 0.0),
            steps=data.get("steps"),
            queue_depth=data.get("queue_depth"),
            inflight=data.get("inflight"),
            world_size=self.world_size,
            decode_ranks=data.get("decode_ranks"),
            kv_block_tokens=data.get("kv_block_tokens"),
            kv_blocks=data.get("kv_blocks"),
            prefill_chunk=data.get("prefill_chunk"),
            kv_quantized=bool(data.get("kv_quantized")),
            deliver=self._serve_deliver,
            notify=self._serve_notify, flight=self.flight)
        with self._lock:
            if self._serve_mgr is not None:
                loser = True
            else:
                loser = False
                self._serve_mgr = mgr
        if loser:
            mgr.journal.close()
            return {"status": "already-serving",
                    "error": "a serving plane is already running — "
                             "%dist_serve stop first"}
        try:
            mgr.start()
        except Exception as e:
            with self._lock:
                self._serve_mgr = None
            try:
                mgr.stop(close_workers=False)
            except Exception:
                pass
            return {"status": "error",
                    "error": f"serve_start failed: {e}"}
        self.flight.record("serving_started", tenant=name,
                           by=tenant.name)
        return {"status": "serving", **mgr.describe()}

    def _serve_deliver(self, tenant_name: str, reply) -> None:
        """Terminal serving results ride the tenant mailbox
        discipline: delivered to the live kernel or parked for
        exactly-once redelivery on reattach."""
        t = self.registry.get(tenant_name)
        if t is None:
            # Submitter evicted mid-generation: the journal still
            # holds the stream; only the push is droppable.
            self.flight.record("serve_result_dropped",
                               tenant=tenant_name,
                               msg_id=reply.msg_id)
            return
        self._deliver(t, reply)

    def _serve_notify(self, tenant_name: str, msg) -> None:
        t = self.registry.get(tenant_name)
        if t is None or t.client_id is None:
            return
        self._send_to_client(t.client_id, msg)

    def _gc_tenant_ns(self, name: str) -> bool:
        """Drop a departed tenant's per-worker namespaces from every
        LIVE rank — a dead worker's process took its namespace dicts
        with it, and targeting it would make send_to_ranks raise
        BEFORE transmitting to anyone.  Returns True only when every
        live rank confirmed the drop; a failure is flight-recorded so
        a stale-namespace postmortem has the evidence."""
        try:
            live = sorted(set(range(self.world_size))
                          - self.comm.dead_ranks())
            if live:
                self.comm.send_to_ranks(live, "tenant_gc",
                                        {"tenant": name}, timeout=30.0)
            self.flight.record("tenant_ns_gc", tenant=name,
                               ranks=live)
            return True
        except Exception as e:
            self.flight.record("tenant_ns_gc_failed", tenant=name,
                               error=f"{type(e).__name__}: {e}")
            return False

    def _evict_after_gc(self, name: str) -> None:
        """GC first, THEN free the admission slot.  The registry
        refuses a tokenless same-name hello while the departed tenant
        is still registered, so ordering the evict after the gc
        broadcast is what makes the gc unable to race a new tenant's
        first cell.  If the tenant reattached in the gap (old token),
        evict refuses and the slot — though not the namespace, which
        a clean goodbye forfeits — survives.

        The gc broadcast RETRIES with backoff: a busy mesh (one long
        cell on a serial worker loop) times the one-shot send out,
        and giving up there leaked the admission slot and the
        namespaces for the daemon's lifetime — max_tenants refusals
        against an empty pool after enough name rotations.  Retrying
        stops when the tenant reattaches (the namespace is live
        again — deleting it would wipe a running session) or the
        daemon closes; a still-failing mesh after the retry window is
        flight-recorded and keeps the slot (the stated-limit trade:
        a leaked slot over a leaked namespace handed to a stranger)."""
        delay, deadline = 2.0, time.time() + 1800.0
        while True:
            # Liveness check BEFORE every broadcast attempt, not just
            # after a failure: a tenant that reattached while this
            # thread was still being scheduled must not have its gc
            # land on a session that is live again.  (A reattach in
            # the check→send gap is safe: the per-worker control
            # channel is serial, so the reattached kernel's first
            # cell — which lazily rebuilds the namespace — is
            # processed AFTER this gc frame.)
            t = self.registry.get(name)
            if t is None or t.client_id is not None:
                return          # gone, or reattached: namespace live
            if self._gc_tenant_ns(name):
                break
            if time.time() >= deadline:
                self.flight.record("tenant_gc_abandoned", tenant=name)
                return          # slot survives; documented trade
            if self._closed.wait(delay):
                return          # daemon tearing down
            delay = min(delay * 2, 60.0)
        t = self.registry.get(name)
        if t is None or t.client_id is not None or len(t.mailbox) \
                or not self.comm.scheduler.tenant_idle(name):
            # The tenant came back during the gc window — and possibly
            # crashed AGAIN with parked work (reattach + crash fits in
            # a 30 s broadcast stall behind a busy mesh).  Evicting now
            # would destroy the mailbox and the session token the next
            # reattach needs; its clean goodbye, when it comes, will
            # run its own eviction.
            return
        if self.registry.evict(name):
            self.comm.scheduler.forget_tenant(name)
            # Metrics hygiene: an evicted tenant's per-tenant label
            # series would otherwise accumulate one set per name for
            # the daemon's lifetime.  Serve-plane series are keyed by
            # the SERVING tenant's name, so they survive.
            dropped = obs_metrics.registry().remove_label_series(
                "tenant", name)
            # getattr: unit tests drive this path on skeletal daemons
            # built with __new__ (no serving plane constructed).
            mgr = getattr(self, "_serve_mgr", None)
            if mgr is not None:
                mgr.forget_tenant(name)
            self.flight.record("tenant_evicted", tenant=name,
                               metric_series_dropped=dropped)
            self._write_manifest()

    def _deliver(self, tenant, reply, submit_cid: int | None = None) -> None:
        """Route a terminal reply to the tenant's live connection, or
        park it in the tenant's mailbox partition for exactly-once
        redelivery on reattach.

        When the tenant reattached WHILE the cell was in flight, the
        live connection is a NEW kernel with no waiter for this
        msg_id — a successful send there would be silently dropped
        client-side and the result lost forever.  Park instead: the
        reattached kernel's next mailbox drain redelivers it.

        Stated limit: a successful socket write counts as delivered.
        A kernel SIGKILLed after the OS accepts the bytes but before
        the user sees them loses that one reply — closing the window
        needs an app-level ack protocol, and the single-kernel orphan
        path accepts the same window by design (README "Tenant
        fencing & crash isolation")."""
        cid = tenant.client_id
        if (cid is not None
                and (submit_cid is None or cid == submit_cid)
                and self._send_to_client(cid, reply)):
            return
        with self._lock:
            tenant.mailbox.park(reply.msg_id, reply)
            tenant.parked_total += 1
        obs_metrics.registry().counter(
            "nbd_tenant_parked_total",
            "tenant replies parked for redelivery (kernel was gone "
            "when the cell finished)", {"tenant": tenant.name}).inc()
        self.flight.record("tenant_result_parked", tenant=tenant.name,
                           msg_id=reply.msg_id)
        if submit_cid is not None:
            # Parked BECAUSE the tenant reattached mid-cell: the new
            # kernel's hello listed the mailbox BEFORE this park, so
            # without a nudge nothing would ever drain it (and an
            # errored cell's traceback travels only in this reply).
            self._notify_parked(tenant, exclude_cid=submit_cid)

    def _notify_parked(self, tenant, *, exclude_cid=None) -> None:
        """Nudge the tenant's LIVE connection that its mailbox gained
        results its hello never listed — without the notice nothing
        drains them until another attach.  ``exclude_cid`` is the
        connection whose death/supersession caused the park (sending
        there is pointless).  Best effort: a lost notice just leaves
        the results claimable on the next attach."""
        cid = tenant.client_id
        if cid is None or cid == exclude_cid:
            return
        from ..messaging.codec import Message
        self._send_to_client(cid, Message(
            msg_type="parked_notice",
            data={"tenant": tenant.name}))

    def _on_stream(self, rank: int, data: dict) -> None:
        """Worker stream output: tenant-tagged prints route to the one
        kernel whose cell produced them; untagged output (gateway-
        internal probes) is dropped."""
        name = (data or {}).get("tenant")
        if not name:
            return
        t = self.registry.get(name)
        if t is None or t.client_id is None:
            return
        from ..messaging.codec import Message
        self._send_to_client(t.client_id, Message(
            msg_type="stream_output", rank=rank, data=data))

    # ------------------------------------------------------------------

    def _health_extra(self) -> dict:
        """Gateway block of the /healthz payload."""
        sched = self.comm.scheduler.snapshot()
        return {"kind": "gateway",
                "tenants": len(self.registry.describe().get("tenants")
                               or {}),
                "queued": sched.get("queued", 0),
                "active": sched.get("active", 0),
                "serving": self._serve_mgr is not None}

    def _latency_extra(self) -> dict:
        """Serving block of the /latency.json payload: the serving
        observatory's stage summary + utilization ring."""
        mgr = self._serve_mgr
        if mgr is None:
            return {}
        return {"serving": mgr.obs.status_block()}

    def status(self) -> dict:
        """The ``%dist_pool status`` payload: scheduler counters,
        tenant table, and a per-rank busy view (tenant-attributed)
        assembled from heartbeat pings — renders even mid-cell."""
        sched = self.comm.scheduler.snapshot()
        now = time.time()
        ranks = {}
        connected = self.comm.connected_ranks()
        for r in range(self.world_size):
            ping = self.comm.last_ping(r)
            row = {"alive": r in connected}
            if ping is not None:
                row["hb_age_s"] = round(now - ping[0], 1)
                if ping[1].get("busy_s") is not None:
                    row["busy_type"] = ping[1].get("busy_type")
                    row["busy_s"] = round(
                        ping[1]["busy_s"] + (now - ping[0]), 1)
                    row["tenant"] = ping[1].get("busy_tenant")
                if ping[1].get("srv") is not None:
                    # Serving telemetry piggyback: tokens/s and
                    # KV-slot occupancy for the %dist_top columns.
                    row["srv"] = ping[1]["srv"]
            ranks[str(r)] = row
        wd = None
        if self._watchdog is not None:
            wd = [dict(v) for v in self._watchdog.last_verdicts]
        a = self._autoscaler
        out = {"status": "ok", "run_dir": self.run_dir,
               "pid": os.getpid(), "world_size": self.world_size,
               "epoch": self.session_epoch,
               "membership": self.membership.describe(),
               "autoscale": (a.policy.describe()
                             if a is not None else None),
               # Decision audit ring: %dist_pool status
               # --autoscale renders these.
               "autoscale_decisions": (a.decisions(32)
                                       if a is not None else None),
               "scheduler": sched,
               "tenants": self.registry.describe(),
               "ranks": ranks, "hang_verdicts": wd,
               # Stage-attribution view: %dist_lat in
               # tenant mode reads this — the observatory lives in
               # THIS process, not the kernel's.
               "latency": self.comm.lat.status_block()}
        if self._metrics_httpd is not None:
            out["metrics_port"] = self._metrics_httpd.port
        mgr = self._serve_mgr
        if mgr is not None:
            out["serving"] = mgr.describe()
        return out

    def close(self) -> None:
        with self._close_lock:
            started, self._close_started = self._close_started, True
        self._manifest_dirty.set()      # release the writer thread
        if started:
            # Another thread owns the teardown; block until it is DONE
            # (not merely begun) so main() can't exit the process with
            # pooled workers still alive behind a half-run shutdown.
            self._closed.wait(timeout=30.0)
            return
        self.flight.record("gateway_stop")
        self._autoscale_stop.set()
        mgr = self._serve_mgr
        if mgr is not None:
            # Before the fleet teardown: the driver thread must stop
            # ticking (and flush its journal) while workers can still
            # answer the serve_close broadcast.
            try:
                mgr.stop()
            except Exception:
                pass
            self._serve_mgr = None
        if self._watchdog is not None:
            try:
                self._watchdog.stop()
            except Exception:
                pass
        if self._metrics_httpd is not None:
            try:
                self._metrics_httpd.close()
            except Exception:
                pass
        try:
            self._tenants_listener.close()
        except Exception:
            pass
        self.pm.quiesce()
        try:
            self.comm.post(self.comm.connected_ranks(), "shutdown")
            time.sleep(0.3)
        except Exception:
            pass
        try:
            self.comm.shutdown()
        except Exception:
            pass
        try:
            self.pm.shutdown()
        except Exception:
            pass
        # Under _manifest_lock: a writer-thread publish that passed
        # its _close_started check before we set the flag must not
        # os.replace a manifest back into place after these removals
        # (with pid reuse, a resurrected gateway.json reads as a LIVE
        # pool and attaches/gc target a daemon that no longer exists).
        with self._manifest_lock:
            for p in (gateway_manifest_path(self.run_dir),
                      session_mod.manifest_path(self.run_dir)):
                try:
                    os.remove(p)
                except OSError:
                    pass
        self._closed.set()

    def wait(self) -> None:
        """Block until ``close()`` (pool_shutdown or a signal)."""
        self._closed.wait()


# ----------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description="nbdistributed_tpu_torch session gateway daemon")
    p.add_argument("-n", "--workers", type=int, default=2)
    p.add_argument("--backend", default="gpu",
                   choices=["auto", "cpu", "gpu"],
                   help="gpu (default): one GPU a rank over NCCL, at most "
                        "one rank a card; cpu: gloo; auto: the GPU, "
                        "raising on a host without one")
    p.add_argument("--host", default="127.0.0.1",
                   help="tenant-plane bind host")
    p.add_argument("--tenant-port", type=int, default=0)
    p.add_argument("--run-dir", default=None,
                   help="run directory (default: NBD_RUN_DIR, else "
                        "minted under the runs root)")
    p.add_argument("--max-tenants", type=int, default=None)
    p.add_argument("--sched", default=None, choices=[None, "fifo",
                                                     "fair"])
    p.add_argument("--mesh-slots", type=int, default=None)
    p.add_argument("--queue-depth", type=int, default=None)
    p.add_argument("--tenant-inflight", type=int, default=None)
    p.add_argument("--effects", action="store_true", default=None,
                   help="effects-aware admission: with mesh slots > 1 "
                        "only cells proven collective-free may "
                        "overlap a collective-bearing cell "
                        "(NBD_POOL_SCHED_EFFECTS)")
    p.add_argument("--request-timeout", type=float, default=None)
    p.add_argument("--attach-timeout", type=float, default=180.0)
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve GET /metrics (Prometheus), /healthz "
                        "and /latency.json on this port, token-gated "
                        "with the pool token (default: "
                        "NBD_METRICS_PORT; 0 = off; negative = bind "
                        "an ephemeral port, read it back from the "
                        "manifest's metrics block)")
    p.add_argument("--autoscale", default=None, metavar="MIN:MAX",
                   help="arm the pressure-driven autoscaler with this "
                        "worker band (thresholds from the "
                        "NBD_AUTOSCALE_* knobs); the pool grows and "
                        "shrinks itself via drain-barrier resizes")
    args = p.parse_args(argv)

    autoscale_policy = None
    if args.autoscale:
        from ..resilience.autoscaler import AutoscalePolicy
        try:
            lo, _, hi = args.autoscale.partition(":")
            autoscale_policy = AutoscalePolicy.from_env()
            autoscale_policy.min_workers = max(1, int(lo))
            autoscale_policy.max_workers = max(
                autoscale_policy.min_workers, int(hi or lo))
        except ValueError:
            p.error(f"--autoscale wants MIN:MAX, got "
                    f"{args.autoscale!r}")

    if args.run_dir:
        os.environ["NBD_RUN_DIR"] = args.run_dir
    policy = SchedPolicy.pool_from_env()
    if args.sched:
        policy.mode = args.sched
    if args.mesh_slots is not None:
        policy.mesh_slots = max(0, args.mesh_slots)
    if args.queue_depth is not None:
        policy.queue_depth = max(0, args.queue_depth)
    if args.tenant_inflight is not None:
        policy.tenant_inflight = max(0, args.tenant_inflight)
    if args.effects:
        policy.effects = True

    # Handlers BEFORE construction: spawning the workers is exactly
    # the window where a fleet exists but no handler did — a SIGTERM
    # there (the %dist_pool start readiness-timeout path) used to die
    # with the default action and orphan the half-started workers.
    state: dict = {"gw": None}

    def _on_signal(signum, _frame):
        gw = state["gw"]
        if gw is not None:
            gw.close()
        else:
            # Mid-construction: raise through __init__, whose
            # BaseException guard reaps anything already spawned.
            raise SystemExit(128 + signum)

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _on_signal)
        except ValueError:
            pass  # not the main thread (in-process embedding)
    try:
        state["gw"] = gw = GatewayDaemon(
            args.workers, backend=args.backend, host=args.host,
            tenant_port=args.tenant_port, policy=policy,
            max_tenants=args.max_tenants,
            request_timeout=args.request_timeout,
            attach_timeout=args.attach_timeout,
            metrics_port=args.metrics_port)
        if autoscale_policy is not None:
            gw.start_autoscale(autoscale_policy)
        print(f"NBD_GATEWAY_READY run_dir={gw.run_dir} "
              f"port={gw.tenant_port} world={gw.world_size}"
              + (f" metrics={gw._metrics_httpd.port}"
                 if gw._metrics_httpd is not None else ""),
              flush=True)
        gw.wait()
    finally:
        if state["gw"] is not None:
            state["gw"].close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
