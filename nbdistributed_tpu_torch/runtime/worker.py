"""Per-rank worker runtime (counterpart of
``nbdistributed_tpu/runtime/worker.py``).

The reference worker (reference: worker.py:72-601) rebuilt on the JAX
package's control plane: one process per GPU, its data plane a
``torch.distributed`` process group (NCCL on the GPU, gloo on the CPU),
and an interactive namespace seeded as the reference seeds it —
``torch``, ``dist``, ``rank``, ``world_size``, ``device``, ``gpu_id``
(reference: worker.py:128-177) — plus the port's functional
collectives and model entry points.

Runs as ``python -m nbdistributed_tpu_torch.runtime.worker --rank R ...``;
spawned and env-configured by :mod:`nbdistributed_tpu_torch.manager`.

Startup order (deliberate, SURVEY §7 "hard parts"):
1. ``RANK``/``LOCAL_RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``,
   ``torch.cuda.set_device(gpu_id)`` on the GPU, then
   ``init_process_group`` — the blocking rendezvous, bounded by
   ``INIT_TIMEOUT_S``, while stdout still goes to the spawner's pipe so
   early failures are capturable (reference: process_manager.py:136-150).
   A world of one gets its group too: ``dist.*`` in a cell needs one;
2. control-plane connect — the HELLO doubles as the readiness signal the
   reference lacked (it slept 2 s instead);
3. serial message loop; a heartbeat thread pings the coordinator so
   liveness is observable even during long cells.

``serve_open`` builds no local tensor-parallel mesh: a rank drives one
GPU, and a mesh spans ranks (``make_mesh`` and ``DecodeServer(mesh=)``
in a cell run on every rank).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import threading
import time
import traceback

from ..messaging import xfer as xfer_mod
from ..messaging.codec import Message
from ..messaging.transport import TransportError, WorkerChannel
from ..observability import flightrec
from ..observability import metrics as obs_metrics
from ..observability import spans as obs_spans
from ..observability import telemetry as obs_telemetry
from ..resilience import faults as faults_mod
from ..resilience.dedup import _READ_ONLY, ReplayCache, ResultMailbox
from ..resilience.faults import FaultPlan
from ..utils import knobs
from . import collective_guard, executor, introspect
from .interrupt import InterruptGate


def _load_hf_pretrained_lazy(name_or_path, **kw):
    """Seeded-namespace shim: defers the ``transformers`` import to the
    first call (workers must start fast)."""
    from ..models.hf import load_hf_pretrained
    return load_hf_pretrained(name_or_path, **kw)


# How long the process group's rendezvous (and its device setup) may
# take before the worker exits with an error the spawner captures.
INIT_TIMEOUT_S = 120.0

HEARTBEAT_INTERVAL_S = 2.0

# Documented exemptions for the lifecycle self-lint
# (analysis/lifecycle.py): "Class:attr" → reason.
_LINT_LIFECYCLE_OK = {
    "DistributedWorker:_stack_file":
        "faulthandler holds this fd for SIGUSR1 stack dumps — the "
        "postmortem evidence channel must outlive shutdown() (a "
        "late SIGUSR1 against a closed fd would crash the handler); "
        "the OS reclaims it at process exit, which is the intended "
        "lifetime",
}


class _WorkerServe:
    """One serving tenant's worker-side decode state: the
    :class:`~..models.serving.DecodeServer` plus the request-id map and
    per-request emission cursors the ``serve_step`` protocol needs.

    ``sent[rid]`` is how many of the server's output tokens for that
    request have ALREADY been put in a reply — each step reply carries
    only the suffix beyond it, tagged with its offset, which is what
    lets the gateway dedup replayed/redelivered emissions exactly.
    """

    __slots__ = ("server", "rids", "sent", "tokens_total", "window",
                 "pf_seen", "dc_seen")

    def __init__(self, server):
        self.server = server
        self.rids: dict[str, int] = {}      # gateway rid -> local id
        self.sent: dict[str, int] = {}      # gateway rid -> reported
        self.tokens_total = 0
        self.window: list[tuple[float, int]] = []  # (t, tokens_total)
        # Cumulative prefill/decode token counts already reported —
        # each serve_step reply carries the per-tick DELTAS (the
        # observatory's prefill-vs-decode split).
        self.pf_seen = 0
        self.dc_seen = 0

    def note_rate(self) -> None:
        now = time.monotonic()
        self.window.append((now, self.tokens_total))
        while self.window and now - self.window[0][0] > 10.0:
            self.window.pop(0)

    def tokens_per_s(self) -> float:
        if len(self.window) < 2:
            return 0.0
        (t0, n0), (t1, n1) = self.window[0], self.window[-1]
        return (n1 - n0) / (t1 - t0) if t1 > t0 else 0.0

# Orphan grace (durable sessions): when the coordinator dies,
# the worker does NOT exit — it parks the in-flight cell's result,
# keeps its namespace and flight recorder, and waits up to
# NBD_ORPHAN_TTL_S for a fresh coordinator to reattach (dialing the
# control endpoint back, re-reading the session manifest between
# attempts in case the new coordinator had to bind a different port).
# TTL 0 disables the grace period (legacy exit-on-disconnect).
DEFAULT_ORPHAN_TTL_S = 600.0
ORPHAN_RECONNECT_POLL_S = 1.0


class DistributedWorker:
    def __init__(self, rank: int, world_size: int, coordinator_host: str,
                 control_port: int, dist_port: int | None = None,
                 backend: str = "gpu", gpu_id: int = 0,
                 dist_host: str | None = None,
                 gate: InterruptGate | None = None,
                 fault_plan: FaultPlan | None = None):
        self.rank = rank
        self.world_size = world_size
        self.backend = backend
        self.gpu_id = gpu_id
        self._shutdown = threading.Event()
        # (msg_type, started_monotonic, msg_id, deadline_s|None,
        # tenant|None) while a request is being handled, else None.
        # MONOTONIC clock on purpose: busy_s feeds the hang watchdog's
        # stall detection, and a wall-clock step (NTP slew,
        # suspend/resume) must not fake or mask a stall.  The tenant
        # element attributes the in-flight cell to the right tenant in
        # gateway pools (heartbeat busy_tenant piggyback, stream-output
        # routing).
        self._busy: tuple | None = None
        # Tenant namespace isolation (gateway pools): each
        # tenant executes in its own dict, seeded lazily as a copy of
        # the base interactive namespace, so one tenant's assignments
        # (or `del`s) can never leak into another's cells.  The ONE
        # deliberate crossing is `shared` — a dict injected into every
        # tenant namespace by the same object, the explicit opt-in
        # shared segment (`shared["params"] = ...` publishes;
        # everything else is isolated).  Untagged requests (the
        # single-kernel path) keep using self.namespace directly.
        self._tenant_ns: dict[str, dict] = {}
        self._shared_ns: dict = {}
        # Serving loops: tenant -> _WorkerServe.  Mutated
        # only on the serial request loop; the heartbeat thread reads
        # the atomically-rebound snapshot below (never the dict).
        self._serve: dict[str, _WorkerServe] = {}
        self._serve_snap: dict | None = None
        # Step-loop progress: {"i", "k", "last", "sps"}
        # while a --repeat cell is looping, else None.  Rebound
        # atomically by the progress callback on the serial loop; the
        # heartbeat thread piggybacks it (`rep` ping field) so the
        # coordinator sees per-step progress without a probe.
        self._rep_snap: dict | None = None
        self._ckpt_async = None          # in-flight background save
        # Resilience state: the reply-replay cache makes request
        # redelivery idempotent (a retried execute NEVER runs twice);
        # the fault plan (env knob / %dist_chaos) injects deterministic
        # control-plane failures.
        self._replay = ReplayCache()
        self._fault_plan = fault_plan
        self._install_plan: tuple | None = None  # armed by %dist_chaos
        self._msg_seen = 0  # control messages received (kill index)
        # Durable-session state: the session token proves a reattaching
        # coordinator resumes THIS session; the epoch fences stale
        # coordinators out (only a hello may raise it); the mailbox
        # parks results whose reply had no coordinator to land on.
        self._session_token = knobs.get_str("NBD_SESSION_TOKEN") or None
        self._epoch = knobs.get_int("NBD_SESSION_EPOCH", 0)
        # Host labels (multi-host worlds): which host this
        # worker runs on and which host the coordinator runs on — the
        # link-fault layer shapes frames by this pair, and the orphan
        # reconnect loop refuses to dial through a partitioned link.
        self._host_label = knobs.get_str("NBD_HOST") or "local"
        self._coord_label = knobs.get_str("NBD_COORD_HOST") or "local"
        # Manifest mirror (partition tolerance): multi-host worlds
        # share no run-dir filesystem, so the coordinator mirrors its
        # session manifest to every worker in the hello exchange — the
        # reconnect loop's endpoint discovery works from this copy when
        # no shared NBD_RUN_DIR manifest exists.
        self._manifest_mirror: dict | None = None
        self._orphan_ttl = knobs.get_float("NBD_ORPHAN_TTL_S",
                                           float(DEFAULT_ORPHAN_TTL_S))
        # Parked replies spill to the run dir past the in-memory bound:
        # a multi-hundred-MB cell result parked during
        # orphan grace lands on disk with an explicit verdict instead
        # of silently evicting the rest of the mailbox.
        self._mailbox = ResultMailbox(
            spill_dir=os.path.join(flightrec.run_dir(),
                                   f"spill-rank{rank}"))
        # Bulk-transfer endpoint: inbound/outbound chunked
        # transfer state machines; owned by the serial request loop.
        self._xfer = xfer_mod.XferEndpoint(rank, say=self._say)
        self._orphaned = False
        self._hb_fail_streak = 0
        # Message received while VALIDATING a reconnect (the hello a
        # new coordinator owes us) — consumed by the run loop before
        # its next channel.recv.
        self._resume_msg = None
        # (msg_type, msg_id, reply) of the last reply SENT: a send into
        # a dying coordinator's socket can succeed locally yet never be
        # read, so orphan entry re-parks it for redelivery (mutating
        # types only — see _park).
        self._last_reply: tuple | None = None
        # Observability: the process tracer (enabled by the 'trace'
        # control message), wire-frame accounting, and the directory
        # the ACTIVE torch.profiler trace was started with (None = not
        # profiling — the idempotence state for _handle_profile).
        self._tracer = obs_spans.tracer()
        obs_metrics.install_wire_hook()
        self._profile_dir: str | None = None
        self._profiler = None
        # Flight recorder: opened FIRST (before the slow torch init) so
        # even a bring-up crash leaves a black box.  Always on; the
        # ring file lives under the run dir the coordinator exported
        # (NBD_RUN_DIR) and survives this process's death by SIGKILL.
        self._flight = flightrec.init(f"rank{rank}")
        self._flight.record("worker_start", rank=rank, pid=os.getpid(),
                            world_size=world_size)
        # Hang watchdog: when enabled (NBD_HANG, default on)
        # heartbeats also carry the in-flight request id, its optional
        # per-cell deadline, and the collective-progress snapshot from
        # the guard — the coordinator-side watchdog's raw material.
        # Disabled, the heartbeat pays exactly one flag check.
        self._hang_enabled = knobs.get_bool("NBD_HANG", True)
        # Stack dump on demand: SIGUSR1 makes faulthandler write every
        # thread's traceback to a per-rank file under the run dir —
        # the %dist_doctor's view INTO a wedged rank (works even while
        # the main thread is stuck in a loop or a native call; the C
        # handler needs no GIL).  The file object must stay referenced
        # for the lifetime of the process (faulthandler keeps the fd).
        # Per-pid name, like the flight rings: a healed/respawned rank
        # must never truncate its dead predecessor's dumped stacks —
        # they are postmortem evidence.
        self._stack_file = None
        try:
            import faulthandler
            import signal as _signal
            if threading.current_thread() is threading.main_thread():
                path = os.path.join(
                    flightrec.run_dir(),
                    f"stacks-rank{rank}.{os.getpid()}.txt")
                self._stack_file = open(path, "w")
                faulthandler.register(_signal.SIGUSR1,
                                      file=self._stack_file,
                                      all_threads=True)
        except Exception:
            self._stack_file = None  # never block bring-up on this
        # Spawn-time fault plans (NBD_FAULT_PLAN) bypass
        # _set_fault_plan — wire their collective-freeze fault here.
        self._install_freeze_hook(fault_plan)
        # Spawn-time plans (NBD_FAULT_PLAN / NBD_CORRUPT_SPEC) stay
        # readable process-wide (faults.process_plan).
        faults_mod.set_process_plan(fault_plan)
        # SIGINT discipline (see runtime/interrupt.py for the design
        # and the root-cause story).  main() installs the gate before
        # construction so interrupts during the slow init phase defer;
        # an uninstalled gate (direct construction, e.g. in-process
        # tests) degrades to plain default-handler semantics.
        self._gate = gate or InterruptGate()
        # Control plane dials the kernel; the process group's rendezvous
        # dials rank 0's host (they differ on all-remote host plans).
        dist_host = dist_host or coordinator_host
        self._init_process_group(dist_host, dist_port)

        # --- interactive namespace (reference: worker.py:160-177) --------
        self.namespace: dict = {}
        self._seed_namespace()

        # Telemetry sampler: snapshots device memory off the hot path;
        # the heartbeat thread piggybacks the snapshots so the
        # coordinator sees device state even while the serial request
        # loop is busy in a long cell.
        self._telemetry = obs_telemetry.TelemetrySampler(
            rank, device=self.device, extra_fn=self._telemetry_extra)

        # --- control plane (reference: worker.py:154-157) ----------------
        # NBD_AUTH_TOKEN: shared secret required by non-loopback
        # coordinators (multihost); shipped via the worker env.
        # Endpoint + auth kept for the orphan reconnect loop.
        self._coordinator_host = coordinator_host
        self._control_port = control_port
        self._auth_token = knobs.get_str("NBD_AUTH_TOKEN") or None
        self.channel = WorkerChannel(
            coordinator_host, control_port, rank=rank,
            auth_token=self._auth_token)
        self.channel.fault_plan = fault_plan
        self.channel.local_host = self._host_label
        self.channel.peer_host = self._coord_label
        self._flight.record("transport_connect", host=coordinator_host,
                            port=control_port)
        self._hb_thread = threading.Thread(target=self._heartbeat,
                                           name="nbd-heartbeat", daemon=True)
        self._hb_thread.start()

    # ------------------------------------------------------------------

    def _init_process_group(self, dist_host: str,
                            dist_port: int | None) -> None:
        """Data plane (reference: worker.py:128-151): the env the
        reference sets, the rank's GPU, and the process group — for a
        world of one too."""
        import datetime

        import torch
        import torch.distributed as dist

        if dist_port is None:
            raise ValueError("the process group needs --dist-port")
        os.environ.update({"RANK": str(self.rank),
                           "LOCAL_RANK": str(self.rank),
                           "WORLD_SIZE": str(self.world_size),
                           "MASTER_ADDR": dist_host,
                           "MASTER_PORT": str(dist_port)})
        kw = {}
        if self.backend == "gpu":
            torch.cuda.set_device(self.gpu_id)
            self.device = torch.device("cuda", self.gpu_id)
            pg_backend = "nccl"
            # Binds the group to this GPU: barriers and the eager NCCL
            # communicator need no device guess.
            kw["device_id"] = self.device
        elif self.backend == "cpu":
            self.device = torch.device("cpu")
            pg_backend = "gloo"
        else:
            raise ValueError(f"unknown backend {self.backend!r} "
                             f"(gpu | cpu)")
        print(f"[worker {self.rank}] joining the {pg_backend} process "
              f"group ({self.world_size} processes)...", flush=True)
        dist.init_process_group(
            pg_backend, init_method=f"tcp://{dist_host}:{dist_port}",
            world_size=self.world_size, rank=self.rank,
            timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S), **kw)
        print(f"[worker {self.rank}] backend={dist.get_backend()} "
              f"device={self.device}", flush=True)

    def _seed_namespace(self) -> None:
        """The interactive namespace: the reference's torch names
        (reference: worker.py:160-177), the port's functional
        collectives by name, its model entry points, and the mesh
        names the JAX package seeds (``make_mesh``, ``shard_batch``,
        ``replicate``, ``P``, ``apply_shardings``; its ``Mesh`` is the
        port's :class:`..parallel.mesh.Mesh`), its sequence-parallel
        attention (``ring_attention``, ``zigzag_shard``,
        ``zigzag_unshard``, ``ulysses_attention``, on this rank's local
        chunk), ``shard_map`` (this rank's blocks of whole inputs) and
        the pipeline's ``pipeline_forward`` and ``shard_stage_params``."""
        import numpy as np
        import torch

        from .. import models
        from ..parallel import collectives, expert, mesh as mesh_mod
        from ..parallel import pipeline
        from ..parallel.ring import (ring_attention, zigzag_shard,
                                     zigzag_unshard)
        from ..parallel.tensor_parallel import apply_shardings
        from ..parallel.ulysses import ulysses_attention
        from ..utils import data as data_mod
        from .tracked_dist import TrackedDist

        ns = {
            "torch": torch,
            "np": np,
            # torch.distributed, its world collectives on the hang
            # watchdog's progress stream (runtime/tracked_dist.py).
            "dist": TrackedDist(),
            "rank": self.rank,
            "world_size": self.world_size,
            "gpu_id": self.gpu_id if self.backend == "gpu" else None,
            "device": self.device,
            "all_reduce": collectives.all_reduce,
            "all_gather": collectives.all_gather,
            "broadcast": collectives.broadcast,
            "barrier": collectives.barrier,
            "reduce_scatter": collectives.reduce_scatter,
            "all_reduce_quantized": collectives.all_reduce_quantized,
            "scatter": collectives.scatter,
            "gather": collectives.gather,
            "reduce": collectives.reduce,
            "Mesh": mesh_mod.Mesh,
            "P": mesh_mod.P,
            "PartitionSpec": mesh_mod.P,
            "make_mesh": mesh_mod.make_mesh,
            "shard_batch": mesh_mod.shard_batch,
            "replicate": mesh_mod.replicate,
            "apply_shardings": apply_shardings,
            "shard_map": mesh_mod.shard_map,
            "ring_attention": ring_attention,
            "zigzag_shard": zigzag_shard,
            "zigzag_unshard": zigzag_unshard,
            "ulysses_attention": ulysses_attention,
            "pipeline_forward": pipeline.pipeline_forward,
            "shard_stage_params": pipeline.shard_stage_params,
            "moe_ffn": expert.moe_ffn,
            "init_moe_params": expert.init_moe_params,
            "load_hf_pretrained": _load_hf_pretrained_lazy,
            "generate": models.generate,
            "speculative_generate": models.speculative_generate,
            "DecodeServer": models.DecodeServer,
            "batch_iterator": data_mod.batch_iterator,
            "shard_arrays": data_mod.shard_arrays,
            "pack_tokens": data_mod.pack_tokens,
            "__rank__": self.rank,
            "__world_size__": self.world_size,
            "__builtins__": __builtins__,
        }
        self.namespace.update(ns)

    # ------------------------------------------------------------------

    def _heartbeat(self) -> None:
        """Liveness pings; also the only traffic during long cells,
        so the coordinator can distinguish busy from dead (the reference
        cannot: SURVEY §7 'no-timeout mode hangs').

        Pings carry the main loop's busy state: the request loop is
        SERIAL, so a status probe stalls exactly when the user most
        wants it (mid-cell) — the heartbeat thread reports what the
        main thread is doing without going through the loop.  (A
        heartbeat alone proves only the *process* lives; ``busy_s``
        growing across pings is how the coordinator tells "crunching a
        long cell" from "idle".)

        Pings also piggyback a compact telemetry snapshot (device
        memory — every few pings, the sampler paces itself), making the
        coordinator's view push-based."""
        while not self._shutdown.wait(HEARTBEAT_INTERVAL_S):
            plan = self._fault_plan
            if plan is not None and plan.heartbeat_frozen():
                continue  # injected staleness: process alive, pings gone
            busy = self._busy  # one tuple, replaced atomically — the
            data = None        # read can never tear across fields
            if busy is not None:
                # Monotonic arithmetic: wall-clock jumps must neither
                # fake nor mask a stall (the watchdog consumes this).
                data = {"busy_type": busy[0],
                        "busy_s": round(time.monotonic() - busy[1], 3)}
                if len(busy) > 4 and busy[4] is not None:
                    # Gateway pools: whose cell the mesh is running —
                    # the %dist_top / pool-status tenant column.
                    data["busy_tenant"] = busy[4]
                if self._hang_enabled:
                    if busy[2] is not None:
                        data["busy_id"] = busy[2]
                    if busy[3] is not None:
                        data["busy_deadline"] = busy[3]
            if self._hang_enabled:
                col = collective_guard.progress()
                if col is not None:
                    data = dict(data or {})
                    data["col"] = col
            try:
                snap = self._telemetry.maybe_sample()
            except Exception:
                snap = None
            if snap is not None:
                data = dict(data or {})
                data["tel"] = snap
            srv = self._serve_snap  # atomic rebind; safe to read here
            if srv is not None:
                # Serving telemetry: tokens/s and KV-slot
                # occupancy ride every ping while a DecodeServer is
                # live — the %dist_top / pool-status serving columns.
                data = dict(data or {})
                data["srv"] = srv
            rep = self._rep_snap  # atomic rebind; safe to read here
            if rep is not None:
                # Step-loop telemetry: step index, last
                # scalar (loss), steps/s of an in-flight --repeat
                # cell — per-step progress with ONE dispatch, through
                # the same piggyback plane as tel/col.
                data = dict(data or {})
                data["rep"] = rep
            tg = self._tg_snapshot()
            if tg is not None:
                # Training guard: skips, the last audit's step and
                # verdict, rollback and repair counts, quarantine
                # suspects — off pings alone, no status probe.
                data = dict(data or {})
                data["tg"] = tg
            try:
                self.channel.send(Message(msg_type="ping",
                                          rank=self.rank, data=data))
                self._hb_fail_streak = 0
            except Exception as e:
                # Say WHY the pings stopped: the coordinator sees only
                # silence, but the flight ring survives for the
                # postmortem.  With orphan grace enabled the thread
                # KEEPS RUNNING — the main loop owns reattach, and the
                # swapped-in channel makes these sends succeed again;
                # the streak counter is the orphan-entry signal.
                self._hb_fail_streak += 1
                obs_metrics.registry().counter(
                    "nbd_heartbeat_send_failures",
                    "heartbeat pings that failed to send").inc()
                self._flight.record("heartbeat_send_failed",
                                    error=f"{type(e).__name__}: {e}",
                                    streak=self._hb_fail_streak)
                self._flight.flush()
                if self._orphan_ttl <= 0:
                    return  # legacy: no grace period configured

    def _tg_snapshot(self):
        """The training guard's ping payload, or None when no guard is
        live: one atomically rebound dict, safe from the heartbeat
        thread."""
        try:
            from ..resilience import trainguard
            return trainguard.snapshot()
        except Exception:
            return None

    def _telemetry_extra(self) -> dict:
        """Resilience counters riding each telemetry snapshot, so the
        coordinator's push-based view (and the postmortem's last
        snapshot) carries them without a status probe."""
        extra = {"dedup": self._replay.hits, "msgs": self._msg_seen}
        busy = self._busy
        if busy is not None:
            extra["busy"] = busy[0]
        return extra

    def _send_shielded(self, msg: Message) -> None:
        """Send with interrupts deferred (main thread only — that is
        where the gated handler runs): a %dist_interrupt landing
        mid-``sendall`` would otherwise abandon a half-written frame and
        corrupt the control-plane stream.  A deferred interrupt is
        raised at shield exit — after the frame is whole — so it still
        aborts the surrounding cell promptly.  Other threads (heartbeat,
        user threads that print) bypass the gate: CPython never runs
        signal handlers there."""
        if self._gate.main_thread():
            with self._gate.shielded():
                self.channel.send(msg)
        else:
            self.channel.send(msg)

    def _stream(self, text: str, stream: str) -> None:
        """Push stdout/result text to the coordinator immediately
        (reference: worker.py:45-63).  Tagged with the in-flight
        request's tenant (gateway pools) so the gateway can route the
        print to the one kernel whose cell produced it."""
        data = {"text": text, "stream": stream}
        busy = self._busy
        if busy is not None and len(busy) > 4 and busy[4] is not None:
            data["tenant"] = busy[4]
        try:
            self._send_shielded(Message(
                msg_type="stream_output", rank=self.rank, data=data))
        except Exception:
            pass  # printing must never kill execution

    # ------------------------------------------------------------------
    # tenant namespaces (gateway pools)

    def _ns_for(self, tenant: str | None) -> dict:
        """The namespace a request executes/reads/writes in: the base
        interactive namespace for untagged (single-kernel) requests, a
        per-tenant copy of the seeded base otherwise.  Every tenant
        namespace carries the SAME ``shared`` dict — the explicit
        opt-in shared segment — plus its own ``tenant`` name."""
        if tenant is None:
            return self.namespace
        ns = self._tenant_ns.get(tenant)
        if ns is None:
            ns = dict(self.namespace)
            ns["shared"] = self._shared_ns
            ns["tenant"] = tenant
            self._tenant_ns[tenant] = ns
            self._flight.record("tenant_ns_created", tenant=tenant)
        return ns

    # ------------------------------------------------------------------
    # message handlers (dispatch table analog of reference: worker.py:205-221)

    def _handle_execute(self, msg: Message) -> Message:
        code = (msg.data if isinstance(msg.data, str)
                else msg.data.get("code", ""))
        # Publish the cell's target ranks for the duration of the cell:
        # the eager world-collectives consult them at CALL time and
        # raise on a strict subset instead of deadlocking (see
        # runtime/collective_guard.py).  Raw-string requests (bench
        # cells, direct control-plane callers) carry no targets — the
        # subset check stays inactive for them.
        targets = (None if isinstance(msg.data, str)
                   else msg.data.get("target_ranks"))
        repeat = until = None
        if isinstance(msg.data, dict):
            repeat = msg.data.get("repeat")
            until = msg.data.get("until")
        collective_guard.begin_cell(targets, self.world_size)
        self._flight.record("cell_start", msg_id=msg.msg_id,
                            code=code.strip()[:120],
                            **({"tenant": msg.tenant}
                               if msg.tenant is not None else {}),
                            **({"repeat": int(repeat)}
                               if repeat else {}))
        try:
            if repeat:
                # Step loop: compile once, loop worker-side
                # — one dispatch, k steps; per-step progress rides the
                # heartbeat `rep` piggyback, and the replay cache
                # holds ONE entry for the whole loop (a redelivered
                # request never re-runs steps).
                def _note(i, k, last, sps):
                    self._rep_snap = {"i": i, "k": k,
                                      "last": last,
                                      "sps": round(sps, 2)}

                try:
                    result = executor.execute_repeat(
                        code, self._ns_for(msg.tenant), self._stream,
                        repeat=int(repeat), until=until,
                        rank=self.rank,
                        filename=f"<rank {self.rank}>",
                        progress=_note)
                finally:
                    self._rep_snap = None
            else:
                result = executor.execute_cell(
                    code, self._ns_for(msg.tenant), self._stream,
                    rank=self.rank, filename=f"<rank {self.rank}>")
        finally:
            ops = collective_guard.end_cell()
        self._drain_device()
        self._flight.record(
            "cell_end", msg_id=msg.msg_id,
            status="error" if result.get("error") else "success",
            duration_s=round(result.get("duration_s", 0.0), 4))
        result["collective_ops"] = ops
        result["cell_sha1"] = collective_guard.cell_hash(code)
        reg = obs_metrics.registry()
        reg.counter("nbd_cells_total", "cells executed", {
            "status": "error" if result.get("error") else "success",
        }).inc()
        reg.histogram("nbd_cell_seconds",
                      "per-cell user-code duration").observe(
            result.get("duration_s", 0.0))
        return msg.reply(data=result, rank=self.rank)

    def _drain_device(self) -> None:
        """Wait for the work a cell queued on the GPU — also after an
        interrupt, which lands between Python bytecodes while kernels
        are still queued — so the reply means the device is idle and
        the next cell's timing starts clean.  Shielded: an interrupt
        arriving meanwhile is deferred to the next window, never
        thrown into the reply path."""
        if self.device.type != "cuda":
            return
        import torch
        if self._gate.main_thread():
            with self._gate.shielded():
                torch.cuda.synchronize(self.device)
        else:
            torch.cuda.synchronize(self.device)

    def _to_device(self, leaf, is_tensor: bool):
        """A decoded leaf as the namespace holds it: tensor leaves on
        this rank's device, numpy leaves as writable copies (decoded
        buffers are read-only ``frombuffer`` views)."""
        import numpy as np
        import torch
        if not is_tensor:
            return np.array(leaf)
        t = leaf if isinstance(leaf, torch.Tensor) else \
            torch.from_numpy(np.array(leaf))
        return t.to(self.device)

    def _handle_get_var(self, msg: Message) -> Message:
        import numpy as np
        import torch

        name = msg.data if isinstance(msg.data, str) else msg.data["name"]
        ns = self._ns_for(msg.tenant)
        if name not in ns:
            return msg.reply(data={"error": f"name {name!r} not defined"},
                             rank=self.rank)
        value = ns[name]
        if isinstance(value, torch.Tensor):
            # Tensors travel as raw buffers + metadata, the reference's
            # .cpu().detach() path (worker.py:412-418); bf16 as its raw
            # 16 bits under the dtype name "bfloat16" (messaging/codec).
            return msg.reply(
                data={"array": True,
                      "dtype": str(value.dtype).removeprefix("torch."),
                      "shape": list(value.shape), "sharding": None,
                      "device": str(value.device)},
                rank=self.rank, bufs={"value": value.detach().cpu()})
        if isinstance(value, np.ndarray):
            return msg.reply(data={"array": True, "dtype": str(value.dtype),
                                   "shape": list(value.shape),
                                   "sharding": None},
                             rank=self.rank, bufs={"value": value})
        if isinstance(value, (dict, list, tuple)):
            # Pytrees of arrays (params, optimizer state) travel on
            # the buffer path — treedef as JSON, leaves as raw bufs —
            # never the codec's pickle fallback, so they survive
            # allow_pickle=False channels (SURVEY §2.2's trust
            # boundary).  Non-conforming containers fall through.
            from ..messaging.codec import flatten_pytree_wire
            try:
                meta, bufs = flatten_pytree_wire(value)
            except TypeError:
                pass
            else:
                return msg.reply(
                    data={"pytree": meta, "n_leaves": len(bufs)},
                    rank=self.rank, bufs=bufs)
        return msg.reply(data={"array": False, "value": value},
                         rank=self.rank)

    def _handle_set_var(self, msg: Message) -> Message:
        name = msg.data["name"]
        ns = self._ns_for(msg.tenant)
        if msg.data.get("pytree") is not None:
            from ..messaging.codec import unflatten_pytree_wire
            # Tensor leaves go onto this rank's device; numpy leaves
            # are COPIED — the decoded buffers are read-only views.
            ns[name] = unflatten_pytree_wire(
                msg.data["pytree"], msg.bufs, leaf_fn=self._to_device)
        elif "value" in msg.bufs:
            # A raw buffer lands as a tensor on this rank's device (the
            # JAX worker puts it on its device with jnp.asarray).
            ns[name] = self._to_device(msg.bufs["value"], True)
        else:
            ns[name] = msg.data.get("value")
        return msg.reply(data={"status": "set", "name": name},
                         rank=self.rank)

    # -- bulk-transfer plane -------------
    #
    # The endpoint owns all chunk/bitmap/resume state; these shims
    # supply the two things only the worker knows — the namespace to
    # bind into and the flight recorder.  Chunk writes are bitmap-
    # idempotent and the commit bind runs exactly once (replay cache
    # for same-msg_id redeliveries, the endpoint's completed-xid memo
    # for commits from a post-SIGKILL successor coordinator).

    def _handle_xfer_begin(self, msg: Message) -> Message:
        return self._xfer.handle_begin(msg)

    def _handle_xfer_chunk(self, msg: Message) -> Message:
        return self._xfer.handle_chunk(msg)

    def _handle_xfer_commit(self, msg: Message) -> Message:
        def bind(st):
            if st.kind == "file":
                dest = os.path.abspath(os.path.expanduser(st.dest or ""))
                if not st.dest:
                    raise ValueError("file transfer without dest path")
                os.makedirs(os.path.dirname(dest), exist_ok=True)
                st.sink.arrays["f0"].tofile(dest)
                probe = lambda: os.path.exists(dest)  # noqa: E731
            else:
                from ..messaging.codec import unflatten_pytree_wire
                ns = self._ns_for(st.tenant if st.tenant is not None
                                  else msg.tenant)
                # Tensor leaves go onto this rank's device; numpy leaves
                # bind the preallocated destination arrays directly —
                # the sink already owns writable memory, so unlike
                # set_var no defensive copy is needed.
                value = unflatten_pytree_wire(
                    st.meta, st.sink.arrays,
                    leaf_fn=lambda a, is_t: self._to_device(a, True)
                    if is_t else a)
                ns[st.name] = value
                # id only — a strong ref here would pin the payload in
                # the memo after the user deletes the variable.
                vid, name = id(value), st.name
                probe = lambda: id(ns.get(name)) == vid  # noqa: E731
            self._flight.record("xfer_applied", xid=st.xid,
                                kind=st.kind, name=st.name,
                                bytes=st.sink.total)
            return probe
        return self._xfer.handle_commit(msg, bind)

    def _handle_xfer_pull_begin(self, msg: Message) -> Message:
        d = msg.data or {}
        ns = None if d.get("file") else self._ns_for(msg.tenant)
        return self._xfer.handle_pull_begin(msg, ns)

    def _handle_xfer_read(self, msg: Message) -> Message:
        return self._xfer.handle_read(msg)

    def _handle_xfer_pull_end(self, msg: Message) -> Message:
        return self._xfer.handle_pull_end(msg)

    def _handle_sync(self, msg: Message) -> Message:
        from ..parallel import collectives
        collectives.barrier()
        return msg.reply(data={"status": "synced"}, rank=self.rank)

    def _handle_get_status(self, msg: Message) -> Message:
        data = introspect.device_status(self.rank, self.world_size,
                                        self.device)
        # Resilience counters ride the status probe so chaos runs can
        # assert "zero double-executions" (every redelivery was
        # answered from the replay cache) from the coordinator side.
        data["dedup_hits"] = self._replay.hits
        plan = self._fault_plan
        if plan is not None:
            data["fault_counters"] = dict(plan.counters)
        # Observability state: until these fields, there was no way to
        # tell from the coordinator that a profiler trace or a span
        # trace was left running on a worker.
        data["profiling"] = self._profile_dir
        data["tracing"] = self._tracer.enabled
        if self._tracer.enabled:
            data["trace_spans"] = len(self._tracer)
        # Durable-session state: what a reattached coordinator rebuilds
        # its rank table from.
        data["session_epoch"] = self._epoch
        data["mailbox_parked"] = len(self._mailbox)
        # Bulk-transfer counters: the chaos pin asserts
        # applies == 1 per transfer (zero double-applies) and reads
        # dup/crc-reject counts from here.
        data["xfer"] = self._xfer.status()
        data["orphan_ttl_s"] = self._orphan_ttl
        # Gateway pools: which tenants have materialized a namespace on
        # this rank, and the shared segment's size.
        if self._tenant_ns:
            data["tenants"] = sorted(self._tenant_ns)
            data["shared_names"] = len(self._shared_ns)
        return msg.reply(data=data, rank=self.rank)

    def _handle_chaos(self, msg: Message) -> Message:
        """Install / clear / report the worker-side fault plan at
        runtime (``%dist_chaos``).  ``set`` ARMS the plan rather than
        installing it: it takes effect after this reply is sent, so
        the acknowledgement itself cannot be eaten by the plan it
        confirms."""
        data = msg.data or {}
        action = data.get("action", "status")
        if action == "set":
            try:
                plan = FaultPlan.from_spec(data.get("spec") or {})
            except (TypeError, ValueError) as e:
                return msg.reply(data={"error": f"bad fault spec: {e}"},
                                 rank=self.rank)
            self._install_plan = (plan,)
            self._flight.record("fault_plan_armed", spec=plan.spec())
            return msg.reply(data={"status": "armed",
                                   "spec": plan.spec()}, rank=self.rank)
        if action == "clear":
            old = self._fault_plan
            self._set_fault_plan(None)  # immediate: the ack must land
            return msg.reply(
                data={"status": "cleared",
                      "counters": dict(old.counters) if old else None},
                rank=self.rank)
        plan = self._fault_plan
        return msg.reply(
            data={"status": "active" if plan is not None else "off",
                  "spec": plan.spec() if plan is not None else None,
                  "counters": dict(plan.counters)
                  if plan is not None else None,
                  "dedup_hits": self._replay.hits},
            rank=self.rank)

    def _set_fault_plan(self, plan: FaultPlan | None) -> None:
        self._fault_plan = plan
        self.channel.fault_plan = plan
        # The training-integrity guard reads the plan through the
        # module-level slot (corrupt specs fire inside user-code train
        # loops, which never see the Worker instance).
        faults_mod.set_process_plan(plan)
        # kill_at counts messages SINCE THE PLAN WAS INSTALLED (the
        # should_kill contract): a runtime-armed kill_at=5 must mean
        # "the 5th message from now", not an absolute since-spawn index
        # the session has long passed.
        self._msg_seen = 0
        self._install_freeze_hook(plan)

    def _install_freeze_hook(self, plan: FaultPlan | None) -> None:
        """Wire the plan's collective-freeze fault into the guard: a
        chosen rank blocks at a chosen collective entry — alive,
        heartbeating, making no progress — the deterministic stand-in
        for a wedged rank the hang watchdog exists to catch.  The
        sleep runs inside the cell's interrupt window, so the
        escalation ladder's %dist_interrupt breaks it."""
        if plan is None or not plan.has_freeze():
            collective_guard.set_freeze_hook(None)
            return

        def _freeze(op: str, seq: int) -> None:
            wait = plan.should_freeze(self.rank, seq)
            if wait is None:
                return
            self._flight.record("fault_freeze", op=op, seq=seq,
                                freeze_s=wait)
            self._flight.flush()
            time.sleep(wait)

        collective_guard.set_freeze_hook(_freeze)

    def _handle_get_namespace_info(self, msg: Message) -> Message:
        return msg.reply(
            data={"namespace_info": introspect.describe_namespace(
                self._ns_for(msg.tenant)), "status": "success"},
            rank=self.rank)

    def _handle_guard(self, msg: Message) -> Message:
        """Report, toggle or audit the training guard
        (``resilience/trainguard.py``; ``worker.py:844`` of the JAX
        package).  ``audit`` runs a replica-consistency audit on the live
        guard now: only with every rank receiving it (``send_to_all``),
        since the audit's all-gather needs the whole group."""
        from ..resilience import trainguard
        data = msg.data or {}
        action = data.get("action", "status")
        if action in ("on", "off"):
            trainguard.set_enabled(action == "on")
            self._flight.record("guard_toggle", enabled=action == "on")
            return msg.reply(data={"status": action, **trainguard.status()},
                             rank=self.rank)
        if action == "audit":
            g = trainguard._ACTIVE
            if g is None:
                return msg.reply(data={"error": "no live TrainGuard in "
                                                "this process"},
                                 rank=self.rank)
            try:
                v = g.audit()
            except Exception as e:
                return msg.reply(data={"error": f"audit failed: "
                                                f"{type(e).__name__}: {e}"},
                                 rank=self.rank)
            return msg.reply(data={"status": "audited", "ok": v.ok,
                                   "majority_rank": v.majority_rank,
                                   "minority": list(v.minority),
                                   **trainguard.status()},
                             rank=self.rank)
        return msg.reply(data=trainguard.status(), rank=self.rank)

    def _handle_checkpoint(self, msg: Message) -> Message:
        """Save or restore named namespace entries (``worker.py:907`` of
        the JAX package).  ``background: true`` on a save starts
        :func:`.checkpoint.save_async` and returns at once (the device-
        to-host copy and the disk writes run on a thread); ``action:
        "status"`` polls it: idle, pending, done with its summary, or
        failed with its error.  A restore writes into live values that
        fit (``checkpoint.restore``)."""
        from . import checkpoint

        data = msg.data or {}
        action = data.get("action")
        names = data.get("names")
        if action == "status":
            h = self._ckpt_async
            if h is None:
                return msg.reply(data={"status": "idle"}, rank=self.rank)
            if not h.done():
                return msg.reply(data={"status": "pending"}, rank=self.rank)
            self._ckpt_async = None
            try:
                summary = h.wait(0)
            except Exception as e:
                return msg.reply(data={"error": f"async checkpoint "
                                                f"failed: {e}"},
                                 rank=self.rank)
            return msg.reply(data={"status": "done", "summary": summary},
                             rank=self.rank)
        path = data.get("path")
        if not path:
            return msg.reply(data={"error": "checkpoint needs a path"},
                             rank=self.rank)
        self._flight.record("checkpoint", action=action, path=path,
                            background=bool(data.get("background")))
        ns = self._ns_for(msg.tenant)
        if action == "save":
            if not names:
                return msg.reply(
                    data={"error": "checkpoint save requires a non-empty "
                                   "list of names"}, rank=self.rank)
            if data.get("background"):
                prev = self._ckpt_async
                if prev is not None and not prev.done():
                    return msg.reply(
                        data={"error": "a background checkpoint is "
                                       "already in flight (poll it with "
                                       "action 'status' first)"},
                        rank=self.rank)
                reply: dict = {"status": "started", "summary": {}}
                if prev is not None:
                    # Completed but never polled: its outcome, a failure
                    # above all, must not vanish.
                    try:
                        prev.wait(0)
                    except Exception as e:
                        reply["previous_error"] = (
                            f"previous background checkpoint failed "
                            f"unpolled: {e}")
                self._ckpt_async = checkpoint.save_async(
                    path, ns, names, rank=self.rank,
                    world_size=self.world_size)
                return msg.reply(data=reply, rank=self.rank)
            with obs_spans.maybe_span("checkpoint/save", kind="checkpoint",
                                      attrs={"path": path}):
                summary = checkpoint.save(path, ns, names, rank=self.rank,
                                          world_size=self.world_size)
        elif action == "restore":
            with obs_spans.maybe_span("checkpoint/restore",
                                      kind="checkpoint",
                                      attrs={"path": path}):
                summary = checkpoint.restore(path, ns, names,
                                             rank=self.rank)
        else:
            return msg.reply(data={"error": f"unknown checkpoint action "
                                            f"{action!r}"}, rank=self.rank)
        return msg.reply(data={"status": action, "summary": summary},
                         rank=self.rank)

    def _handle_profile(self, msg: Message) -> Message:
        """``torch.profiler`` start/stop, idempotent; stop exports a
        Chrome trace (``trace.json``) into the directory the trace was
        started with.  ``_profile_dir`` is the source of truth for "a
        trace is running" — a second start and a stop-without-start
        reply with a clear ``{status, error}`` instead of a profiler
        traceback, and stop reports the directory the trace was
        actually STARTED with rather than trusting the stop message's
        ``log_dir``."""
        action = msg.data.get("action")
        if action == "start":
            if self._profile_dir is not None:
                return msg.reply(
                    data={"status": "profiling",
                          "log_dir": self._profile_dir,
                          "error": "a profiler trace is already running "
                                   f"(started with {self._profile_dir}); "
                                   "stop it first"},
                    rank=self.rank)
            base = msg.data.get("log_dir", os.path.join(
                tempfile.gettempdir(), "nbd_profile"))
            log_dir = os.path.join(base, f"rank{self.rank}")
            try:
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                prof = profile(activities=acts)
                prof.start()
            except Exception as e:
                return msg.reply(data={"status": "idle",
                                       "error": f"profiler start "
                                                f"failed: {e}"},
                                 rank=self.rank)
            self._profiler, self._profile_dir = prof, log_dir
            return msg.reply(data={"status": "profiling",
                                   "log_dir": log_dir}, rank=self.rank)
        if action == "stop":
            if self._profile_dir is None:
                return msg.reply(
                    data={"status": "idle",
                          "error": "no profiler trace is running"},
                    rank=self.rank)
            log_dir, self._profile_dir = self._profile_dir, None
            prof, self._profiler = self._profiler, None
            try:
                if self.device.type == "cuda":
                    import torch
                    # CUDA runs behind the host: a cell's reply leaves
                    # when its Python returns, so its last kernels may
                    # still be queued; stop only once they ran.
                    torch.cuda.synchronize(self.device)
                prof.stop()
                os.makedirs(log_dir, exist_ok=True)
                path = os.path.join(log_dir, "trace.json")
                prof.export_chrome_trace(path)
            except Exception as e:
                return msg.reply(data={"status": "idle",
                                       "log_dir": log_dir,
                                       "error": f"profiler stop "
                                                f"failed: {e}"},
                                 rank=self.rank)
            return msg.reply(data={"status": "stopped", "log_dir": log_dir,
                                   "trace": path}, rank=self.rank)
        return msg.reply(data={"error": f"unknown profile action "
                                        f"{action!r}"}, rank=self.rank)

    # ------------------------------------------------------------------
    # observability handlers

    def _handle_trace(self, msg: Message) -> Message:
        """Span-trace control: ``start`` (adopting the coordinator's
        trace id so all processes share one), ``stop``, ``dump``
        (spans + instants + this plan's fault events, for the merged
        export), ``status``."""
        data = msg.data or {}
        action = data.get("action", "status")
        tr = self._tracer
        if action == "start":
            tid = tr.start(trace_id=data.get("trace_id"))
            return msg.reply(data={"status": "tracing", "trace_id": tid},
                             rank=self.rank)
        if action == "stop":
            n = tr.stop()
            return msg.reply(data={"status": "stopped", "spans": n},
                             rank=self.rank)
        if action == "dump":
            plan = self._fault_plan
            return msg.reply(
                data={"status": "ok", "trace": tr.dump(),
                      "fault_events": plan.events() if plan is not None
                      else []},
                rank=self.rank)
        return msg.reply(
            data={"status": "tracing" if tr.enabled else "off",
                  "spans": len(tr), "trace_id": tr.trace_id},
            rank=self.rank)

    def _handle_metrics(self, msg: Message) -> Message:
        """Snapshot the process metrics registry, mirroring the
        resilience counters (dedup hits, fault injections) into it
        first so one export carries everything."""
        reg = obs_metrics.registry()
        reg.gauge("nbd_dedup_hits",
                  "redelivered requests answered from the replay "
                  "cache").set(self._replay.hits)
        # Flight-ring health: utilization, wraps,
        # overwritten/truncated/dropped — evidence-loss visibility.
        flightrec.export_health(reg)
        plan = self._fault_plan
        if plan is not None:
            for action, n in plan.counters.items():
                reg.gauge("nbd_fault_injections",
                          "fault-plan decisions by action",
                          {"action": action}).set(n)
        if (msg.data or {}).get("format") == "prometheus":
            return msg.reply(data={"status": "ok",
                                   "text": reg.prometheus_text()},
                             rank=self.rank)
        return msg.reply(data={"status": "ok", "metrics": reg.to_json()},
                         rank=self.rank)

    # ------------------------------------------------------------------
    # durable sessions: hello/mailbox handlers + orphan grace

    def _handle_hello(self, msg: Message) -> Message:
        """Session handover: a (re)attaching coordinator proves the
        session token and presents its epoch.  An epoch >= ours is
        adopted (frames from any older coordinator are rejected from
        then on); a LOWER one is itself stale — two kernels racing to
        attach resolve to whichever bumped the manifest last."""
        data = msg.data or {}
        if self._session_token and data.get("token") != self._session_token:
            self._flight.record("hello_rejected", reason="token")
            return msg.reply(data={"error": "session token mismatch "
                                            "(not this fleet's session)"},
                             rank=self.rank)
        try:
            epoch = int(data.get("epoch") or 0)
        except (TypeError, ValueError):
            return msg.reply(data={"error": "bad epoch"}, rank=self.rank)
        if epoch < self._epoch:
            self._flight.record("hello_rejected", reason="stale_epoch",
                                offered=epoch, epoch=self._epoch)
            return msg.reply(
                data={"error": f"stale epoch {epoch} < {self._epoch}"},
                rank=self.rank)
        prev, self._epoch = self._epoch, epoch
        # Multi-host session bootstrap: workers spawned through an
        # agent/ssh plan carry no NBD_SESSION_TOKEN env — the first
        # hello supplies it (later hellos are then token-verified), and
        # mirrors the session manifest so the orphan reconnect loop can
        # discover a replacement endpoint WITHOUT the shared run-dir
        # filesystem durable sessions assume on one host.
        if self._session_token is None and data.get("token"):
            self._session_token = str(data["token"])
        mirror = data.get("manifest")
        if isinstance(mirror, dict):
            self._manifest_mirror = mirror
        self._flight.record("hello", epoch=epoch, prev_epoch=prev)
        return msg.reply(
            data={"status": "ok", "rank": self.rank, "pid": os.getpid(),
                  "epoch": epoch, "world_size": self.world_size,
                  "parked": self._mailbox.ids(),
                  "dedup_hits": self._replay.hits,
                  "namespace_size": len(self.namespace)},
            rank=self.rank)

    def _handle_mailbox(self, msg: Message) -> Message:
        """Parked-result redelivery.  ``drain`` claims every parked
        reply (destructive — exactly once; a REDELIVERED drain is
        answered from the replay cache, which caches this very reply);
        ``claim`` takes one by msg_id; default reports state."""
        action = (msg.data or {}).get("action", "status")
        if action == "drain":
            claimed = self._mailbox.claim_all()
            try:
                reply = msg.reply(
                    data={"status": "ok",
                          "results": {mid: getattr(r, "data", None)
                                      for mid, r in claimed.items()}},
                    rank=self.rank)
            except BaseException:
                # Destructive claim: repark before unwinding or the
                # parked results are gone and the reattaching
                # coordinator's drain finds an empty box.
                for mid, r in claimed.items():
                    self._mailbox.park(mid, r)
                raise
            self._flight.record("mailbox_drained", n=len(claimed))
            return reply
        if action == "claim":
            r = self._mailbox.claim((msg.data or {}).get("msg_id", ""))
            return msg.reply(
                data={"status": "ok",
                      "result": getattr(r, "data", None)},
                rank=self.rank)
        return msg.reply(
            data={"status": "ok", "parked": self._mailbox.ids(),
                  "counters": self._mailbox.counters()},
            rank=self.rank)

    def _handle_tenant_gc(self, msg: Message) -> Message:
        """Drop an evicted tenant's namespace.  The gateway broadcasts
        this when a clean detach frees the tenant's admission slot —
        without it the namespace (and every device array in it) lives
        forever, and a LATER unrelated tenant reusing the name would
        inherit the old tenant's state."""
        name = (msg.data or {}).get("tenant")
        existed = name in self._tenant_ns
        if existed:
            del self._tenant_ns[name]
            self._flight.record("tenant_ns_dropped", tenant=name)
        return msg.reply(data={"status": "ok", "existed": existed},
                         rank=self.rank)

    # ------------------------------------------------------------------
    # serving loop: the gateway drives a DecodeServer here

    def _handle_serve_open(self, msg: Message) -> Message:
        """Build (or reset) this rank's :class:`DecodeServer` for a
        serving tenant from names in that tenant's namespace.  The
        gateway opens the decode rank lazily and re-opens on the next
        live rank after a failover — the namespace (params/config) is
        already seeded on every rank by the serve_start model-spec
        cell, so any rank can take over."""
        from ..models import DecodeServer

        data = msg.data or {}
        tenant = data.get("tenant") or msg.tenant
        ns = self._ns_for(tenant)
        pname = data.get("params") or "params"
        cname = data.get("cfg") or "cfg"
        if pname not in ns or cname not in ns:
            return msg.reply(
                data={"error": f"serving namespace is missing "
                               f"{pname!r}/{cname!r} — run the model "
                               f"spec first (%dist_serve start)"},
                rank=self.rank)
        # Serving fast path: paged KV geometry + chunked
        # prefill, forwarded from the gateway's serve_open.  A chunk
        # size implies interleaved prefill — long prompts advance one
        # chunk per tick between decode steps so TPOT stays bounded.
        kw: dict = {}
        if data.get("kv_block_tokens"):
            kw["kv_block_tokens"] = int(data["kv_block_tokens"])
            if data.get("kv_blocks"):
                kw["kv_blocks"] = int(data["kv_blocks"])
        if data.get("prefill_chunk"):
            kw["prefill_chunk"] = int(data["prefill_chunk"])
            kw["interleave_prefill"] = True
        if data.get("kv_quantized"):
            kw["kv_quantized"] = True
        # The JAX worker shards the decode over this rank's local
        # devices (a tp mesh); a rank here drives one GPU, and a mesh
        # spans ranks (``DecodeServer(mesh=)`` in a cell on every rank).
        try:
            server = DecodeServer(
                ns[pname], ns[cname],
                max_batch=int(data.get("max_batch") or 8),
                max_len=int(data.get("max_len") or 512),
                pad_to=int(data.get("pad_to") or 16),
                eos_id=data.get("eos_id"),
                temperature=float(data.get("temperature") or 0.0),
                **kw)
        except Exception as e:
            return msg.reply(data={"error": f"DecodeServer build "
                                            f"failed: {e}"},
                             rank=self.rank)
        self._serve[tenant] = _WorkerServe(server)
        self._publish_serve_snap()
        self._flight.record("serve_open", tenant=tenant,
                            max_batch=server._B, max_len=server._T)
        return msg.reply(data={"status": "open", "slots": server._B},
                         rank=self.rank)

    def _handle_serve_step(self, msg: Message) -> Message:
        """One decode tick: admit new requests, run up to ``steps``
        decode steps, reply with per-request emissions AT OFFSETS.
        ``release`` frees finished requests' host-side records.  The
        reply is cached by the replay cache like any mutating request,
        so a redelivered tick never decodes twice."""
        data = msg.data or {}
        tenant = data.get("tenant") or msg.tenant
        st = self._serve.get(tenant)
        if st is None:
            return msg.reply(
                data={"error": "no serving loop open on this rank "
                               "(serve_open first)"},
                rank=self.rank)
        errors: dict[str, str] = {}
        for a in data.get("admit") or ():
            rid = a.get("rid")
            try:
                local = st.server.submit([int(t) for t in a["prompt"]],
                                         int(a["max_new"]))
            except Exception as e:
                errors[rid] = f"{type(e).__name__}: {e}"
                continue
            st.rids[rid] = local
            st.sent[rid] = 0
        for rid in data.get("release") or ():
            local = st.rids.pop(rid, None)
            st.sent.pop(rid, None)
            if local is not None:
                try:
                    st.server.release(local)
                except (KeyError, ValueError):
                    # Still pending or mid-(chunked-)prefill: cancel
                    # instead — frees its queue entry and KV blocks.
                    try:
                        st.server.cancel(local)
                    except Exception:
                        pass
        steps = max(0, int(data.get("steps") or 0))
        t_step0 = time.perf_counter()
        for _ in range(steps):
            if st.server.done():
                break
            st.server.step()
        step_s = time.perf_counter() - t_step0
        emitted: dict[str, dict] = {}
        finished: list[str] = []
        for rid, local in st.rids.items():
            out = st.server.outputs.get(local, [])
            o = st.sent.get(rid, 0)
            if len(out) > o:
                emitted[rid] = {"o": o, "t": [int(t) for t in out[o:]]}
                st.tokens_total += len(out) - o
                st.sent[rid] = len(out)
            if local in st.server.finished:
                finished.append(rid)
        st.note_rate()
        self._publish_serve_snap()
        # Tick telemetry: compute seconds, the tick's
        # prefill/decode token split (deltas of the server's
        # cumulative counters), and per-request prefill progress —
        # the gateway's serving observatory clock-corrects the wall
        # stamp and attributes the compute to active requests.
        pf_tot = getattr(st.server, "prefill_tokens_total", 0)
        dc_tot = getattr(st.server, "decode_tokens_total", 0)
        pf_d, dc_d = pf_tot - st.pf_seen, dc_tot - st.dc_seen
        st.pf_seen, st.dc_seen = pf_tot, dc_tot
        local_rids = {v: k for k, v in st.rids.items()}
        pfp = {local_rids[lid]: [int(w), int(n)]
               for lid, (w, n) in st.server.prefill_progress().items()
               if lid in local_rids}
        return msg.reply(
            data={"status": "ok", "emitted": emitted,
                  "finished": finished, "errors": errors,
                  "active": st.server.n_active,
                  "slots": st.server._B,
                  "pending": len(st.server._pending),
                  "tick": {"now": time.time(),
                           "step_s": round(step_s, 6),
                           "pf": int(pf_d), "dc": int(dc_d)},
                  "pfp": pfp},
            rank=self.rank)

    def _handle_serve_close(self, msg: Message) -> Message:
        tenant = (msg.data or {}).get("tenant") or msg.tenant
        existed = tenant in self._serve
        if existed:
            del self._serve[tenant]
            self._flight.record("serve_close", tenant=tenant)
        self._publish_serve_snap()
        return msg.reply(data={"status": "ok", "existed": existed},
                         rank=self.rank)

    def _publish_serve_snap(self) -> None:
        """Atomically rebind the heartbeat's serving-telemetry view
        (tokens total, tokens/s, KV-slot occupancy) — the heartbeat
        thread reads the snapshot, never the live dict."""
        if not self._serve:
            self._serve_snap = None
            return
        tot = occ = slots = 0
        kv_used = kv_total = 0
        tps = 0.0
        frag = None
        for st in self._serve.values():
            tot += st.tokens_total
            occ += st.server.n_active
            slots += st.server._B
            tps += st.tokens_per_s()
            kv = st.server.kv_snapshot()
            if kv is not None:
                kv_used += kv["used"]
                kv_total += kv["blocks"]
                # Largest contiguous free run, min across tenants —
                # the most fragmented pool is the binding constraint
                # (%dist_top frag column).
                run = kv.get("largest_run")
                if run is not None:
                    frag = run if frag is None else min(frag, run)
        self._serve_snap = {"tok": tot, "tps": round(tps, 2),
                            "occ": occ, "slots": slots,
                            **({"kvb": [kv_used, kv_total]}
                               if kv_total else {}),
                            **({"frag": frag}
                               if frag is not None else {})}

    def _park(self, msg_type: str, msg_id: str, reply: Message) -> None:
        """Park a reply for redelivery to a future coordinator.
        Read-only replies are skipped (re-probing is safe and their
        staleness makes redelivery noise); mutating results — exactly
        what must not be lost or re-executed — are kept."""
        if msg_type in _READ_ONLY or msg_type in (
                "hello", "mailbox", "tenant_gc",
                # Serving ticks are NOT parked: the gateway's journal
                # is the authoritative stream record, and a successor
                # gateway re-opens a fresh DecodeServer and re-admits
                # from it — a parked tick reply would be stale noise.
                "serve_open", "serve_step", "serve_close"):
            return
        self._mailbox.park(msg_id, reply)
        obs_metrics.registry().counter(
            "nbd_mailbox_parked",
            "replies parked for redelivery after coordinator "
            "loss").inc()
        self._flight.record("mailbox_parked", msg_id=msg_id,
                            type=msg_type)

    def _say(self, text: str) -> None:
        """Orphan-path stdout: the spawning coordinator owned our
        stdout pipe, so after ITS death a plain print raises
        BrokenPipeError — precisely on the code path that exists to
        survive that death."""
        try:
            print(text, flush=True)
        except OSError:
            pass

    def _manifest_dial_host(self, ctl: dict) -> str:
        """The address this worker should dial from a manifest control
        block.  Manifests written on the coordinator's host may record
        a loopback dial address (fine for same-host workers); a worker
        that originally dialed a non-loopback address must keep doing
        so — its loopback is a different machine."""
        host = ctl.get("host") or self._coordinator_host
        if host in ("127.0.0.1", "localhost") \
                and self._coordinator_host not in ("127.0.0.1",
                                                   "localhost"):
            return self._coordinator_host
        return host

    def _coordinator_endpoint(self) -> tuple[str, int, bool]:
        """Where the reconnect loop should dial: the session manifest's
        endpoint when one exists for OUR session (a reattaching
        coordinator that couldn't re-bind the old port publishes its
        replacement there), else the hello-mirrored manifest (multi-
        host worlds share no run-dir filesystem), else the spawn-time
        endpoint.

        The third element is ``expect_hello``: True when the manifest
        epoch is AHEAD of ours — a new coordinator has claimed the
        fleet and will hello promptly, so a listener at that endpoint
        that never sends a frame is an impostor (an unrelated process
        on a recycled port), not a coordinator.  A same-epoch endpoint
        is the ORIGINAL coordinator (transient reconnect) and may
        legitimately be idle, so no traffic is demanded of it."""
        d = knobs.get_str("NBD_RUN_DIR")
        candidates = []
        if d:
            try:
                from ..resilience.session import read_manifest
                candidates.append(read_manifest(d))
            except Exception:
                pass
        candidates.append(self._manifest_mirror)
        for m in candidates:
            if m is None or not isinstance(m, dict):
                continue
            if self._session_token \
                    and m.get("token") != self._session_token:
                continue
            ctl = m.get("control") or {}
            try:
                return (self._manifest_dial_host(ctl),
                        int(ctl.get("port") or self._control_port),
                        int(m.get("epoch") or 0) > self._epoch)
            except (TypeError, ValueError):
                continue
        return self._coordinator_host, self._control_port, False

    def _enter_orphan_and_wait(self) -> bool:
        """The coordinator is gone: park the result it may never have
        read, then poll the control endpoint until a fresh coordinator
        listens there (True — resume serving) or the TTL expires
        (False — self-terminate).  The heartbeat thread keeps running
        throughout; its sends start succeeding the moment the channel
        is swapped, which is also the new coordinator's liveness
        signal."""
        ttl = self._orphan_ttl
        if ttl <= 0 or self._shutdown.is_set():
            return False
        last, self._last_reply = self._last_reply, None
        if last is not None:
            # This reply's send "succeeded" into a socket whose reader
            # may already have been dead — keep it claimable.
            self._park(*last)
        self._orphaned = True
        obs_metrics.registry().counter(
            "nbd_orphan_transitions",
            "orphan state machine transitions",
            {"event": "entered"}).inc()
        self._flight.record("orphan_entered", ttl_s=ttl,
                            parked=len(self._mailbox))
        self._flight.flush()
        self._say(f"[worker {self.rank}] coordinator lost — orphaned, "
                  f"awaiting reattach for {ttl:.0f}s")
        deadline = time.monotonic() + ttl
        while not self._shutdown.is_set():
            plan = self._fault_plan
            if (plan is not None and plan.has_links()
                    and plan.link_blocked(self._host_label,
                                          self._coord_label)):
                # The injected partition is still open: locally the
                # dial would succeed (there is no real cable to cut),
                # which would void the emulation — wait it out, still
                # inside THIS episode's TTL.
                if time.monotonic() >= deadline:
                    break
                self._shutdown.wait(ORPHAN_RECONNECT_POLL_S)
                continue
            host, port, expect_hello = self._coordinator_endpoint()
            try:
                ch = WorkerChannel(host, port, rank=self.rank,
                                   auth_token=self._auth_token,
                                   connect_timeout=5.0)
            except Exception:
                ch = None
            if ch is not None and expect_hello:
                # A NEW coordinator published this endpoint (manifest
                # epoch ahead of ours): its hello must arrive or this
                # listener isn't it — a bare TCP accept must not count
                # as a reattach, or an unrelated process on a recycled
                # port would absorb the worker forever and void the
                # TTL contract.  The wait stays inside THIS episode's
                # deadline, so a silent impostor can't extend grace.
                step = min(30.0, max(1.0, deadline - time.monotonic()))
                try:
                    self._resume_msg = ch.recv(timeout=step)
                except Exception:
                    try:
                        ch.close()
                    except Exception:
                        pass
                    ch = None
            if ch is not None:
                ch.fault_plan = self._fault_plan
                ch.local_host = self._host_label
                ch.peer_host = self._coord_label
                old, self.channel = self.channel, ch
                try:
                    old.close()
                except Exception:
                    pass
                self._orphaned = False
                self._hb_fail_streak = 0
                obs_metrics.registry().counter(
                    "nbd_orphan_transitions",
                    "orphan state machine transitions",
                    {"event": "reattached"}).inc()
                self._flight.record("orphan_reattached",
                                    host=host, port=port)
                self._say(f"[worker {self.rank}] reattached to "
                          f"coordinator at {host}:{port}")
                return True
            if time.monotonic() >= deadline:
                break
            self._shutdown.wait(ORPHAN_RECONNECT_POLL_S)
        obs_metrics.registry().counter(
            "nbd_orphan_transitions",
            "orphan state machine transitions",
            {"event": "expired"}).inc()
        self._flight.record("orphan_expired", ttl_s=ttl,
                            parked=len(self._mailbox))
        self._flight.flush()
        self._say(f"[worker {self.rank}] orphan TTL expired unclaimed "
                  "— self-terminating")
        return False

    # ------------------------------------------------------------------

    def run(self) -> None:
        """Serial request loop (reference: worker.py:181-246).  One request
        at a time per worker — ordering is the concurrency model."""
        handlers = {
            "execute": self._handle_execute,
            "get_var": self._handle_get_var,
            "set_var": self._handle_set_var,
            "sync": self._handle_sync,
            "get_status": self._handle_get_status,
            "get_namespace_info": self._handle_get_namespace_info,
            "profile": self._handle_profile,
            "checkpoint": self._handle_checkpoint,
            "chaos": self._handle_chaos,
            "guard": self._handle_guard,
            "trace": self._handle_trace,
            "metrics": self._handle_metrics,
            "hello": self._handle_hello,
            "mailbox": self._handle_mailbox,
            "tenant_gc": self._handle_tenant_gc,
            "serve_open": self._handle_serve_open,
            "serve_step": self._handle_serve_step,
            "serve_close": self._handle_serve_close,
            "xfer_begin": self._handle_xfer_begin,
            "xfer_chunk": self._handle_xfer_chunk,
            "xfer_commit": self._handle_xfer_commit,
            "xfer_pull_begin": self._handle_xfer_pull_begin,
            "xfer_read": self._handle_xfer_read,
            "xfer_pull_end": self._handle_xfer_pull_end,
        }
        # Interrupt discipline: SIGINT (%dist_interrupt / forwarded
        # Ctrl-C) may only surface inside the two *interruptible*
        # windows — the idle recv select (aborts nothing, loop
        # continues) and the handler body (user code; execute converts
        # it to an error reply).  Everywhere else — dispatch
        # bookkeeping, reply construction, the reply send — the gated
        # handler records it as pending for the next window, so a
        # request can never lose its reply and a frame can never be
        # torn mid-write.  (A dropped reply would hang the coordinator
        # forever in the default timeout=None mode.)  The gate decides
        # in the Python handler itself, which CPython always runs on
        # the main thread — so it holds no matter which OS thread the
        # kernel picked for delivery (CUDA/gloo threads spawned during
        # user code inherit an unblocked mask; a pthread-mask scheme
        # is defeated exactly there — see runtime/interrupt.py).
        gate = self._gate
        while not self._shutdown.is_set():
            try:
                # The channel scopes the gate's window to its select
                # wait: bytes can never be lost to an interrupt
                # mid-read (see WorkerChannel.recv); KI surfaces only
                # here.  A frame consumed while VALIDATING a reconnect
                # (the new coordinator's hello) is served first.
                msg = self._resume_msg or self.channel.recv(gate=gate)
                self._resume_msg = None
            except TransportError as e:
                # Coordinator gone.  Flight-record the EOF (with the
                # error text: a postmortem distinguishes "link
                # flapped" — eof then reattach — from "peer died":
                # eof then orphan expiry), then enter orphan grace and
                # wait for a fresh coordinator; only a TTL expiry (or
                # TTL 0) ends this process.
                self._flight.record("transport_eof",
                                    error=str(e)[:120],
                                    host=self._coordinator_host)
                if self._enter_orphan_and_wait():
                    continue
                break
            except KeyboardInterrupt:
                continue  # idle interrupt: nothing to abort
            # Latency observatory: the coordinator flagged
            # this request for stage stamping (`lt: 1`).  One flag
            # check when off — no stamps, no reply header, wire format
            # byte-identical.
            stamp = msg.latency is not None
            t_dq = time.time() if stamp else 0.0
            self._msg_seen += 1
            # A new request proves the coordinator consumed our last
            # reply (the serial request-response protocol: it only
            # sends the next request after reading the previous
            # response), so that reply no longer needs orphan-entry
            # parking — without this, every later orphanhood would
            # repark (and the next attach redeliver) a result the dead
            # coordinator already displayed.  The genuinely in-flight
            # request is still covered: its own reply send fails and
            # parks directly.
            self._last_reply = None
            # Flight event BEFORE the kill check: when an injected (or
            # real) preemption lands mid-request, the ring of the dead
            # process still names the fatal message — the postmortem's
            # anchor fact.
            self._flight.record("dispatch", msg_id=msg.msg_id,
                                type=msg.msg_type, attempt=msg.attempt)
            plan = self._fault_plan
            if plan is not None and plan.should_kill(self.rank,
                                                     self._msg_seen):
                # Injected preemption: die the way a preempted machine
                # does — no teardown, no reply, mid-request.  (No flush
                # needed: the mmap's dirty pages outlive the process.)
                os.kill(os.getpid(), 9)  # SIGKILL
            # Epoch fence (durable sessions): after a reattach raised
            # our session epoch, frames stamped with an older one come
            # from a coordinator that no longer owns this fleet — a
            # stale kernel must be able to learn that, but never to
            # execute, mutate, or SHUT DOWN the fleet (checked before
            # the shutdown branch on purpose).  Only a hello can raise
            # the epoch, so it is exempt here.
            if (msg.epoch is not None and self._epoch
                    and msg.epoch < self._epoch
                    and msg.msg_type != "hello"):
                obs_metrics.registry().counter(
                    "nbd_epoch_rejected",
                    "frames rejected from a stale-epoch "
                    "coordinator").inc()
                self._flight.record("epoch_rejected", msg_id=msg.msg_id,
                                    type=msg.msg_type,
                                    frame_epoch=msg.epoch,
                                    epoch=self._epoch)
                try:
                    self.channel.send(msg.reply(
                        data={"error": f"stale coordinator epoch "
                                       f"{msg.epoch} (this fleet was "
                                       f"reattached at epoch "
                                       f"{self._epoch}); request "
                                       f"ignored",
                              "stale_epoch": True},
                        rank=self.rank))
                except Exception:
                    pass
                continue
            if msg.msg_type == "shutdown":
                break  # no response, by protocol (reference: worker.py:205)
            cached = self._replay.get(msg.msg_id)
            if cached is not None:
                # Redelivered request (retry layer or duplicated
                # frame): answer from the replay cache — NEVER run a
                # request twice (a re-run execute would double-apply
                # user state mutations).
                self._tracer.instant(f"dedup/{msg.msg_type}",
                                     kind="dedup",
                                     attrs={"msg_id": msg.msg_id,
                                            "attempt": msg.attempt})
                self._flight.record("dedup_hit", msg_id=msg.msg_id,
                                    attempt=msg.attempt)
                # Re-stamp with the CURRENT epoch: a reply cached under
                # a previous tenancy but redelivered to the coordinator
                # that legitimately adopted this worker is canonical,
                # not stale — only a worker still LIVING in the old
                # epoch sends old stamps.
                if self._epoch:
                    cached.epoch = self._epoch
                try:
                    self.channel.send(cached)
                except Exception:
                    # Channel died under the resend: keep the reply
                    # claimable and let recv surface the orphan path.
                    self._park(msg.msg_type, msg.msg_id, cached)
                continue
            handler = handlers.get(msg.msg_type)
            # Per-cell deadline budget (%%distributed --deadline S):
            # rides the execute payload, echoed back on heartbeats so
            # the coordinator's watchdog can escalate a cell that blew
            # its own budget without any coordinator-side bookkeeping.
            deadline = None
            if isinstance(msg.data, dict):
                d = msg.data.get("deadline_s")
                if d is not None:
                    try:
                        deadline = float(d)
                    except (TypeError, ValueError):
                        deadline = None
            self._busy = (msg.msg_type, time.monotonic(), msg.msg_id,
                          deadline, msg.tenant)
            # Dispatch span: a child of the coordinator's send span
            # when the request carried the wire trace context, a root
            # span otherwise.  Activated around the handler so inner
            # spans (cell execution, checkpoint IO, collectives called
            # from user code) nest under it.
            tr = self._tracer
            span = None
            if tr.enabled:
                ctx = msg.trace or {}
                span_attrs = {"msg_id": msg.msg_id,
                              "attempt": msg.attempt}
                if msg.tenant is not None:
                    # Multi-tenant postmortems: export.py folds this
                    # into a per-tenant Perfetto track.
                    span_attrs["tenant"] = msg.tenant
                span = tr.begin(f"handle/{msg.msg_type}", kind="worker",
                                trace_id=ctx.get("tid"),
                                parent_id=ctx.get("sid"),
                                attrs=span_attrs)
            # Stage stamps: handler entry/exit bracket the execute
            # work.  The compile-seconds delta stays in the stamps for
            # the JAX package's wire shape; the port compiles nothing
            # (observability/telemetry.py), so it is 0.
            cs0 = obs_telemetry.compile_seconds() if stamp else 0.0
            xs = time.time() if stamp else 0.0
            xe = 0.0
            try:
                if handler is None:
                    reply = msg.reply(
                        data={"error": f"unknown message type "
                                       f"{msg.msg_type!r}"},
                        rank=self.rank)
                elif gate.main_thread():
                    with gate.window(), tr.activate(span):
                        reply = handler(msg)
                else:
                    with tr.activate(span):
                        reply = handler(msg)
            except KeyboardInterrupt:
                # Interrupt racing a non-execute handler: report and
                # keep serving (execute handles its own, in executor).
                reply = msg.reply(data={"error": "KeyboardInterrupt"},
                                  rank=self.rank)
            except Exception as e:
                reply = msg.reply(
                    data={"error": str(e),
                          "traceback": traceback.format_exc()},
                    rank=self.rank)
            finally:
                if stamp:
                    xe = time.time()
                self._busy = None
                tr.end(span)
            if stamp:
                # Worker-clock stage stamps, riding home in the
                # reply's `lt` header: dequeue, handler entry/exit,
                # compile seconds inside the handler, reply build.
                # The coordinator corrects them onto its timebase with
                # the clock estimator's per-rank offset.
                reply.latency = {
                    "dq": round(t_dq, 6), "xs": round(xs, 6),
                    "xe": round(xe, 6),
                    "cs": round(
                        obs_telemetry.compile_seconds() - cs0, 6),
                    "rs": round(time.time(), 6),
                }
            # Epoch-stamp the reply (worker→coordinator direction): a
            # coordinator that healed replacements while we were
            # partitioned away must reject THIS tenancy's results
            # rather than double-apply them (unstamped when epoch 0 —
            # pre-epoch sessions keep their wire format).
            if self._epoch and reply.epoch is None:
                reply.epoch = self._epoch
            self._replay.put(msg, reply)
            try:
                self.channel.send(reply)  # gate closed: frame is atomic
                self._last_reply = (msg.msg_type, msg.msg_id, reply)
            except Exception:
                # No coordinator to land the result on: park it for
                # redelivery (mutating types) and loop — the next recv
                # raises TransportError, which is the orphan entry.
                self._park(msg.msg_type, msg.msg_id, reply)
                continue
            if self._install_plan is not None:
                # A %dist_chaos 'set' armed during this request: its
                # ack is on the wire, start injecting now.
                self._set_fault_plan(self._install_plan[0])
                self._install_plan = None

    def shutdown(self) -> None:
        """Teardown (reference: worker.py:569-580)."""
        self._flight.record("worker_shutdown", rank=self.rank)
        self._flight.flush()
        self._shutdown.set()
        try:
            self.channel.close()
        except Exception:
            pass
        if self._profiler is not None:
            try:
                self._profiler.stop()
            except Exception:
                pass
        try:
            import torch.distributed as dist
            if dist.is_initialized():
                dist.destroy_process_group()
        except Exception:
            pass


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="nbdistributed_tpu_torch worker")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--coordinator-host", default="127.0.0.1")
    p.add_argument("--control-port", type=int, required=True)
    p.add_argument("--dist-port", type=int, required=True,
                   help="the process group's rendezvous port (rank 0's "
                        "TCP store)")
    p.add_argument("--dist-host", default=None,
                   help="the rendezvous host = rank 0's host (default: "
                        "--coordinator-host)")
    p.add_argument("--backend", default="gpu", choices=["gpu", "cpu"],
                   help="gpu: NCCL on this rank's GPU; cpu: gloo (tests)")
    p.add_argument("--gpu-id", type=int, default=0,
                   help="the CUDA device this rank owns (backend gpu)")
    args = p.parse_args(argv)

    # Install the interrupt gate (closed) before the slow init phase.
    # The HELLO (readiness signal) goes out during __init__, so a
    # %dist_interrupt can arrive while this process is still seeding
    # its namespace — before run() establishes the window discipline.
    # A closed gate makes such an early interrupt *pending* until the
    # first idle recv window, where it aborts nothing and the loop
    # continues — instead of killing a half-initialized worker.
    gate = InterruptGate()
    if threading.current_thread() is threading.main_thread():
        gate.install()

    worker = DistributedWorker(
        rank=args.rank, world_size=args.world_size,
        coordinator_host=args.coordinator_host,
        control_port=args.control_port, dist_port=args.dist_port,
        backend=args.backend, gpu_id=args.gpu_id,
        dist_host=args.dist_host, gate=gate,
        # NBD_FAULT_PLAN (JSON spec): deterministic fault injection
        # from process start — how CI chaos tests seed a worker.
        fault_plan=FaultPlan.from_env())
    try:
        worker.run()
    finally:
        worker.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
