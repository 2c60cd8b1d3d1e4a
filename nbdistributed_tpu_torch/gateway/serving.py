"""The serving plane: continuous-batching generation through the
gateway (``%dist_serve``; counterpart of
``nbdistributed_tpu/gateway/serving.py``).

The tenant plane, admission control, and mailbox discipline
*are* a serving front door; :class:`~..models.serving.DecodeServer` is
the continuous-batching engine.  This module connects them:

* **Request ingress.**  ``serve_submit`` enters a generation request
  as a ticket of the serving :class:`~.scheduler.Scheduler` — one KV
  slot per mesh-slot, the submitting tenant's SLO priority as the
  fair-share key — so overload degrades with the SAME explicit
  verdicts cells get: ``accepted`` (dispatch/queued with a position),
  ``shed`` (queue full, lowest priority lost the round), ``rejected``
  (submitter at its in-flight cap).  The pool never wedges behind a
  flood of prompts.

* **Decode loop.**  A single driver thread ticks the pool: each tick
  sends one ``serve_step`` per *decode rank* (the highest
  ``decode_ranks`` live ranks — see
  :meth:`ServingManager._pick_ranks` for why the fleet fills from the
  top) carrying that rank's admissions/releases and a step budget;
  the worker runs the admissions plus up to ``steps`` decode steps on
  its :class:`DecodeServer` and replies with per-request emissions at
  explicit offsets.  With several decode ranks the steps are
  pre-submitted through the submission/completion split so
  the ranks decode concurrently — continuous batching across the
  whole slice, each request living entirely on ONE rank so
  failover and exactness arguments are unchanged.  Admission is
  bounded by free KV *blocks* per rank (a gateway-side
  :class:`~..serving_fast.paging.BlockAllocator` mirrors each
  worker's paged cache), not just sequence slots.  The worker's
  serial request loop is the interleaving point with notebook cells —
  a decode tick waits its turn like any other request, so serving
  never starves tenants (and vice versa, at step granularity).

* **Durability (the robustness headline).**  An accepted request is
  journaled — prompt, sampling budget, and every emitted token — in
  an append-only :class:`ServeJournal` under the run dir *before* its
  verdict returns.  When the decode rank is SIGKILLed mid-decode (a
  seeded ``FaultPlan``, or a real preemption) the driver fails over to
  the next live rank, re-opens a fresh ``DecodeServer`` there, and
  **re-admits every unfinished request from its journal**: the new
  prompt is ``prompt + emitted-prefix`` and the budget is what
  remains, so greedy decoding continues where it stopped.  On the
  CPU's plain path prefill of a prefix computes the same cache rows
  decode did, so the continuation is bit-identical; on the GPU the
  prefill kernel (K1) and the decode kernel (K4) round differently,
  so a replayed stream may leave the uninterrupted one only at a
  near-tie of its top-2 logits.  Every
  emission carries its worker-side offset; the journal's length is
  the delivery cursor, so redelivered or replayed tokens are DROPPED
  by offset (``nbd_serve_dup_dropped_total`` — pinned to zero by the
  chaos tests) and each request's stream is emitted exactly once.

* **Delivery.**  Tokens stream to the submitting tenant's live
  connection as ``serve_tokens`` notices with offsets; a kernel that
  reattaches mid-generation resumes with ``serve_stream`` from its
  last acked offset.  A request that finishes while its tenant has no
  kernel parks a terminal ``serve_done`` reply in that tenant's
  mailbox partition — the delivered-or-parked-exactly-once
  discipline extended to generation results.

Thread discipline: ``self._lock`` guards the request table and
counters; helpers suffixed ``_locked`` expect their callers to hold
it.  All wire IO (``send_to_ranks``, journal
appends) happens OUTSIDE the lock; the journal serializes its file
writes with its own lock and is always acquired under the manager
lock-free path or strictly after ``self._lock`` (acyclic order).
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from collections import deque

from ..messaging.codec import Message
from ..observability import latency as obs_latency
from ..observability import metrics as obs_metrics
from ..observability.servingobs import ServingObservatory
from ..serving_fast.paging import BlockAllocator, blocks_needed
from ..utils import knobs
from .scheduler import ACTIVE, SchedPolicy, Scheduler
from .scheduler import SHED as TICKET_SHED

# Request lifecycle (gateway-side; scheduler states are the admission
# half, these are the serving half).
ACCEPTED = "accepted"
COMPLETED = "completed"
SHED_V = "shed"
REJECTED_V = "rejected"
FAILED = "failed"

SERVE_JOURNAL_NAME = "serve-{tenant}.jsonl"

# A migrated tenant's journal records, staged by ``tenant_import``
# for the destination's serving plane to adopt at its next
# start.  Named so the export scan below re-exports an unconsumed
# stash on a second migration hop.
SERVE_MIGRATED_NAME = "serve-migrated-{tenant}.jsonl"
_MIGRATED_PREFIX = "serve-migrated-"


def journal_path(run_dir: str, tenant: str) -> str:
    return os.path.join(run_dir, SERVE_JOURNAL_NAME.format(tenant=tenant))


def migrated_journal_path(run_dir: str, tenant: str) -> str:
    return os.path.join(run_dir,
                        SERVE_MIGRATED_NAME.format(tenant=tenant))


def export_tenant_journal(run_dir: str, tenant: str, *,
                          cap: int = 32 << 20) -> str:
    """Every serving-journal line that belongs to ``tenant`` across
    ALL journals under ``run_dir``, as a journal-formatted string
    (empty when the tenant has no serving history).

    A serving plane's journal is keyed by the SERVING tenant and
    interleaves every submitter's records, so a migrating tenant's
    lines must be filtered out of each — matching the ``accept``
    records' ``tenant`` field, then keeping the matched rids' ``emit``
    and ``done`` lines.  Unconsumed migrated stashes are scanned too
    (their names share the ``serve-`` prefix), so a tenant that hops
    pools twice before serving carries its history the whole way."""
    out: list[str] = []
    size = 0
    try:
        names = sorted(os.listdir(run_dir))
    except OSError:
        return ""
    for fn in names:
        if not fn.startswith("serve-") or not fn.endswith(".jsonl"):
            continue
        rids: set = set()
        try:
            with open(os.path.join(run_dir, fn),
                      encoding="utf-8") as f:
                for line in f:
                    line = line.rstrip("\n")
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue   # torn tail (death mid-write)
                    if not isinstance(rec, dict):
                        continue
                    if rec.get("e") == "accept":
                        if rec.get("tenant") != tenant:
                            continue
                        rids.add(rec.get("rid"))
                    elif rec.get("rid") not in rids:
                        continue
                    size += len(line) + 1
                    if size > cap:
                        return "\n".join(out) + "\n"
                    out.append(line)
        except OSError:
            continue
    return ("\n".join(out) + "\n") if out else ""


def merge_emission(have: int, base: int, offset: int,
                   toks: list[int]) -> tuple[list[int], int]:
    """Offset-deduplicated merge of one worker emission into a stream
    that already holds ``have`` tokens.

    ``base`` is the stream offset the request's CURRENT placement
    started at (0 for a first admission; the journaled prefix length
    after a re-admission), ``offset`` the worker-side offset of this
    emission within that placement.  Returns ``(new_tokens,
    dup_count)``: the suffix beyond ``have`` and how many tokens were
    dropped as already-delivered (a replayed or redelivered emission).
    A *gap* (emission starts beyond ``have``) cannot happen under the
    protocol — the driver only advances the journal on received
    replies — and is surfaced as ``(None, 0)`` so the caller can
    refuse to journal around a hole instead of silently corrupting
    the stream.
    """
    goff = base + offset
    if goff > have:
        return None, 0
    skip = have - goff
    if skip >= len(toks):
        return [], len(toks)
    return list(toks[skip:]), skip


class ServeJournal:
    """Append-only JSONL journal of accepted requests and their token
    streams — the durability core.  One line per event::

        {"e": "accept", "rid": r, "tenant": t, "prompt": [...],
         "max_new": n, "prio": p}
        {"e": "emit", "rid": r, "o": offset, "t": [tokens]}
        {"e": "done", "rid": r, "status": "completed"|"shed"|"failed"}

    The file handle is opened once (append mode) and each event is
    written + flushed under the journal's own lock, so concurrent
    submit threads and the driver thread interleave whole lines.
    :meth:`load` tolerates a torn final line (the process died
    mid-write) exactly like the manifest readers do.
    """

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._f = open(path, "a", encoding="utf-8")

    def _append(self, rec: dict) -> None:
        line = json.dumps(rec, separators=(",", ":"))
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()

    def accept(self, rid: str, tenant: str, prompt: list[int],
               max_new: int, priority: int) -> None:
        self._append({"e": "accept", "rid": rid, "tenant": tenant,
                      "prompt": list(prompt), "max_new": int(max_new),
                      "prio": int(priority)})

    def emit(self, rid: str, offset: int, toks: list[int]) -> None:
        self._append({"e": "emit", "rid": rid, "o": int(offset),
                      "t": list(toks)})

    def done(self, rid: str, status: str) -> None:
        self._append({"e": "done", "rid": rid, "status": status})

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass

    @staticmethod
    def load(path: str) -> dict[str, dict]:
        """Replay the journal into ``{rid: {"tenant", "prompt",
        "max_new", "prio", "tokens", "done"}}``.  Emissions are merged
        by offset with the same dedup rule the live path uses, so a
        journal that recorded a replayed emission twice still loads a
        single exact stream."""
        out: dict[str, dict] = {}
        try:
            with open(path, encoding="utf-8") as f:
                lines = f.read().splitlines()
        except OSError:
            return out
        for line in lines:
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn tail (death mid-write) — skip
            if not isinstance(rec, dict):
                continue
            e, rid = rec.get("e"), rec.get("rid")
            if rid is None:
                continue
            if e == "accept":
                out[rid] = {"tenant": rec.get("tenant"),
                            "prompt": list(rec.get("prompt") or ()),
                            "max_new": int(rec.get("max_new") or 0),
                            "prio": int(rec.get("prio") or 0),
                            "tokens": [], "done": None}
            elif e == "emit" and rid in out:
                r = out[rid]
                new, _dup = merge_emission(len(r["tokens"]), 0,
                                           int(rec.get("o") or 0),
                                           list(rec.get("t") or ()))
                if new:
                    r["tokens"].extend(new)
            elif e == "done" and rid in out:
                out[rid]["done"] = rec.get("status") or COMPLETED
        return out

    @staticmethod
    def unfinished(state: dict[str, dict]) -> list[dict]:
        """Re-admission plan from :meth:`load` output: every accepted
        request without a terminal record, as ``{"rid", "tenant",
        "prompt" (original + emitted prefix), "max_new" (remaining),
        "base" (tokens already delivered), "prio"}`` — exactly the
        admit the driver sends after a heal."""
        plan = []
        for rid, r in state.items():
            if r["done"] is not None:
                continue
            emitted = r["tokens"]
            remaining = r["max_new"] - len(emitted)
            if remaining <= 0:
                continue
            plan.append({"rid": rid, "tenant": r["tenant"],
                         "prompt": list(r["prompt"]) + list(emitted),
                         "max_new": remaining, "base": len(emitted),
                         "prio": r["prio"]})
        return plan


class _Req:
    __slots__ = ("rid", "tenant", "prompt", "max_new", "priority",
                 "tokens", "state", "base", "placed", "replay",
                 "ticket", "released", "submitted_ts", "finished_ts",
                 "resumes", "stream_resumed", "error",
                 "placed_ts", "first_tok_ts", "last_emit_ts",
                 "first_batch", "rank")

    def __init__(self, rid: str, tenant: str, prompt: list[int],
                 max_new: int, priority: int, ticket):
        self.rid = rid
        self.tenant = tenant
        self.prompt = prompt
        self.max_new = max_new
        self.priority = priority
        self.tokens: list[int] = []
        self.state = ACCEPTED          # accepted | completed | shed | failed
        self.base = 0                  # stream offset of current placement
        self.placed = False            # admitted to a decode rank
        self.rank: int | None = None   # which decode rank holds it
        self.replay = False            # next admit is a journal replay
        self.released = False          # host-side record freed worker-side
        self.ticket = ticket
        self.submitted_ts = time.time()
        self.finished_ts: float | None = None
        self.resumes = 0               # journal re-admissions (heals)
        self.stream_resumed = False    # counted one client resume
        self.error: str | None = None
        # SLO stamps: first KV-slot placement, first token
        # arrival (TTFT), newest emission arrival (TPOT gaps), and the
        # size of the first emission batch (excluded from the
        # per-token rate — it includes prefill).
        self.placed_ts: float | None = None
        self.first_tok_ts: float | None = None
        self.last_emit_ts: float | None = None
        self.first_batch = 0


class _RankLost(RuntimeError):
    """A decode rank died or stopped answering: fail over.

    ``rank`` names the lost rank so the multi-rank driver un-places
    only ITS requests; ``None`` means "whoever is open" (the legacy
    single-rank paths)."""

    def __init__(self, msg: str, rank: int | None = None):
        super().__init__(msg)
        self.rank = rank


class ServingManager:
    """One serving tenant's request plane + decode driver.

    Owned by the :class:`~.daemon.GatewayDaemon` (``serve_start``),
    but deliberately decoupled from it: the constructor takes the
    coordinator-side ``comm`` plus two delivery callables, so unit
    tests drive the whole admission/journal/failover machinery against
    a fake comm with no pool.

    ``deliver(tenant_name, reply_message)`` routes a TERMINAL result
    (delivered-or-parked — the daemon wires it to its mailbox path);
    ``notify(tenant_name, message)`` best-effort pushes a live
    ``serve_tokens`` notice.
    """

    def __init__(self, comm, run_dir: str, *, tenant: str = "serve",
                 params_name: str = "params", cfg_name: str = "cfg",
                 spec: str | None = None,
                 max_batch: int | None = None,
                 max_len: int | None = None, pad_to: int = 16,
                 eos_id: int | None = None, temperature: float = 0.0,
                 steps: int | None = None,
                 step_timeout: float | None = None,
                 queue_depth: int | None = None,
                 inflight: int | None = None,
                 world_size: int | None = None,
                 decode_ranks: int | None = None,
                 kv_block_tokens: int | None = None,
                 kv_blocks: int | None = None,
                 prefill_chunk: int | None = None,
                 kv_quantized: bool = False,
                 deliver=None, notify=None, flight=None):
        self.comm = comm
        self.run_dir = run_dir
        self.tenant = tenant
        self.params_name = params_name
        self.cfg_name = cfg_name
        self.spec = spec
        self.max_batch = max_batch if max_batch is not None \
            else knobs.get_int("NBD_SERVE_MAX_BATCH", 8)
        self.max_len = max_len if max_len is not None \
            else knobs.get_int("NBD_SERVE_MAX_LEN", 512)
        self.pad_to = max(1, int(pad_to))
        self.eos_id = eos_id
        self.temperature = float(temperature)
        self.steps = steps if steps is not None \
            else knobs.get_int("NBD_SERVE_STEPS", 8)
        self.step_timeout = step_timeout if step_timeout is not None \
            else knobs.get_float("NBD_SERVE_STEP_TIMEOUT_S", 120.0)
        qd = queue_depth if queue_depth is not None \
            else knobs.get_int("NBD_SERVE_QUEUE_DEPTH", 64)
        infl = inflight if inflight is not None \
            else knobs.get_int("NBD_SERVE_INFLIGHT", 32)
        self.world_size = world_size if world_size is not None \
            else getattr(comm, "num_workers", 1)
        # Serving fast path: how many decode ranks to drive
        # (0 = every live rank), and the paged-KV geometry mirrored on
        # each of them.  The gateway keeps one accounting
        # BlockAllocator per open rank so admission is bounded by free
        # KV *blocks*, not sequence slots.
        self.decode_ranks = decode_ranks if decode_ranks is not None \
            else knobs.get_int("NBD_SERVE_DECODE_RANKS", 1)
        self.kv_block_tokens = kv_block_tokens \
            if kv_block_tokens is not None \
            else knobs.get_int("NBD_KV_BLOCK_TOKENS", 64)
        kvb = kv_blocks if kv_blocks is not None \
            else knobs.get_int("NBD_KV_BLOCKS_PER_RANK", 0)
        # 0 = derived dense capacity: max_batch rows of max_len each.
        self.kv_blocks_per_rank = int(kvb) if kvb else (
            self.max_batch
            * blocks_needed(self.max_len, self.kv_block_tokens))
        pck = prefill_chunk if prefill_chunk is not None \
            else knobs.get_int("NBD_PREFILL_CHUNK_TOKENS", 0)
        self.prefill_chunk = int(pck) if pck else None
        self.kv_quantized = bool(kv_quantized)
        self._deliver = deliver or (lambda _t, _m: None)
        self._notify = notify or (lambda _t, _m: None)
        self._flight = flight
        # One KV slot per scheduler mesh-slot: a granted ticket IS a
        # free slot on a decode server, so admission, queueing, and
        # shedding reuse the pool scheduler's exact verdict machinery
        # (fair mode: the submitting tenant's SLO priority first).
        # With K decode ranks the mesh has K * max_batch slots; block
        # accounting in _place_admits_locked is the finer-grained gate
        # underneath the ticket.
        n_target = self.decode_ranks if self.decode_ranks > 0 \
            else max(1, self.world_size)
        self.sched = Scheduler(SchedPolicy(
            "fair", mesh_slots=self.max_batch * n_target,
            tenant_inflight=infl, queue_depth=qd))
        self.journal = ServeJournal(journal_path(run_dir, tenant))
        self._lock = threading.Lock()
        self._reqs: dict[str, _Req] = {}
        self._next_rid = 0
        # rank -> gateway-side accounting BlockAllocator (owner = rid),
        # one per OPEN decode rank.  Mirrors the worker's device
        # allocator by construction: both see the same admit/release
        # order, and the free list is deterministic.  The gateway's
        # copy frees at _finish (one tick before the worker processes
        # the release) — optimistic by at most one tick; the worker's
        # DecodeServer keeps an over-admitted request pending until
        # blocks free, so the skew self-heals without a verdict.
        self._open: dict[int, BlockAllocator] = {}
        # rank -> monotonic deadline to avoid it: a rank whose
        # serve_open failed (missing namespace after a reconnect,
        # OOM building the server) must not be retried forever while
        # lower ranks could serve.
        self._avoid: dict[int, float] = {}
        self._stop = threading.Event()
        self._wake = threading.Event()
        # Drain barrier: while _pause is set the driver
        # parks between ticks; _tick_idle is set whenever no decode
        # tick is mid-flight, so pause() can wait for the in-flight
        # tick to FINISH (a tick interrupted mid-step would redeliver
        # into the new epoch and be fenced as stale).
        self._pause = threading.Event()
        self._tick_idle = threading.Event()
        self._tick_idle.set()
        self._driver: threading.Thread | None = None
        self.started_ts = time.time()
        # Counters (all read under the lock for describe()).
        self.accepted = 0
        self.completed = 0
        self.shed = 0
        self.rejected = 0
        self.replayed = 0       # re-admissions after a failover
        self.resumed = 0        # stream resumes from a client offset
        self.failovers = 0
        self.step_retries = 0
        self.dup_dropped = 0
        self.tokens_total = 0
        self.last_error: str | None = None
        # SLO ring: one entry per COMPLETED request —
        # {tenant, ttft, tpot, queue, e2e} seconds — backing the
        # p50/p99 columns of %dist_serve status / %dist_pool status.
        # The histograms below carry the full distributions for
        # /metrics; the ring keeps exact recent percentiles cheap.
        self._slo: deque = deque(maxlen=256)
        # Serving observatory: per-request stage
        # attribution + per-tick utilization telemetry.  Worker
        # emission stamps are corrected through the coordinator's
        # per-rank offset estimator when the comm carries one.
        self.obs = ServingObservatory(
            clock=getattr(comm, "clock", None))
        # Deferred-placement memo: the last set of rids that waited a
        # tick with no rank able to hold them, so the flight ring gets
        # ONE record per defer episode, not one per tick.
        self._last_deferred: frozenset = frozenset()
        # Ranks whose KV gauges were last published (driver thread
        # only): a retired rank's series is zeroed the next tick.
        self._gauged_ranks: set[int] = set()

    def _slo_hist(self, name: str, help: str, tenant: str):
        """Per-SUBMITTING-tenant SLO histogram, resolved through the
        registry at every use so tenant eviction's
        ``remove_label_series("tenant", name)`` really retires the
        series (the no-cached-handles rule metrics.py documents)."""
        return obs_metrics.registry().histogram(
            name, help, {"tenant": tenant},
            buckets=obs_metrics.LATENCY_BUCKETS)

    # ------------------------------------------------------------------
    # lifecycle

    def start(self, *, spec_timeout: float = 600.0) -> dict:
        """Seed the serving tenant's namespace (run the model-spec
        cell on every live rank) and start the decode driver.  Raises
        on a spec error — a serving plane without a model is refused
        at start, not discovered at the first submit.

        A pre-existing journal for this tenant (the previous daemon
        died, or a serve_stop/serve_start cycle) is RECOVERED first:
        every journaled request without a terminal record is re-entered
        through the scheduler and re-admitted from prompt + emitted
        prefix — "accepted" survives gateway death too, not just rank
        death."""
        self._recover_from_journal()
        if self.spec:
            live = self._live_ranks()
            if not live:
                raise RuntimeError("no live ranks to serve on")
            resps = self.comm.send_to_ranks(
                live, "execute",
                {"code": self.spec, "target_ranks": live},
                tenant=self.tenant, timeout=spec_timeout)
            for r, m in resps.items():
                err = (m.data or {}).get("error")
                if err:
                    raise RuntimeError(
                        f"model spec failed on rank {r}: {err}")
        self._driver = threading.Thread(target=self._run,
                                        name=f"nbd-serve-{self.tenant}",
                                        daemon=True)
        self._driver.start()
        self._record("serve_start", tenant=self.tenant,
                     max_batch=self.max_batch, max_len=self.max_len)
        return self.describe()

    def _recover_from_journal(self) -> None:
        """Re-enter every journaled-but-unfinished request from a
        previous serving plane's journal (same run dir + tenant).
        Each one goes back through the scheduler under its original
        submitter and priority, carries its already-emitted prefix
        (the offset dedup takes it from there), and counts as a
        replay.  Over-budget admission at recovery (a smaller queue
        than the previous plane's) sheds with a delivered verdict —
        never silently.  Migrated tenants' staged journals
        are adopted right after."""
        state = ServeJournal.load(self.journal.path)
        recovered = self._readmit_state(state) if state else 0
        if recovered:
            self._record("serve_recovered", n=recovered)
            obs_metrics.registry().counter(
                "nbd_serve_recovered_total",
                "journaled requests re-entered by a successor "
                "serving plane", {"tenant": self.tenant}).inc(recovered)
            self._wake.set()
        self._consume_migrated(set(state))

    def _readmit_state(self, state: dict) -> int:
        """Re-enter loaded journal state; returns how many unfinished
        requests were re-admitted."""
        recovered = 0
        for rid, r in sorted(state.items()):
            # Keep fresh rids past every journaled one, finished or
            # not — reusing a rid would cross-wire journal streams.
            try:
                n = int(rid.lstrip("r"))
            except ValueError:
                n = -1
            with self._lock:
                self._next_rid = max(self._next_rid, n + 1)
                known = rid in self._reqs
            if known:
                continue
            if r["done"] is not None \
                    or len(r["tokens"]) >= r["max_new"]:
                continue
            self.obs.begin(rid, r["tenant"] or "unknown")
            ticket = self.sched.submit(r["tenant"] or "unknown", rid,
                                       r["prio"])
            req = _Req(rid, r["tenant"], list(r["prompt"]),
                       r["max_new"], r["prio"], ticket)
            req.tokens = list(r["tokens"])
            req.replay = True
            with self._lock:
                self._reqs[rid] = req
                self.accepted += 1
            recovered += 1
            if ticket.verdict.get("status") in ("shed", "rejected"):
                self._finish(req, SHED_V,
                             error="journaled request shed at "
                                   "recovery: the restarted serving "
                                   "plane's admission bounds could "
                                   "not re-admit it")
        return recovered

    def _consume_migrated(self, own_rids: set) -> None:
        """Adopt migrated tenants' staged journals (written by
        ``tenant_import``): re-journal their records into OUR journal
        first — durability must transfer before the stash is deleted —
        then re-admit the unfinished ones and remove the stash.  A
        crash between re-journal and unlink leaves a stash whose rids
        are already in our journal; the collision skip makes the next
        consume a no-op, so adoption happens at most once.  Stated
        limit: rids are per-pool monotonic (``r{n}``), so a migrated
        rid the destination ALREADY used names a different request —
        those are skipped and flight-recorded, never cross-wired."""
        try:
            names = sorted(os.listdir(self.run_dir))
        except OSError:
            return
        adopted = 0
        for fn in names:
            if not fn.startswith(_MIGRATED_PREFIX) \
                    or not fn.endswith(".jsonl"):
                continue
            path = os.path.join(self.run_dir, fn)
            state = ServeJournal.load(path)
            fresh = {rid: r for rid, r in state.items()
                     if rid not in own_rids}
            if len(fresh) < len(state):
                self._record("serve_migrated_rid_collision",
                             stash=fn, n=len(state) - len(fresh))
            for rid, r in sorted(fresh.items()):
                self.journal.accept(rid, r["tenant"] or "unknown",
                                    r["prompt"], r["max_new"],
                                    r["prio"])
                if r["tokens"]:
                    self.journal.emit(rid, 0, r["tokens"])
                if r["done"] is not None:
                    self.journal.done(rid, r["done"])
                own_rids.add(rid)
            adopted += self._readmit_state(fresh)
            try:
                os.remove(path)
            except OSError:
                pass
        if adopted:
            self._record("serve_migrated_adopted", n=adopted)
            obs_metrics.registry().counter(
                "nbd_serve_migrated_total",
                "migrated journal requests adopted by a destination "
                "serving plane", {"tenant": self.tenant}).inc(adopted)
            self._wake.set()

    def pause(self, *, timeout: float = 30.0) -> bool:
        """Arm the serving half of the resize drain barrier: no new
        decode tick starts, and this call returns once the in-flight
        tick (if any) has finished — True when the driver is known
        parked, False on timeout (the resize proceeds anyway; a tick
        caught mid-step redelivers into the new epoch and is fenced
        by the ``ep`` header like any stale frame).  Submits keep
        being ACCEPTED and journaled throughout — accepted requests
        are never lost to a resize, they just wait for the new
        fleet."""
        self._pause.set()
        self._wake.set()
        if self._driver is None or not self._driver.is_alive():
            return True
        ok = self._tick_idle.wait(timeout)
        self._record("serve_paused", drained=ok)
        return ok

    def resume_after_resize(self, world_size: int) -> None:
        """The fleet was resized (new epoch, new world): retarget the
        driver.  Everything placed on the old fleet is un-placed and
        marked for journal replay — the re-admission path that already
        carries requests across rank death and gateway restarts — and
        the model spec is re-run on the new fleet so serve_open finds
        its params (the resized-in workers' namespaces start empty;
        they load the kernels already built, so the re-seed compiles
        nothing)."""
        with self._lock:
            self.world_size = int(world_size)
            self._open.clear()
            self._avoid.clear()
            for r in self._reqs.values():
                r.rank = None
                if r.state == ACCEPTED and r.placed:
                    r.placed = False
                    r.replay = True
        if self.spec:
            live = self._live_ranks()
            if live:
                try:
                    resps = self.comm.send_to_ranks(
                        live, "execute",
                        {"code": self.spec, "target_ranks": live},
                        tenant=self.tenant, timeout=600.0)
                    errs = {r: (m.data or {}).get("error")
                            for r, m in resps.items()
                            if (m.data or {}).get("error")}
                    if errs:
                        self._record("serve_reseed_error", errors={
                            str(r): str(e)[:200]
                            for r, e in errs.items()})
                except Exception as e:
                    # The driver's serve_open path will keep retrying
                    # (and avoiding failed ranks); the journal holds
                    # every accepted request meanwhile.
                    self._record("serve_reseed_error",
                                 error=f"{type(e).__name__}: {e}")
        self._pause.clear()
        self._wake.set()
        self._record("serve_resized", world_size=world_size)

    def stop(self, *, close_workers: bool = True) -> None:
        self._stop.set()
        self._wake.set()
        d = self._driver
        if d is not None and d is not threading.current_thread():
            d.join(timeout=max(5.0, self.step_timeout + 5.0))
        if close_workers:
            try:
                self.comm.post(self._live_ranks(), "serve_close",
                               {"tenant": self.tenant})
            except Exception:
                pass
        self.journal.close()
        self._record("serve_stop", tenant=self.tenant)

    # ------------------------------------------------------------------
    # ingress (tenant-plane threads)

    def submit(self, tenant_name: str, prompt, max_new: int, *,
               priority: int = 0) -> dict:
        """Admit one generation request; returns its explicit verdict.

        ``{"status": "accepted", "rid": ..., "queued": bool,
        "position": n?}`` — journaled, will decode;
        ``{"status": "shed"| "rejected", ...}`` — refused with the
        reason; nothing journaled.  Accepted-then-shed (a LATER burst
        pushed this request out of the bounded queue) is delivered as
        a terminal shed verdict through the mailbox discipline."""
        reg = obs_metrics.registry()
        try:
            prompt = [int(t) for t in prompt]
        except (TypeError, ValueError):
            return {"status": REJECTED_V, "reason": "bad-prompt",
                    "error": "prompt must be a list of token ids"}
        if not prompt or max_new < 1:
            return {"status": REJECTED_V, "reason": "bad-prompt",
                    "error": "prompt must be non-empty and "
                             "max_new_tokens >= 1"}
        if len(prompt) + int(max_new) > self.max_len:
            return {"status": REJECTED_V, "reason": "too-long",
                    "error": f"prompt ({len(prompt)}) + max_new_tokens "
                             f"({max_new}) exceeds the server's "
                             f"max_len {self.max_len}"}
        # Block-capacity admission: a request whose
        # worst-case KV footprint exceeds a whole rank's block pool can
        # NEVER be placed — refuse it now with an explicit verdict
        # instead of letting it starve in the queue forever.
        need = blocks_needed(len(prompt) + int(max_new),
                             self.kv_block_tokens)
        if need > self.kv_blocks_per_rank:
            # Capacity decision on the flight ring: the
            # allocator state that drove it is static here — no rank
            # can EVER hold this footprint.
            self._record("serve_kv_reject", tenant=tenant_name,
                         need_blocks=need,
                         kv_blocks_per_rank=self.kv_blocks_per_rank,
                         prompt_len=len(prompt), max_new=int(max_new))
            return {"status": REJECTED_V, "reason": "kv-exhausted",
                    "error": f"request needs {need} KV blocks "
                             f"({len(prompt)} prompt + {max_new} new "
                             f"tokens at {self.kv_block_tokens}/block) "
                             f"but each decode rank has only "
                             f"{self.kv_blocks_per_rank} blocks"}
        with self._lock:
            rid = f"r{self._next_rid}"
            self._next_rid += 1
        self.obs.begin(rid, tenant_name)
        ticket = self.sched.submit(tenant_name, rid, int(priority))
        v = ticket.verdict
        if v["status"] == "rejected":
            with self._lock:
                self.rejected += 1
            reg.counter("nbd_serve_requests_total",
                        "serving requests by admission verdict",
                        {"tenant": self.tenant,
                         "verdict": "rejected"}).inc()
            self.obs.drop(rid)
            return {"status": REJECTED_V,
                    "reason": v.get("reason", "rejected"),
                    "error": f"request rejected: "
                             f"{v.get('reason', 'admission')} — wait "
                             f"for in-flight requests to finish"}
        if v["status"] == "shed":
            with self._lock:
                self.shed += 1
            reg.counter("nbd_serve_requests_total",
                        "serving requests by admission verdict",
                        {"tenant": self.tenant, "verdict": "shed"}).inc()
            self.obs.drop(rid)
            self._shed_victims(v.get("victims") or ())
            return {"status": SHED_V, "reason": "overload",
                    "error": "request shed under overload: the serve "
                             "queue was full and this was the lowest-"
                             "priority pending request — retry, or "
                             "raise priority"}
        # Accepted (dispatch = a KV slot is free now; queued = waits
        # for one).  Journal BEFORE the verdict returns: "accepted"
        # must mean "survives a rank death".
        req = _Req(rid, tenant_name, prompt, int(max_new),
                   int(priority), ticket)
        self.journal.accept(rid, tenant_name, prompt, int(max_new),
                            int(priority))
        with self._lock:
            self._reqs[rid] = req
            self.accepted += 1
        reg.counter("nbd_serve_requests_total",
                    "serving requests by admission verdict",
                    {"tenant": self.tenant, "verdict": "accepted"}).inc()
        self.obs.note_admit(rid)
        self._record("serve_accept", rid=rid, tenant=tenant_name,
                     queued=v["status"] == "queued")
        self._shed_victims(v.get("victims") or ())
        # A CONCURRENT submit may have shed this ticket as a victim in
        # the window before the _reqs insertion above — its
        # _shed_victims found nothing to finish, which would leave the
        # request ACCEPTED-forever (and the driver spinning on work it
        # can never admit).  Re-check after insertion; _finish is
        # idempotent under the lock, so racing a late victim pass is
        # safe.
        if req.ticket.state == TICKET_SHED:
            self._finish(req, SHED_V,
                         error="request shed under overload after "
                               "acceptance: a concurrent burst filled "
                               "the serve queue and this was the "
                               "lowest-priority pending request")
        self._wake.set()
        out = {"status": ACCEPTED, "rid": rid,
               "queued": v["status"] == "queued"}
        if v.get("position") is not None:
            out["position"] = v["position"]
        return out

    def _shed_victims(self, victims) -> None:
        """An admission round shed OTHER pending requests: finish them
        with a terminal shed verdict (their submitters already hold an
        'accepted' — the shed must be delivered, not silent)."""
        for vic in victims:
            rid = vic.get("msg_id")
            with self._lock:
                req = self._reqs.get(rid)
                if req is None or req.state != ACCEPTED:
                    continue
            self._finish(req, SHED_V,
                         error="request shed under overload after "
                               "acceptance: a later burst filled the "
                               "serve queue and this was the lowest-"
                               "priority pending request")

    def result(self, rid: str) -> dict:
        with self._lock:
            req = self._reqs.get(rid)
            if req is None:
                return {"status": "unknown",
                        "error": f"unknown request {rid!r}"}
            return {"status": req.state, "rid": rid,
                    "tokens": list(req.tokens),
                    "done": req.state != ACCEPTED,
                    **({"error": req.error} if req.error else {})}

    def stream(self, rid: str, from_offset: int = 0) -> dict:
        """The reattach-resume path: everything past the client's last
        acked offset, plus done/status so a finished stream closes.

        A *resume* is counted at most once per request, and only when
        the read actually replays tokens the caller did not have
        (``from_offset`` strictly inside the stream) — an incremental
        polling loop that stays caught up never inflates the
        counter."""
        with self._lock:
            req = self._reqs.get(rid)
            if req is None:
                return {"status": "unknown",
                        "error": f"unknown request {rid!r}"}
            o = max(0, int(from_offset))
            resumed = (0 < o < len(req.tokens)
                       and not req.stream_resumed)
            if resumed:
                req.stream_resumed = True
                self.resumed += 1
            toks = list(req.tokens[o:])
            done = req.state != ACCEPTED
            st = req.state
        if resumed:
            obs_metrics.registry().counter(
                "nbd_serve_resumed_total",
                "token streams resumed from a client-acked offset "
                "(reattach mid-generation)",
                {"tenant": self.tenant}).inc()
        return {"status": st, "rid": rid, "offset": o, "tokens": toks,
                "done": done}

    @staticmethod
    def _slo_summary(entries) -> dict:
        """p50/p99 (milliseconds) per SLO metric, overall and per
        submitting tenant, from the recent-completions ring."""
        def stats(vals):
            sv = sorted(v for v in vals if v is not None)
            if not sv:
                return None
            return {"p50": round(obs_latency.percentile(sv, 0.50)
                                 * 1e3, 3),
                    "p99": round(obs_latency.percentile(sv, 0.99)
                                 * 1e3, 3),
                    "n": len(sv)}

        def block(rows):
            out = {}
            for k in ("ttft", "tpot", "queue", "e2e"):
                st = stats([r.get(k) for r in rows])
                if st is not None:
                    out[k + "_ms"] = st
            return out

        if not entries:
            return {}
        out = block(entries)
        tenants = sorted({r["tenant"] for r in entries})
        if len(tenants) > 1:
            out["tenants"] = {
                t: block([r for r in entries if r["tenant"] == t])
                for t in tenants}
        return out

    def describe(self) -> dict:
        with self._lock:
            slo_entries = list(self._slo)
            active = sum(1 for r in self._reqs.values()
                         if r.state == ACCEPTED and r.placed)
            pending = sum(1 for r in self._reqs.values()
                          if r.state == ACCEPTED and not r.placed)
            # "decode_rank" stays the single headline rank (the
            # highest open one) for every older surface;
            # "decode_ranks"/"ranks" carry the multi-rank truth.
            d = {"tenant": self.tenant,
                 "decode_rank": max(self._open) if self._open else None,
                 "decode_ranks": sorted(self._open),
                 "accepted": self.accepted, "completed": self.completed,
                 "shed": self.shed, "rejected": self.rejected,
                 "replayed": self.replayed, "resumed": self.resumed,
                 "failovers": self.failovers,
                 "step_retries": self.step_retries,
                 "dup_dropped": self.dup_dropped,
                 "tokens_total": self.tokens_total,
                 "decoding": active, "pending": pending,
                 "slots": self.max_batch, "max_len": self.max_len,
                 "last_error": self.last_error}
            ranks = {}
            for rank in sorted(self._open):
                alloc = self._open[rank]
                placed = sum(1 for r in self._reqs.values()
                             if r.state == ACCEPTED and r.placed
                             and r.rank == rank)
                ranks[str(rank)] = {"placed": placed,
                                    "kv_used": alloc.used_blocks,
                                    "kv_free": alloc.free_blocks,
                                    "frag": alloc.largest_free_run()}
            d["ranks"] = ranks
            # Per-SUBMITTING-tenant block counts (%dist_serve status).
            by_tenant: dict[str, int] = {}
            used = free = 0
            for alloc in self._open.values():
                used += alloc.used_blocks
                free += alloc.free_blocks
                for rid, n in alloc.snapshot()["owners"].items():
                    req = self._reqs.get(rid)
                    t = req.tenant if req is not None else "unknown"
                    by_tenant[t] = by_tenant.get(t, 0) + n
            d["kv"] = {"block_tokens": self.kv_block_tokens,
                       "blocks_per_rank": self.kv_blocks_per_rank,
                       "used": used, "free": free,
                       "tenants": by_tenant}
        d["scheduler"] = self.sched.snapshot()
        d["slo"] = self._slo_summary(slo_entries)
        # Serving observatory: stage-attribution summary +
        # recent records (the %dist_serve lat table/waterfall source)
        # and per-tick utilization for the status surfaces.
        d["lat"] = self.obs.status_block(records=64)
        return d

    def forget_tenant(self, name: str) -> None:
        """Mirror the pool scheduler's eviction hygiene for the serve
        scheduler's per-submitter stats."""
        try:
            self.sched.forget_tenant(name)
        except Exception:
            pass

    # ------------------------------------------------------------------
    # decode driver (one thread)

    def _record(self, event: str, **kw) -> None:
        fl = self._flight
        if fl is not None:
            try:
                fl.record(event, **kw)
            except Exception:
                pass

    def _live_ranks(self) -> list[int]:
        try:
            dead = self.comm.dead_ranks()
        except Exception:
            dead = set()
        return sorted(set(range(self.world_size)) - set(dead))

    def _pick_ranks(self) -> list[int]:
        """The decode ranks: the HIGHEST ``decode_ranks`` live ranks
        (0 = every live rank), highest first.  Highest, not lowest, on
        purpose — rank 0 hosts the process group's TCPStore, whose
        death takes every other rank's collectives with it (that
        failure class is the supervisor's full-world heal, not a
        serving failover), so the decode fleet fills from the top and
        touches rank 0 last.  Ranks whose serve_open recently failed
        are skipped until their backoff expires; with every live rank
        avoided, the backoff is overridden (retrying beats
        stalling)."""
        live = self._live_ranks()
        if not live:
            return []
        now = time.monotonic()
        with self._lock:
            usable = [r for r in live
                      if self._avoid.get(r, 0.0) <= now]
        pool = usable or live
        k = self.decode_ranks if self.decode_ranks > 0 else len(pool)
        return sorted(pool, reverse=True)[:max(1, min(k, len(pool)))]

    def _has_work_locked(self) -> bool:
        return any(r.state == ACCEPTED for r in self._reqs.values())

    def _run(self) -> None:
        while not self._stop.is_set():
            if self._pause.is_set():
                # Drained: no tick starts until resume_after_resize.
                self._wake.wait(timeout=0.2)
                self._wake.clear()
                continue
            with self._lock:
                work = self._has_work_locked()
            if not work:
                self._wake.wait(timeout=1.0)
                self._wake.clear()
                continue
            self._tick_idle.clear()
            try:
                try:
                    self._tick()
                finally:
                    self._tick_idle.set()
            except _RankLost as e:
                self._on_rank_lost(e.rank)
            except Exception as e:  # never kill the driver
                with self._lock:
                    self.last_error = f"{type(e).__name__}: {e}"
                self._record("serve_driver_error",
                             error=self.last_error)
                if self._stop.wait(0.5):
                    return

    def _unbind_rank_locked(self, rank: int | None) -> None:
        """Detach every request bound to ``rank`` (None = any rank):
        accepted-and-placed ones go back to the journal-replay path;
        finished-but-unreleased ones are marked released — the rank's
        server is gone (or will be reset), so there is nothing left to
        release worker-side.  The rank's accounting allocator is
        dropped with the rank, so no per-request free is needed."""
        for r in self._reqs.values():
            if rank is not None and r.rank != rank:
                continue
            if r.state == ACCEPTED and r.placed:
                r.placed = False
                r.replay = True
            elif r.placed and not r.released:
                r.released = True
            r.rank = None

    def _on_rank_lost(self, rank: int | None = None) -> None:
        """A decode rank died (or stopped answering within the retry
        budget): un-place ITS in-flight requests — the next tick
        re-opens capacity on the remaining live ranks and re-admits
        each one from its journaled prompt + emitted prefix.  With
        ``rank=None`` (a legacy caller, or a loss detected before any
        placement) every open rank is dropped."""
        with self._lock:
            if rank is None:
                lost = sorted(self._open)
                snaps = {str(r): self._open[r].snapshot()
                         for r in lost}
                self._open.clear()
            else:
                gone = self._open.pop(rank, None)
                snaps = {str(rank): gone.snapshot()} \
                    if gone is not None else {}
                lost = [rank]
            self.failovers += 1
            self._unbind_rank_locked(rank)
        obs_metrics.registry().counter(
            "nbd_serve_failovers_total",
            "decode-rank failovers (rank death or step-retry budget "
            "exhausted)", {"tenant": self.tenant}).inc()
        self._record("serve_failover", lost_ranks=lost, kv=snaps)
        for lr in lost:
            # Best-effort: if the rank is merely unreachable (not
            # dead), free its now-orphaned DecodeServer.
            try:
                self.comm.post([lr], "serve_close",
                               {"tenant": self.tenant})
            except Exception:
                pass
        self._stop.wait(0.2)

    def _retire_rank(self, rank: int) -> None:
        """An open rank fell out of the target set (a higher rank
        healed back, or the fleet shrank): move its requests to the
        replay path and close its server.  Not a failover — the rank
        is healthy, just no longer chosen."""
        with self._lock:
            gone = self._open.pop(rank, None)
            if gone is None:
                return
            snap = gone.snapshot()
            self._unbind_rank_locked(rank)
        try:
            self.comm.post([rank], "serve_close",
                           {"tenant": self.tenant})
        except Exception:
            pass
        self._record("serve_rank_retired", rank=rank, kv=snap)

    def _open_on(self, rank: int) -> None:
        resp = self.comm.send_to_ranks(
            [rank], "serve_open",
            {"tenant": self.tenant, "params": self.params_name,
             "cfg": self.cfg_name, "max_batch": self.max_batch,
             "max_len": self.max_len, "pad_to": self.pad_to,
             "eos_id": self.eos_id, "temperature": self.temperature,
             "kv_block_tokens": self.kv_block_tokens,
             "kv_blocks": self.kv_blocks_per_rank,
             "prefill_chunk": self.prefill_chunk,
             "kv_quantized": self.kv_quantized,
             "reset": True},
            tenant=self.tenant, timeout=self.step_timeout)
        err = (resp[rank].data or {}).get("error")
        if err:
            # Back off this rank so the next tick can fail over to a
            # lower live rank instead of wedging on one broken open
            # (e.g. a rank that reconnected after the model spec ran).
            with self._lock:
                self._avoid[rank] = time.monotonic() + 60.0
            raise RuntimeError(f"serve_open failed on rank {rank}: "
                               f"{err}")
        with self._lock:
            # A fresh server has no placements or blocks: anything
            # that thought it lived on this rank must replay.
            self._unbind_rank_locked(rank)
            self._open[rank] = BlockAllocator(self.kv_blocks_per_rank,
                                              self.kv_block_tokens)
            self._avoid.pop(rank, None)
        self._record("serve_open", rank=rank)

    def _place_admits_locked(self) -> tuple[dict, dict, list]:
        """Per-rank placement of requests holding an ACTIVE scheduler
        ticket but not yet placed — first admissions AND journal
        re-admissions (the latter carry the emitted prefix).

        Each request reserves its WORST-CASE block count
        (``ceil((prompt + max_new) / block_tokens)`` of the ORIGINAL
        prompt/budget — invariant across replays, so a re-admission
        reserves exactly what the first placement did) on the open
        rank with a free sequence slot and the most free blocks.  A
        request no rank can hold right now simply waits — blocks free
        as peers finish, and the ticket stays ACTIVE.

        Returns ``(admits, release, qwaits, events)``: per-rank admit
        payload lists, per-rank release rid lists, ``(tenant,
        queue_wait_s)`` for each FIRST placement — observed into the
        SLO histograms by the caller, outside the lock — and flight
        events (placement / defer decisions with the allocator
        snapshots that drove them) the caller records
        outside the lock."""
        admits: dict[int, list[dict]] = {}
        release: dict[int, list[str]] = {}
        qwaits = []
        events: list[dict] = []
        deferred: list[str] = []
        replays = 0
        now = time.time()
        placed_n = {rank: 0 for rank in self._open}
        for r in self._reqs.values():
            if r.state == ACCEPTED and r.placed \
                    and r.rank in placed_n:
                placed_n[r.rank] += 1
        for r in self._reqs.values():
            if r.state != ACCEPTED or r.placed \
                    or r.ticket.state != ACTIVE:
                continue
            need = blocks_needed(len(r.prompt) + r.max_new,
                                 self.kv_block_tokens)
            best = None
            for rank, alloc in self._open.items():
                if placed_n.get(rank, 0) >= self.max_batch \
                        or alloc.free_blocks < need:
                    continue
                if best is None or alloc.free_blocks \
                        > self._open[best].free_blocks:
                    best = rank
            if best is None:
                # Park: the ticket stays ACTIVE and blocks free as
                # peers finish.  The defer decision reaches the flight
                # ring (once per episode) with the occupancy that
                # drove it.
                deferred.append(r.rid)
                continue
            t_alloc0 = time.perf_counter()
            self._open[best].alloc(r.rid, need)
            kv_alloc_s = time.perf_counter() - t_alloc0
            placed_n[best] += 1
            r.rank = best
            r.base = len(r.tokens)
            r.placed = True
            pf_chunk = self.prefill_chunk or self.max_len
            self.obs.note_placed(
                r.rid, best, kv_alloc_s=kv_alloc_s, need_blocks=need,
                pf_total=-(-len(r.prompt) // max(1, pf_chunk)), t=now)
            events.append({"event": "serve_place", "rid": r.rid,
                           "rank": best, "need_blocks": need,
                           "kv_free": self._open[best].free_blocks,
                           "replay": bool(r.replay)})
            if r.placed_ts is None:
                # First placement only: a failover re-admission is a
                # heal, not queue wait.
                r.placed_ts = now
                qwaits.append((r.tenant, now - r.submitted_ts))
            if r.replay:
                r.replay = False
                r.resumes += 1
                self.replayed += 1
                replays += 1
            admits.setdefault(best, []).append(
                {"rid": r.rid,
                 "prompt": list(r.prompt) + list(r.tokens),
                 "max_new": r.max_new - r.base})
        for r in self._reqs.values():
            if r.state != ACCEPTED and r.placed and not r.released \
                    and r.rank in self._open:
                r.released = True
                release.setdefault(r.rank, []).append(r.rid)
        if replays:
            obs_metrics.registry().counter(
                "nbd_serve_replayed_total",
                "requests re-admitted from the journal after a "
                "failover (re-prefill from prompt + emitted prefix)",
                {"tenant": self.tenant}).inc(replays)
        dset = frozenset(deferred)
        if dset and dset != self._last_deferred:
            events.append({
                "event": "serve_defer", "rids": sorted(dset),
                "kv": {str(rank): {
                    "free": a.free_blocks,
                    "largest_run": a.largest_free_run()}
                    for rank, a in self._open.items()}})
        self._last_deferred = dset
        return admits, release, qwaits, events

    def _tick(self) -> None:
        target = self._pick_ranks()
        if not target:
            # Whole pool dead/unreachable: keep the journal and WAIT
            # for a heal — accepted requests survive by contract.  A
            # wait state, not a failover: any prior placement was
            # already un-placed by the rank-lost path.
            self._stop.wait(1.0)
            return
        with self._lock:
            stale = [r for r in self._open if r not in target]
        for rank in stale:
            self._retire_rank(rank)
        for rank in target:
            with self._lock:
                if rank in self._open:
                    continue
            self._open_on(rank)
        with self._lock:
            admits, release, qwaits, events = \
                self._place_admits_locked()
            busy = {r.rank for r in self._reqs.values()
                    if r.state == ACCEPTED and r.placed
                    and r.rank is not None}
            ticks = sorted((set(admits) | set(release) | busy)
                           & set(self._open))
        for ev in events:
            self._record(**ev)
        for tenant_name, wait in qwaits:
            self._slo_hist(
                "nbd_serve_queue_wait_seconds",
                "serving queue wait: submit → first KV-slot placement",
                tenant_name).observe(wait)
        if not ticks:
            self._update_kv_gauges()
            return
        payloads = {rank: {"tenant": self.tenant,
                           "admit": admits.get(rank, []),
                           "release": release.get(rank, []),
                           "steps": self.steps}
                    for rank in ticks}
        replies, lost = self._step_all(payloads)
        for rank in ticks:
            data = replies.get(rank)
            if data is None:
                continue
            if data.get("error"):
                # Whole-step refusal (e.g. the rank lost its serving
                # state): treat like a dead rank — re-open and
                # re-admit from the journal instead of spinning.
                self._record("serve_step_refused", rank=rank,
                             error=str(data["error"])[:200])
                lost.append((rank, str(data["error"])))
                continue
            self._apply_reply(data, rank=rank)
        self._note_tick_util(ticks, replies)
        self._update_kv_gauges()
        if lost:
            # Every received reply above is already applied, so the
            # failover surgery is scoped to the lost rank alone.  With
            # several lost in one tick the rest re-raise next tick.
            rank, why = lost[0]
            raise _RankLost(why, rank=rank)

    def _step_all(self, payloads: dict[int, dict]
                  ) -> tuple[dict[int, dict], list]:
        """One serve_step round per rank.  When the comm supports the
        submission/completion split and more than one rank
        is ticking, every step is pre-submitted so the ranks decode
        CONCURRENTLY — the multi-rank throughput claim — then each
        handle is awaited (wait() drives the same-msg-id redelivery
        schedule).  Otherwise (unit-test fakes, single rank) the
        legacy sequential path runs unchanged.

        Returns ``(replies, lost)`` — every reply that arrived, plus
        ``(rank, reason)`` for ranks that died or exhausted their
        retry budget.  Replies are always harvested before the caller
        surfaces a loss: an abandoned reply would desynchronize the
        emission offsets of the SURVIVING ranks' requests."""
        from ..messaging.coordinator import WorkerDied
        replies: dict[int, dict] = {}
        lost: list = []
        if len(payloads) > 1 and hasattr(self.comm, "submit"):
            handles = {}
            for rank, payload in payloads.items():
                try:
                    handles[rank] = self.comm.submit(
                        [rank], "serve_step", payload,
                        tenant=self.tenant, msg_id=uuid.uuid4().hex,
                        timeout=self.step_timeout)
                except WorkerDied as e:
                    lost.append((rank, str(e)))
                except Exception as e:
                    self._note_step_retry(rank, 0, e)
                    lost.append((rank, f"submit failed: {e}"))
            for rank, h in handles.items():
                try:
                    resp = h.wait()
                    replies[rank] = resp[rank].data or {}
                except WorkerDied as e:
                    lost.append((rank, str(e)))
                except Exception as e:
                    self._note_step_retry(rank, 1, e)
                    with self._lock:
                        self._avoid[rank] = time.monotonic() + 60.0
                    lost.append((rank,
                                 f"step retry budget exhausted: {e}"))
            return replies, lost
        for rank, payload in payloads.items():
            try:
                replies[rank] = self._send_step(rank, payload)
            except _RankLost as e:
                lost.append((rank, str(e)))
        return replies, lost

    def _note_step_retry(self, rank: int, attempt: int,
                         e: Exception) -> None:
        with self._lock:
            self.step_retries += 1
        obs_metrics.registry().counter(
            "nbd_serve_step_retries_total",
            "serve_step dispatches redelivered after a "
            "timeout (same msg_id; replay-cache dedup)",
            {"tenant": self.tenant}).inc()
        self._record("serve_step_retry", rank=rank,
                     attempt=attempt + 1,
                     error=f"{type(e).__name__}: {e}")

    def _note_tick_util(self, ticks, replies) -> None:
        """One utilization sample per decode tick: batch
        fill / KV occupancy / fragmentation from the gateway-side
        allocator mirrors, prefill-vs-decode token split and worker
        park depth from the serve_step replies' ``tick`` block."""
        pf_toks = dc_toks = 0
        pending: dict[int, int] = {}
        for rank in ticks:
            data = replies.get(rank) or {}
            tk = data.get("tick") or {}
            pf_toks += int(tk.get("pf") or 0)
            dc_toks += int(tk.get("dc") or 0)
            if data.get("pending") is not None:
                pending[rank] = int(data["pending"])
        util_ranks: dict[int, dict] = {}
        with self._lock:
            placed_by: dict[int, int] = {}
            backlog = 0
            for r in self._reqs.values():
                if r.state != ACCEPTED:
                    continue
                if r.placed and r.rank is not None:
                    placed_by[r.rank] = placed_by.get(r.rank, 0) + 1
                elif not r.placed:
                    backlog += 1
            for rank, alloc in self._open.items():
                util_ranks[rank] = {
                    "placed": placed_by.get(rank, 0),
                    "slots": self.max_batch,
                    "kv_used": alloc.used_blocks,
                    "kv_free": alloc.free_blocks,
                    "frag": alloc.largest_free_run(),
                    **({"pending": pending[rank]}
                       if rank in pending else {}),
                }
        self.obs.note_util(ranks=util_ranks, prefill_toks=pf_toks,
                           decode_toks=dc_toks, backlog=backlog,
                           tenant=self.tenant)

    def _update_kv_gauges(self) -> None:
        with self._lock:
            per_rank = {rank: (a.used_blocks, a.free_blocks)
                        for rank, a in self._open.items()}
        reg = obs_metrics.registry()
        # Aggregate series keep their older label shape
        # (rank="all") next to the new per-rank series; everything
        # carries the serving tenant, so tenant eviction's
        # remove_label_series("tenant", ...) retires rank series too.
        used = sum(u for u, _ in per_rank.values())
        free = sum(f for _, f in per_rank.values())
        reg.gauge("nbd_kv_blocks_used",
                  "KV cache blocks allocated per open decode rank "
                  "(rank=\"all\" aggregates the fleet)",
                  {"tenant": self.tenant, "rank": "all"}).set(used)
        reg.gauge("nbd_kv_blocks_free",
                  "KV cache blocks free per open decode rank "
                  "(rank=\"all\" aggregates the fleet)",
                  {"tenant": self.tenant, "rank": "all"}).set(free)
        for rank, (u, f) in per_rank.items():
            reg.gauge("nbd_kv_blocks_used",
                      "KV cache blocks allocated per open decode rank "
                      "(rank=\"all\" aggregates the fleet)",
                      {"tenant": self.tenant,
                       "rank": str(rank)}).set(u)
            reg.gauge("nbd_kv_blocks_free",
                      "KV cache blocks free per open decode rank "
                      "(rank=\"all\" aggregates the fleet)",
                      {"tenant": self.tenant,
                       "rank": str(rank)}).set(f)
        # A retired/lost rank's last gauge value must not linger as a
        # live-looking series: zero it the tick after it closes.  (The
        # series itself is retired with the tenant — never via a rank-
        # label sweep, which would hit other metrics' rank series.)
        stale = self._gauged_ranks - set(per_rank)
        for rank in stale:
            reg.gauge("nbd_kv_blocks_used",
                      "KV cache blocks allocated per open decode rank "
                      "(rank=\"all\" aggregates the fleet)",
                      {"tenant": self.tenant,
                       "rank": str(rank)}).set(0)
            reg.gauge("nbd_kv_blocks_free",
                      "KV cache blocks free per open decode rank "
                      "(rank=\"all\" aggregates the fleet)",
                      {"tenant": self.tenant,
                       "rank": str(rank)}).set(0)
        self._gauged_ranks = set(per_rank)

    def _send_step(self, rank: int, payload: dict) -> dict:
        """One serve_step round trip, redelivered under the SAME
        message id on timeouts (the worker replay cache answers a
        request that already ran — decode never double-steps).  A dead
        rank, or a rank that exhausts the retry budget, raises
        :class:`_RankLost` for the failover path."""
        from ..messaging.coordinator import WorkerDied
        mid = uuid.uuid4().hex
        last: Exception | None = None
        for attempt in range(3):
            try:
                resp = self.comm.send_to_ranks(
                    [rank], "serve_step", payload, tenant=self.tenant,
                    msg_id=mid, timeout=self.step_timeout)
                return resp[rank].data or {}
            except WorkerDied as e:
                raise _RankLost(str(e), rank=rank) from e
            except Exception as e:
                last = e
                self._note_step_retry(rank, attempt, e)
                if self._stop.is_set():
                    raise _RankLost("stopping", rank=rank) from e
        # Alive-but-unresponsive: it stays in the live set, so back it
        # off explicitly or the next tick would pick it right back.
        with self._lock:
            self._avoid[rank] = time.monotonic() + 60.0
        raise _RankLost(f"step retry budget exhausted: {last}",
                        rank=rank)

    def _apply_reply(self, data: dict,
                     rank: int | None = None) -> None:
        reg = obs_metrics.registry()
        emitted = data.get("emitted") or {}
        errors = data.get("errors") or {}
        # tick telemetry: the worker's wall clock at reply
        # time (clock-corrected per rank inside the observatory), the
        # tick's compute time, and per-request chunked-prefill
        # progress.
        tick = data.get("tick") or {}
        t_worker = tick.get("now")
        step_s = float(tick.get("step_s") or 0.0)
        pf_chunk = max(1, self.prefill_chunk or self.max_len)
        for rid, wn in (data.get("pfp") or {}).items():
            try:
                written, total = int(wn[0]), int(wn[1])
            except (TypeError, ValueError, IndexError):
                continue
            self.obs.note_prefill_progress(
                rid, -(-written // pf_chunk), -(-total // pf_chunk))
        for rid, err in errors.items():
            with self._lock:
                req = self._reqs.get(rid)
            if req is not None and req.state == ACCEPTED:
                self._finish(req, FAILED, error=str(err))
        for rid, em in emitted.items():
            t_em0 = time.perf_counter()
            with self._lock:
                req = self._reqs.get(rid)
                if req is None or req.state != ACCEPTED:
                    continue
                have = len(req.tokens)
                base = req.base
            new, dup = merge_emission(have, base,
                                      int(em.get("o") or 0),
                                      list(em.get("t") or ()))
            if new is None:
                # A gap would corrupt the stream: fail the request
                # loudly rather than journal around a hole.
                self._finish(req, FAILED,
                             error="emission gap (protocol bug): "
                                   f"offset {base + int(em.get('o') or 0)} "
                                   f"past stream length {have}")
                continue
            if dup:
                with self._lock:
                    self.dup_dropped += dup
                reg.counter(
                    "nbd_serve_dup_dropped_total",
                    "tokens dropped by offset dedup (replayed or "
                    "redelivered emissions) — exactly-once delivery's "
                    "receipt", {"tenant": self.tenant}).inc(dup)
            if not new:
                continue
            self.journal.emit(rid, have, new)
            now = time.time()
            with self._lock:
                req.tokens.extend(new)
                self.tokens_total += len(new)
                done = (len(req.tokens) >= req.max_new
                        or (self.eos_id is not None
                            and self.eos_id in new))
                offset = have
                first = req.first_tok_ts is None
                if first:
                    req.first_tok_ts = now
                    req.first_batch = len(new)
                    ttft = now - req.submitted_ts
                else:
                    gap = ((now - req.last_emit_ts) / len(new)
                           if req.last_emit_ts is not None else None)
                req.last_emit_ts = now
            # Stage attribution: arrival + worker stamp
            # (clock-corrected inside), the tick's decode compute,
            # and the gateway's own emit-handling time so far.
            self.obs.note_emission(
                rid, rank if rank is not None else 0, len(new),
                t_recv=now, t_worker=t_worker,
                emit_s=time.perf_counter() - t_em0)
            self.obs.note_decode(rid, step_s)
            # SLO observations (outside the lock; per-SUBMITTING-
            # tenant labels so eviction retires the series).
            if first:
                self._slo_hist(
                    "nbd_serve_ttft_seconds",
                    "serving time-to-first-token (submit → first "
                    "emission delivered to the gateway)",
                    req.tenant).observe(ttft)
            elif gap is not None:
                # Mean per-token gap of this emission batch — the
                # inter-emission latency the client actually sees.
                self._slo_hist(
                    "nbd_serve_tpot_seconds",
                    "serving per-token inter-emission latency",
                    req.tenant).observe(gap)
            reg.counter("nbd_serve_tokens_total",
                        "generated tokens delivered",
                        {"tenant": self.tenant}).inc(len(new))
            if done:
                self._finish(req, COMPLETED)
            else:
                self._notify_tokens(req, offset, new)

    def _finish(self, req: _Req, status: str,
                error: str | None = None) -> None:
        """Terminal transition: journal the verdict, free the KV slot
        (promoting queued requests), and deliver the result
        delivered-or-parked-exactly-once."""
        slo = None
        with self._lock:
            if req.state != ACCEPTED:
                return
            req.state = status
            req.error = error
            req.finished_ts = time.time()
            # Return the request's KV blocks to its rank's accounting
            # pool.  One tick optimistic versus the worker (which
            # frees at the release in the NEXT serve_step); the
            # worker's DecodeServer parks an early re-admission as
            # pending until its own blocks free, so the skew never
            # corrupts — see the ctor comment on self._open.
            if req.rank is not None:
                alloc = self._open.get(req.rank)
                if alloc is not None:
                    alloc.free(req.rid)
            if status == COMPLETED:
                self.completed += 1
                # SLO record (seconds; None = not applicable): exact
                # recent percentiles for the status surfaces.
                extra_toks = len(req.tokens) - req.first_batch
                slo = {
                    "tenant": req.tenant,
                    "e2e": req.finished_ts - req.submitted_ts,
                    "queue": (req.placed_ts - req.submitted_ts
                              if req.placed_ts is not None else None),
                    "ttft": (req.first_tok_ts - req.submitted_ts
                             if req.first_tok_ts is not None
                             else None),
                    "tpot": ((req.last_emit_ts - req.first_tok_ts)
                             / extra_toks
                             if req.first_tok_ts is not None
                             and req.last_emit_ts is not None
                             and extra_toks > 0 else None),
                }
                self._slo.append(slo)
            elif status == SHED_V:
                self.shed += 1
        rec = self.obs.complete(
            req.rid, status, t_finish=req.finished_ts,
            tracer=getattr(self.comm, "tracer", None))
        if slo is not None and rec is not None \
                and rec.get("tpot_s") is not None:
            # Clock-corrected TPOT (worker emission stamps through
            # the per-rank offset estimator, clamped >= 0) supersedes
            # the gateway-arrival estimate when stamps were present.
            slo["tpot"] = rec["tpot_s"]
        if slo is not None:
            self._slo_hist(
                "nbd_serve_e2e_seconds",
                "serving end-to-end latency (submit → completed)",
                req.tenant).observe(slo["e2e"])
        self.journal.done(req.rid, status)
        self.sched.complete(req.rid)
        self._wake.set()
        obs_metrics.registry().counter(
            "nbd_serve_finished_total",
            "serving requests reaching a terminal state",
            {"tenant": self.tenant, "status": status}).inc()
        self._record("serve_finish", rid=req.rid, status=status,
                     n_tokens=len(req.tokens))
        # Terminal delivery through the mailbox discipline: parked for
        # exactly-once redelivery when the submitter has no kernel.
        # This (not a last serve_tokens notice) is the ONE terminal
        # signal, so a live client never sees the finish twice.
        reply = Message(
            msg_type="serve_done", msg_id=f"serve:{req.rid}",
            data={"status": status, "rid": req.rid,
                  "tokens": list(req.tokens),
                  **({"error": error} if error else {})})
        try:
            self._deliver(req.tenant, reply)
        except Exception:
            pass

    def _notify_tokens(self, req: _Req, offset: int,
                       toks: list[int]) -> None:
        """Best-effort live streaming: tokens push to the submitting
        tenant's connection as they land.  A lost notice costs
        nothing — the journaled stream is claimable via serve_stream
        (offset resume) and the terminal serve_done."""
        msg = Message(msg_type="serve_tokens",
                      data={"rid": req.rid, "o": offset, "t": toks})
        try:
            self._notify(req.tenant, msg)
        except Exception:
            pass
