"""The NBD_* environment-knob registry — every env knob in one table.

Every ``NBD_*`` variable the framework (or its tools/bench harness)
reads MUST be declared here.  The declaration is load-bearing three
ways:

- the accessors below are the one choke point for env reads, so a
  typo'd knob name fails fast instead of silently reading nothing;
- ``tools/nbd_lint.py --self`` (analysis/selfcheck.py) walks the tree
  and fails CI on any ``NBD_*`` string that is not declared here, and
  on any declared knob missing from README's configuration reference;
- :func:`knob_table_markdown` renders the README "Configuration
  reference" table from this registry, so docs cannot drift from code.

Stdlib-only and import-light on purpose: resilience/ and
observability/ modules import this at startup.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass(frozen=True)
class Knob:
    name: str
    default: str | None   # shown in docs; None = unset/required-by-context
    kind: str             # str | int | float | bool | json | path
    doc: str
    scope: str = "core"   # grouping for the README table


def _k(name, default, kind, doc, scope="core"):
    return Knob(name, default, kind, doc, scope)


_ALL = (
    # --- core / topology ------------------------------------------------
    _k("NBD_RUN_DIR", None, "path",
       "Shared per-session run directory (flight rings, stack dumps, "
       "session manifest, postmortem bundles). Minted and exported by "
       "the first coordinator when unset."),
    _k("NBD_HOST", "local", "str",
       "This process's host label in a multi-host world (set by the "
       "launch plan; feeds link-fault shaping and per-host status)."),
    _k("NBD_COORD_HOST", "local", "str",
       "The coordinator's host label as seen by a worker (set by the "
       "launch plan; the worker side of each link pair)."),
    _k("NBD_NATIVE", None, "str",
       "Control-plane transport override: 1 = require the native C++ "
       "listener, 0 = force the pure-Python one, unset = auto."),
    _k("NBD_AUTH_TOKEN", None, "str",
       "Shared secret for non-loopback control-plane binds (multi-host "
       "worlds); shipped to workers via their environment."),
    _k("NBD_AGENT_TOKEN", None, "str",
       "Admission secret for dialing nbd_agent host daemons "
       "(%dist_init --agents); distinct from the per-session token."),
    _k("NBD_AGENT_READY", None, "str",
       "Set by tools/nbd_agent.py in its readiness line (internal "
       "handshake marker for launchers that scrape agent stdout)."),
    # --- durable sessions ----------------------------------------------
    _k("NBD_SESSION_TOKEN", None, "str",
       "Durable-session identity a worker was spawned under (set by "
       "%dist_init; proves a reattaching coordinator resumes THIS "
       "session).", "session"),
    _k("NBD_SESSION_EPOCH", "0", "int",
       "Session epoch a worker was spawned under; only a hello "
       "exchange may raise it (stale-coordinator fencing).", "session"),
    _k("NBD_ORPHAN_TTL_S", "600", "float",
       "Seconds an orphaned worker (coordinator gone) keeps running "
       "and reattachable before self-terminating; 0 = legacy exit-on-"
       "disconnect.", "session"),
    _k("NBD_GC_TTL_S", "21600", "float",
       "Stale-run age for %dist_gc / nbd-gc sweeps of abandoned "
       "session run dirs.", "session"),
    # --- retry / redelivery ---------------------------------------------
    _k("NBD_RETRY_TIMEOUT_S", None, "float",
       "Per-attempt response wait; PRESENCE enables request "
       "redelivery.", "retry"),
    _k("NBD_RETRY_ATTEMPTS", "4", "int",
       "Total deliveries per request (1 initial + N-1 redeliveries).",
       "retry"),
    _k("NBD_RETRY_CLASS_BULK_TIMEOUT_S", None, "float",
       "Bulk-class (push/pull/checkpoint) per-attempt budget override.",
       "retry"),
    _k("NBD_RETRY_CLASS_BULK_ATTEMPTS", None, "int",
       "Bulk-class delivery-count override.", "retry"),
    _k("NBD_RETRY_CLASS_CONTROL_TIMEOUT_S", None, "float",
       "Control-class per-attempt budget override.", "retry"),
    _k("NBD_RETRY_CLASS_CONTROL_ATTEMPTS", None, "int",
       "Control-class delivery-count override.", "retry"),
    # --- chaos / fault injection ----------------------------------------
    _k("NBD_FAULT_PLAN", None, "json",
       "Spawn-time deterministic fault-plan spec (the %dist_chaos "
       "knobs as JSON) — CI's chaos entry point.", "chaos"),
    # --- hang watchdog ---------------------------------------------------
    _k("NBD_HANG", "1", "bool",
       "Master switch for hang detection; 0 also drops the heartbeat "
       "collective-position piggyback at worker spawn.", "hang"),
    _k("NBD_HANG_POLL_S", "1.0", "float",
       "Watchdog poll cadence.", "hang"),
    _k("NBD_HANG_SKEW_S", "20", "float",
       "Cross-rank lag persistence before a skew verdict.", "hang"),
    _k("NBD_HANG_STALL_S", "120", "float",
       "Busy-with-zero-collective-progress window before a stall "
       "verdict.", "hang"),
    _k("NBD_HANG_GRACE_S", "15", "float",
       "Pause between escalation-ladder steps.", "hang"),
    _k("NBD_HANG_ESCALATE", "warn,dump", "str",
       "Escalation ladder, comma-separated from: warn, dump, "
       "interrupt, heal.", "hang"),
    _k("NBD_PARTITION_GRACE_S", "30", "float",
       "Whole-host silence grace before a suspected partition is "
       "declared lost and healing proceeds.", "hang"),
    # --- async pipelined executor ------------------------------
    _k("NBD_ASYNC_WINDOW", "0", "int",
       "Async in-flight dispatch window for %%distributed cells: N>0 "
       "streams up to N cells to the workers while earlier ones run "
       "(admission gated by the effects/deps DAG — no RAW/WAR/WAW "
       "hazard with any in-flight cell, at most one collective-"
       "bearing cell in flight; opaque cells drain the window and "
       "serialize).  0 (default) keeps every cell synchronous; "
       "%%distributed --async arms the window for one cell.",
       "pipeline"),
    # --- session gateway / multi-tenant pools -----------------------------
    _k("NBD_POOL_SCHED", "fair", "str",
       "Gateway pool scheduling mode: fair (priority, then least-"
       "served tenant) or fifo (arrival order).", "pool"),
    _k("NBD_POOL_MESH_SLOTS", "1", "int",
       "Concurrent cells the pooled mesh runs (0 = unlimited; the "
       "single-kernel path always runs unlimited).  >1 overlaps "
       "cells, which is only safe when at most one of them can run "
       "collectives — arm NBD_POOL_SCHED_EFFECTS so the effect "
       "analyzer PROVES it instead of you assuming it.", "pool"),
    _k("NBD_POOL_SCHED_EFFECTS", "0", "bool",
       "Effects-aware admission (analysis/effects.py): with more "
       "than one mesh slot, only cells proven collective-free may "
       "overlap a collective-bearing cell; unknown/opaque cells "
       "serialize with an explicit 'serialized: ...' verdict naming "
       "the reason.", "pool"),
    _k("NBD_POOL_QUEUE_DEPTH", "64", "int",
       "Queued-cell bound before the pool sheds the lowest-priority "
       "queued cell with a visible verdict (0 = unbounded).", "pool"),
    _k("NBD_TENANT_MAX_INFLIGHT", "8", "int",
       "Per-tenant queued+active cell cap; a tenant at the cap gets "
       "an explicit rejected verdict (0 = uncapped).", "pool"),
    _k("NBD_POOL_MAX_TENANTS", "8", "int",
       "Tenant headcount a gateway admits; later hellos are refused "
       "at admission.", "pool"),
    # --- elastic pools -----------------------------------------
    _k("NBD_AUTOSCALE_MIN", "1", "int",
       "Autoscaler band floor: the pool never shrinks below this "
       "world size, and a world below it is grown back immediately.",
       "elastic"),
    _k("NBD_AUTOSCALE_MAX", "8", "int",
       "Autoscaler band ceiling: the pool never grows past this "
       "world size.", "elastic"),
    _k("NBD_AUTOSCALE_INTERVAL_S", "5.0", "float",
       "Autoscale observe cadence: how often the gateway feeds load "
       "snapshots (queue depth, serving backlog, queue-stage p95) to "
       "the PoolAutoscaler policy.", "elastic"),
    _k("NBD_AUTOSCALE_UP_QUEUE", "4", "int",
       "Scheduler queue depth above which the pool counts as under "
       "pressure (0 disables this signal).", "elastic"),
    _k("NBD_AUTOSCALE_UP_BACKLOG", "8", "int",
       "Serving-plane pending-request backlog above which the pool "
       "counts as under pressure (0 disables this signal).",
       "elastic"),
    _k("NBD_AUTOSCALE_UP_P95_S", "2.0", "float",
       "Latency-observatory queue-stage p95 (seconds) above which "
       "the pool counts as under pressure (0 disables this signal).",
       "elastic"),
    _k("NBD_AUTOSCALE_SUSTAIN_S", "15", "float",
       "Seconds pressure must persist before a grow fires — a single "
       "spike that clears resets the clock (no flapping).", "elastic"),
    _k("NBD_AUTOSCALE_IDLE_S", "120", "float",
       "Seconds of sustained idleness (nothing queued, active, or "
       "pending) before a shrink fires.", "elastic"),
    _k("NBD_AUTOSCALE_COOLDOWN_S", "60", "float",
       "Post-resize decision blackout: no new grow/shrink decision "
       "fires within this window of the last executed (or failed) "
       "resize.", "elastic"),
    _k("NBD_RESIZE_DRAIN_TIMEOUT_S", "120", "float",
       "Resize drain-barrier bound: seconds to wait for in-flight "
       "cells and decode ticks to finish before the resize is "
       "aborted and the pool resumed at its old size.", "elastic"),
    _k("NBD_COMPILE_CACHE_DIR", None, "path",
       "Persistent XLA compilation-cache directory workers enable at "
       "spawn (jax_compilation_cache_dir) so resized-in workers and "
       "new tenants skip the cold compile.  The gateway daemon "
       "defaults it to <run_dir>/xla-cache for its fleet; set 0/off "
       "to disable entirely.", "elastic"),
    # --- serving plane (%dist_serve) --------------------------------------
    _k("NBD_SERVE_MAX_BATCH", "8", "int",
       "Default KV-slot count (continuous-batching width) of the "
       "serving DecodeServer; one scheduler mesh-slot per KV slot.",
       "serve"),
    _k("NBD_SERVE_MAX_LEN", "512", "int",
       "Default KV-cache length of the serving DecodeServer; a "
       "request whose prompt + budget exceeds it is rejected with an "
       "explicit too-long verdict.", "serve"),
    _k("NBD_SERVE_STEPS", "8", "int",
       "Decode steps per serve_step tick — the interleaving "
       "granularity between decoding and notebook cells on the "
       "worker's serial loop.", "serve"),
    _k("NBD_SERVE_QUEUE_DEPTH", "64", "int",
       "Pending-request bound before the serving plane sheds the "
       "lowest-priority pending request with a visible verdict "
       "(0 = unbounded).", "serve"),
    _k("NBD_SERVE_INFLIGHT", "32", "int",
       "Per-submitting-tenant cap on pending + decoding requests; a "
       "tenant at the cap gets an explicit rejected verdict "
       "(0 = uncapped).", "serve"),
    _k("NBD_SERVE_STEP_TIMEOUT_S", "120", "float",
       "Per serve_step round-trip budget; a timed-out tick is "
       "redelivered under the same message id (replay-cache dedup), "
       "and an exhausted retry budget fails over to the next live "
       "rank.", "serve"),
    # --- serving fast path (paged KV + multi-rank decode) ------
    _k("NBD_KV_BLOCK_TOKENS", "64", "int",
       "Paged-KV block size in tokens: each serving request reserves "
       "ceil((prompt + max_new) / block) fixed-size cache blocks at "
       "admission, so capacity is measured in blocks rather than "
       "sequences.  0 keeps the dense per-slot cache.", "serve"),
    _k("NBD_KV_BLOCKS_PER_RANK", "0", "int",
       "Paged-KV pool size per decode rank.  0 derives the dense "
       "pool's exact capacity (max_batch x ceil(max_len / block)), so "
       "paging alone never refuses a request the dense server would "
       "have taken; set lower to bound HBM and surface explicit "
       "kv-exhausted verdicts.", "serve"),
    _k("NBD_PREFILL_CHUNK_TOKENS", "0", "int",
       "Chunked-prefill segment size for the serving plane: prompts "
       "longer than this stream in one chunk per decode tick, "
       "interleaved with active streams, so a long prompt can never "
       "starve TPOT.  0 keeps monolithic prefill-on-admit.", "serve"),
    _k("NBD_SERVE_DECODE_RANKS", "1", "int",
       "Decode ranks the serving driver shards requests across "
       "(highest live ranks first; rank 0 last — it hosts "
       "jax.distributed).  0 = every live rank.  Each rank runs its "
       "own DecodeServer; the journal-replay failover covers any "
       "subset dying.", "serve"),
    _k("NBD_LOADGEN_RPS", "4", "float",
       "nbd-loadgen: offered request rate (arrivals per second) of "
       "the closed-loop load run.", "serve"),
    _k("NBD_LOADGEN_DURATION_S", "15", "float",
       "nbd-loadgen: length of the offered-arrival schedule; the run "
       "then drains in-flight requests before reporting.", "serve"),
    _k("NBD_LOADGEN_ARRIVAL", "poisson", "str",
       "nbd-loadgen: arrival process — poisson (exponential gaps) or "
       "uniform (fixed 1/RPS gaps).", "serve"),
    _k("NBD_LOADGEN_SEED", "0", "int",
       "nbd-loadgen: seed of the deterministic arrival/length "
       "schedule (same seed + config = same offered load, "
       "byte-for-byte).", "serve"),
    # --- flight recorder / observability ---------------------------------
    _k("NBD_FLIGHT", "1", "bool",
       "Always-on mmap flight recorder; 0 disables.", "observability"),
    _k("NBD_FLIGHT_RING_BYTES", "262144", "int",
       "Flight-recorder ring-file capacity per process.",
       "observability"),
    _k("NBD_LAT", "1", "bool",
       "Latency observatory: per-cell stage attribution (vet/queue/"
       "wire/dispatch/compile/execute/reply/deliver) stamped through "
       "the optional `lt` wire header. 0 drops the stamps and the "
       "header entirely.", "observability"),
    _k("NBD_LAT_RING", "256", "int",
       "Recent per-cell stage records kept for %dist_lat and "
       "/latency.json.", "observability"),
    _k("NBD_LAT_SKEW_WARN_MS", "50", "float",
       "Clock-skew threshold: %dist_status warns when a rank's "
       "estimated |offset| exceeds it (skew degrades merged traces "
       "and stage attribution). 0 disables the warning.",
       "observability"),
    _k("NBD_SERVE_LAT", "1", "bool",
       "Serving observatory: per-request decode lifecycle "
       "attribution (admit/queue/kv_alloc/prefill/decode_wait/"
       "decode/emit/deliver) + per-tick KV/batching utilization "
       "gauges. 0 keeps the ring but drops metric/gauge exports.",
       "observability"),
    _k("NBD_SERVE_LAT_RING", "256", "int",
       "Recent per-request serving stage records (and utilization "
       "samples) kept for %dist_serve lat and /latency.json.",
       "observability"),
    _k("NBD_PERFWATCH_BASELINE", "", "str",
       "nbd-perfwatch: baseline file the perf-regression sentinel "
       "scores loadgen reports against (no default: the port keeps "
       "no baselines file yet, and none measured on another device "
       "applies).", "observability"),
    _k("NBD_PERFWATCH_BAND_SCALE", "1", "float",
       "nbd-perfwatch: uniform multiplier on every baseline noise "
       "band (e.g. 2.0 on a noisy shared runner; bands themselves "
       "are pinned in the baseline file).", "observability"),
    _k("NBD_METRICS_PORT", "0", "int",
       "Live scrape endpoint port (GET /metrics Prometheus text, "
       "/healthz, /latency.json) served by the coordinator or "
       "gateway daemon; 0 = off. Also %dist_pool start "
       "--metrics-port (token-gated on pools).", "observability"),
    # --- training integrity guard ------------------------------
    _k("NBD_GUARD", "1", "bool",
       "Master switch for the training-integrity guard's host-side "
       "machinery (verdict resolution, audits, snapshots, rollback, "
       "chaos injection).  The device-side non-finite skip is "
       "compiled into guard=True steps and is unaffected.", "guard"),
    _k("NBD_GUARD_SKIP_BUDGET", "3", "int",
       "Consecutive non-finite-gradient skips tolerated before the "
       "guard rolls back to the last good snapshot (0 = never roll "
       "back on skips).", "guard"),
    _k("NBD_GUARD_AUDIT_EVERY", "50", "int",
       "Steps between replica-consistency audits (param fingerprint "
       "all-gather + majority vote + repair); 0 disables audits.",
       "guard"),
    _k("NBD_GUARD_SNAPSHOT_EVERY", "50", "int",
       "Steps between in-memory rollback snapshots of params + "
       "optimizer state; 0 disables the snapshot ring.", "guard"),
    _k("NBD_GUARD_SNAPSHOT_KEEP", "2", "int",
       "In-memory snapshots retained in the rollback ring.", "guard"),
    _k("NBD_GUARD_CKPT_EVERY", "0", "int",
       "Steps between durable async checkpoints of the guarded state "
       "(coarser than the snapshot ring; also the no-majority audit "
       "fallback's restore source); 0 = no durable cadence.", "guard"),
    _k("NBD_GUARD_CKPT_PATH", None, "str",
       "Directory for the guard's durable checkpoints (required for "
       "NBD_GUARD_CKPT_EVERY and the no-majority restore fallback).",
       "guard"),
    _k("NBD_GUARD_SPIKE_WINDOW", "64", "int",
       "Rolling loss-history window for the median/MAD spike "
       "detector.", "guard"),
    _k("NBD_GUARD_SPIKE_NMAD", "8.0", "float",
       "MADs above the rolling median a finite loss must land to "
       "count as a spike suspect.", "guard"),
    _k("NBD_GUARD_SPIKE_CONFIRM", "2", "int",
       "Consecutive spike-suspect losses before the spike is "
       "confirmed and triggers a rollback.", "guard"),
    _k("NBD_GUARD_QUARANTINE_AFTER", "2", "int",
       "Audits a rank must land in the minority before it is "
       "escalated as a quarantine suspect (0 = never).", "guard"),
    _k("NBD_CORRUPT_SPEC", None, "json",
       "JSON list of bit-flip/scale corruption specs (rank, step, "
       "name, mode, bits, scale, count) merged into the spawn-time "
       "fault plan — %dist_chaos --corrupt's env twin.", "chaos"),
    # --- bulk-transfer plane (messaging/xfer.py) -------------------------
    _k("NBD_XFER_CHUNK_BYTES", str(4 << 20), "int",
       "Chunk size of the streaming bulk-transfer plane: large "
       "pushes/pulls move as pipelined chunks of this many bytes "
       "(floor 64 KiB).", "xfer"),
    _k("NBD_XFER_WINDOW", "8", "int",
       "Credit window: max chunk sub-messages in flight per "
       "transfer — peak extra memory on either side is window x "
       "chunk, never payload size.", "xfer"),
    _k("NBD_XFER_THRESHOLD_BYTES", str(8 << 20), "int",
       "Payloads at or above this ride the chunked transfer plane; "
       "smaller ones keep the legacy single-frame push/pull.",
       "xfer"),
    _k("NBD_XFER_CODEC", "none", "str",
       "Per-chunk compression: none (default), zlib, lz4, zstd, or "
       "auto (cheapest available); each chunk keeps a 'stored' "
       "escape when compression doesn't pay.", "xfer"),
    _k("NBD_XFER_MIN_BYTES_PER_S", str(1 << 20), "int",
       "Floor transfer rate used to scale per-transfer deadlines: "
       "timeout = max(NBD_XFER_MIN_TIMEOUT_S, bytes / this), so "
       "GB-scale moves don't spuriously time out.", "xfer"),
    _k("NBD_XFER_MIN_TIMEOUT_S", "60", "float",
       "Minimum per-transfer deadline (the old fixed push/pull "
       "timeout, now only a floor).", "xfer"),
    _k("NBD_XFER_INBOUND_MAX", "4", "int",
       "Max concurrent incomplete inbound/outbound transfers a "
       "worker holds before LRU-evicting the oldest.", "xfer"),
    # --- static analysis -------------------------------------------------
    _k("NBD_LINT", "warn", "str",
       "Default pre-dispatch cell-vetting mode: warn (annotate), "
       "strict (block cells with error findings), off.", "lint"),
    # --- selftest / bench / tools ---------------------------------------
    _k("NBD_SELFTEST_FAULTS", None, "bool",
       "nbd-selftest: also run the fault-injection smoke section.",
       "harness"),
    _k("NBD_SELFTEST_OBS", None, "bool",
       "nbd-selftest: also run the observability/postmortem sections.",
       "harness"),
    _k("NBD_SELFTEST_SERVE", None, "bool",
       "nbd-selftest: also run the serving smoke section (2-rank "
       "pool, 3 requests, one injected rank kill).", "harness"),
    _k("NBD_NOTEBOOK_BACKEND", "auto", "str",
       "examples/0*_torch_*.ipynb: the backend of the notebooks' "
       "%dist_init (gpu, cpu or auto).", "harness"),
    _k("NBD_NOTEBOOK_WORKERS", "2", "int",
       "examples/0*_torch_*.ipynb: the ranks of the notebooks' "
       "%dist_init (01_torch_parallelism's default is 4).", "harness"),
    _k("NBD_NOTEBOOK_LAYERS", "30", "int",
       "examples/02_torch_finetune.ipynb: the depth of its "
       "SmolLM2-135M checkpoint (the widths stay).", "harness"),
    _k("NBD_NOTEBOOK_CKPT_DIR", None, "str",
       "examples/02_torch_finetune.ipynb: where its checkpoint is "
       "saved and loaded (default: nbd_torch_smol135m_local under the "
       "temporary directory).", "harness"),
    _k("NBD_NOTEBOOK_CK_OUT", None, "str",
       "examples/02_torch_finetune.ipynb: where %dist_checkpoint saves "
       "the tuned params (default: nbd_torch_finetune_ck under the "
       "temporary directory).", "harness"),
    _k("NBD_BENCH_ONLY", None, "str",
       "bench.py: comma-separated benchmark families to run.",
       "harness"),
    _k("NBD_BENCH_WORLD", None, "int",
       "bench.py: world size override for multi-process rows.",
       "harness"),
    _k("NBD_BENCH_FAMILY_BUDGET_S", None, "float",
       "bench.py: per-family wall-clock budget.", "harness"),
    _k("NBD_PROBE_CPU_SMOKE", None, "bool",
       "tools/probe_timing.py: run the CPU smoke variant.", "harness"),
)

KNOBS: dict[str, Knob] = {k.name: k for k in _ALL}

# Dynamically-composed knob-name prefixes (f-string builders like
# retry.py's NBD_RETRY_CLASS_<CLASS>_*).  The self-lint accepts a bare
# string constant ending in "_" only when it is declared here.
PREFIXES: frozenset[str] = frozenset({"NBD_RETRY_CLASS_"})

_FALSE = ("0", "false", "off")


def _declared(name: str) -> Knob:
    k = KNOBS.get(name)
    if k is None:
        raise KeyError(
            f"{name} is not a declared knob — add it to "
            f"nbdistributed_tpu_torch/utils/knobs.py (and README's "
            f"configuration reference)")
    return k


def get_raw(name: str, default: str | None = None, *,
            env=None) -> str | None:
    """The raw env value of a DECLARED knob (None when unset and no
    default given).  ``env`` substitutes a mapping for testing —
    the same convention the from_env constructors already use."""
    _declared(name)
    return (os.environ if env is None else env).get(name, default)


def get_str(name: str, default: str | None = None, *,
            env=None) -> str | None:
    return get_raw(name, default, env=env)


def get_float(name: str, default: float, *, env=None) -> float:
    """Float knob; malformed values fall back to ``default`` (an env
    typo must degrade, not crash a worker at spawn)."""
    raw = get_raw(name, env=env)
    if raw is None:
        return default
    try:
        return float(raw)
    except (TypeError, ValueError):
        return default


def get_int(name: str, default: int, *, env=None) -> int:
    raw = get_raw(name, env=env)
    if raw is None:
        return default
    try:
        return int(raw)
    except (TypeError, ValueError):
        return default


def get_bool(name: str, default: bool = False, *, env=None) -> bool:
    """Bool knob: unset → default; "0"/"false"/"off" (any case) →
    False; anything else truthy."""
    raw = get_raw(name, env=env)
    if raw is None or raw == "":
        return default
    return str(raw).lower() not in _FALSE


def knob_table_markdown() -> str:
    """Render the registry as the README "Configuration reference"
    markdown table (regenerate with ``nbd-lint --knob-table``)."""
    lines = ["| Knob | Default | Type | What it does |",
             "|------|---------|------|--------------|"]
    for k in _ALL:
        default = "–" if k.default is None else f"`{k.default}`"
        lines.append(f"| `{k.name}` | {default} | {k.kind} | {k.doc} |")
    return "\n".join(lines)
