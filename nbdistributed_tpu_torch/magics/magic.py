"""IPython magics: the user/API layer (counterpart of
``nbdistributed_tpu/magics/magic.py``).

The notebook kernel becomes the coordinator of N worker processes, one
per GPU, with the reference's magic surface under the same names
(reference: magic.py:71-83): ``%dist_init``, ``%%distributed``,
``%%rank``, ``%sync``, ``%dist_interrupt``, ``%dist_status``,
``%dist_logs``, ``%dist_debug``, ``%dist_mode``, ``%dist_pull`` /
``%dist_push``, ``%dist_sync_ide``, ``%dist_checkpoint`` /
``%dist_restore``, ``%timeline_*``, ``%dist_shutdown`` and
``%dist_reset``, plus the auto-distributed input transformer that makes
plain cells run on every worker (reference: magic.py:609-645).  Every
cell is vetted before dispatch (``%dist_lint``; ``analysis/``) and may
stream through the async in-flight window (``%%distributed --async``,
``NBD_ASYNC_WINDOW``, ``%dist_wait``; ``messaging/pipeline.py``);
``%dist_chaos``, ``%dist_profile``, ``%dist_trace``, ``%dist_metrics``,
``%dist_lat`` and ``%dist_top`` observe and perturb the control plane.
Supervision and diagnosis: the hang watchdog ``%dist_init`` arms
(``%dist_watchdog``, ``%dist_doctor``, ``%%distributed --deadline``,
``%dist_status``'s stalled state), ``%dist_heal``, the auto-heal
``%dist_supervise``, postmortem bundles (``%dist_postmortem``, and one
taken when a rank dies unsupervised), ``%dist_guard`` and the scrape
endpoint under ``NBD_METRICS_PORT``.  Names, options and printed text
follow the JAX package; its TPU options become their GPU forms
(``--backend gpu``, ``--gpu-ids``).

Durable sessions and the gateway's tenant plane: ``%dist_attach`` (a
surviving fleet, or ``--tenant NAME`` on a pool), ``%dist_init
--attach``, ``%dist_pool start|status|stop|resize|template|migrate``,
``%%distributed --priority`` in tenant mode and ``%dist_gc``; in tenant
mode ``%dist_status``, ``%dist_top`` and ``%dist_lat`` read the pool.
The gateway's serving plane: ``%dist_serve
start|submit|result|stream|status|lat|stop``.  Multi-host launch:
``%dist_init --hosts h1:2,h2:2 --agents h2=ADDR:PORT --coordinator-addr
ADDR`` spawns each host's ranks directly (``local``), through its host
agent (``tools/nbd_torch_agent.py``) or through ssh; a rank owns one
GPU, so ``host:N`` is N ranks and ``--chips-per-worker`` other than 1
is refused.

``%dist_lint self`` runs the port's ten self-lint passes over the
checkout (:mod:`..analysis.selfcheck`).

This module does not import IPython.  Each magic is a plain method of
:class:`DistributedMagics` taking the magic's line (and its cell), with
its options parsed as IPython parses them (:func:`arg_split`,
``_PARSERS``); :mod:`.ipython_magics` binds them to the shell one line
each.  So where IPython is not installed (the GPU machine's
environment has none) a program drives the same bodies cell by cell.
"""

from __future__ import annotations

import argparse
import os
import re
import shlex
import tempfile
import threading
import time

from ..manager import ProcessManager
from ..messaging import CommunicationManager, WorkerDied
from ..utils import knobs as _knobs
from . import display as display_mod
from . import proxies, rankspec
from .timeline import Timeline

_COLLECTIVE_TOKENS = re.compile(
    r"\b(all_reduce_quantized|all_reduce|all_gather|broadcast|"
    r"reduce_scatter|barrier|psum|pmean|pmax|pmin|ppermute|all_to_all|"
    r"sync_global_devices|shard_map|dist\.(?:scatter|gather|reduce))\b")

# The longest %dist_shutdown / %dist_reset wait for the async window:
# a cell still running after it is cut off by the teardown.
_SHUTDOWN_DRAIN_S = 30.0


_BANNER = """\
✅ {n} workers ready (backend={backend}, attach {secs:.1f}s).

Every cell now runs on ALL workers. Namespace on each worker:
  rank, world_size     — this worker's rank / total workers
  torch, np, dist      — preloaded libraries (dist: torch.distributed,
                         its process group joined: NCCL on the GPU,
                         gloo on the CPU)
  device, gpu_id       — this worker's device / its GPU id
  Mesh, P, shard_map   — sharding toolkit (PartitionSpec as P)
  all_reduce, all_gather, broadcast, barrier, reduce_scatter,
  all_reduce_quantized, scatter, gather, reduce
                       — functional collectives over the process group
  make_mesh, shard_batch, replicate, apply_shardings, ring_attention,
  ulysses_attention, pipeline_forward, shard_stage_params, moe_ffn,
  init_moe_params      — mesh/SP/PP/EP building blocks
  load_hf_pretrained   — HF Llama-family checkpoint → torch tensors
  generate, speculative_generate, DecodeServer
                       — KV-cache decode / draft-verify decoding /
                         continuous-batching serving

Magics: %%rank [0,1] targeted cells · %sync barrier · %dist_interrupt ·
%dist_status · %dist_logs · %dist_debug ·
%%distributed --async (stream cells through the DAG-gated in-flight
window — NBD_ASYNC_WINDOW arms it session-wide) · %dist_wait (drain
the window) · %%distributed --repeat k [--until EXPR] (compile once,
loop worker-side) · %dist_mode -d/-e auto-run off/on ·
%dist_pull/%dist_push vars · %dist_sync_ide ·
%dist_checkpoint/%dist_restore path names (--background, --status) ·
%dist_lint warn|strict|off|status|effects|deps|self (pre-dispatch
cell vetting: rank-conditional collectives, subset hazards,
host-syncs in loops — strict blocks error-severity cells; also
%%distributed --strict per cell; deps|effects render the session's
cell effect footprints and dependency DAG; self runs the framework's
ten self-lint passes) · %dist_chaos (fault injection) ·
%dist_profile start/stop (torch.profiler) · %dist_trace
start/stop/save (Perfetto) · %dist_metrics · %dist_lat (per-cell
stage attribution + waterfall) · %dist_top (live device telemetry) ·
%dist_watchdog (hang watchdog: skew/stall/--deadline verdicts, ladder
warn→dump→interrupt→heal; armed at init unless NBD_HANG=0) ·
%dist_doctor (stuck-cell report: positions, skew, stacks, flight
events) · %%distributed --deadline S · %dist_heal [--restore ckpt] ·
%dist_supervise on|off|status (auto-heal: respawn + restore the last
checkpoint) · %dist_postmortem [--last] (crash bundles) · %dist_guard
status|on|off|audit · %dist_attach [RUN_DIR] (reattach a surviving
fleet; --tenant NAME joins a pool) · %dist_pool start|status|stop|
resize|template|migrate (shared multi-tenant GPU pool; %%distributed
--priority in tenant mode) · %dist_serve start|submit|result|stream|
status|lat|stop (continuous-batching serving on a pool) ·
%dist_gc [--dry-run] (stale run dirs) ·
%timeline_show · %timeline_sidecar (in-notebook persistence) ·
%dist_init --hosts/--agents/--coordinator-addr (multi-host launch
through host agents or ssh; host:N = N ranks, one GPU each) ·
%dist_shutdown (fleet teardown) · %dist_reset
"""


class UsageError(Exception):
    """A magic's arguments do not parse (IPython's ``UsageError``; the
    IPython binding, :mod:`.ipython_magics`, re-raises it as one)."""


def arg_split(line: str) -> list[str]:
    """Split a magic's argument string as IPython does
    (``IPython.utils._process_common.arg_split``): shell-like, but
    non-posix, so quote characters stay inside the tokens — every
    option a user quotes (``--until 'loss < 0.1'``) strips them."""
    lex = shlex.shlex(line, posix=False)
    lex.whitespace_split = True
    lex.commenters = ""
    return list(lex)


class _Parser(argparse.ArgumentParser):
    """IPython's ``MagicArgumentParser``: no ``-h``, and an error
    raises instead of exiting the process."""

    def error(self, message):
        raise UsageError(message)


def _arg(*flags, **kw) -> tuple:
    return flags, kw


def _parser(prog: str, *args: tuple) -> _Parser:
    parser = _Parser(prog=prog, add_help=False)
    for flags, kw in args:
        parser.add_argument(*flags, **kw)
    return parser


def _parse(magic: str, line: str) -> argparse.Namespace:
    return _PARSERS[magic].parse_args(arg_split(line))


# Each magic's options, as the JAX package's ``@argument`` decorators
# declare them.
_PARSERS = {
    "dist_init": _parser(
        "dist_init",
        _arg("-n", "--num-workers", type=int, default=2,
             help="number of worker processes (one per GPU)"),
        _arg("--backend", default="auto", choices=["auto", "cpu", "gpu"],
             help="gpu: one GPU a rank over NCCL; cpu: gloo; auto: the "
                  "GPU, raising on a host without one"),
        _arg("-t", "--timeout", type=float, default=None,
             help="per-request timeout in seconds (default: none — "
                  "training mode)"),
        _arg("--chips-per-worker", type=int, default=1,
             help="accelerators owned by each worker process (a rank "
                  "owns one GPU; other values are refused)"),
        _arg("--gpu-ids", default=None,
             help="explicit GPU ids, comma-separated (e.g. '2,3') — "
                  "pin workers to specific GPUs, recycled modulo the "
                  "list's length"),
        _arg("--attach-timeout", type=float, default=180.0,
             help="seconds to wait for workers to come up"),
        _arg("--hosts", default=None,
             help="multi-host spec 'h1,h2:2,local' (host:N = N ranks, "
                  "one GPU each, --gpu-id = the local rank); requires "
                  "--coordinator-addr for remote hosts"),
        _arg("--coordinator-addr", default="127.0.0.1",
             help="address of this kernel reachable from every host"),
        _arg("--agents", default=None,
             help="host-agent endpoints 'h1=10.0.0.2:7411,h2=...' — "
                  "remote hosts listed here launch through their "
                  "agent daemon (tools/nbd_torch_agent.py) instead of "
                  "ssh"),
        _arg("--attach", nargs="?", const="", default=None,
             dest="attach_dir",
             help="reattach to a surviving fleet instead of spawning "
                  "one (optionally naming its run dir) — alias for "
                  "%%dist_attach"),
    ),
    "distributed": _parser(
        "distributed",
        _arg("--strict", action="store_true",
             help="block dispatch when the pre-flight analyzer finds "
                  "an error-severity hazard (rank-conditional "
                  "collective, subset collective, desyncing exit)"),
        _arg("--deadline", type=float, default=None,
             help="per-cell budget in seconds: the hang watchdog "
                  "escalates (warn → dump → interrupt → heal, per "
                  "its ladder) when any rank is still busy past it"),
        _arg("--priority", type=int, default=None,
             help="tenant mode only: this cell's pool-scheduling "
                  "priority (higher dispatches first in fair mode; "
                  "default: the tenant's attach-time priority)"),
        _arg("--async", dest="use_async", action="store_true",
             help="stream this cell through the async in-flight "
                  "window and return a pending CellFuture instead "
                  "of blocking (admission gated by the effects/deps "
                  "DAG; %%dist_wait drains)"),
        _arg("--sync", dest="use_sync", action="store_true",
             help="force synchronous dispatch for this cell (drains "
                  "the async window first) even when "
                  "NBD_ASYNC_WINDOW arms async mode session-wide"),
        _arg("--repeat", type=int, default=None, metavar="K",
             help="worker-side step loop: compile the cell once and "
                  "run it K times in ONE dispatch — per-step "
                  "progress (step, last scalar, steps/s) rides the "
                  "heartbeats; a redelivered request never re-runs "
                  "steps"),
        _arg("--until", default=None, metavar="EXPR",
             help="with --repeat: stop early when this expression "
                  "is truthy in the worker namespace (evaluated "
                  "after each step), e.g. --until 'loss < 0.1'"),
    ),
    "dist_interrupt": _parser(
        "dist_interrupt",
        _arg("--ranks", default=None,
             help="target spec like [0,2]; default all"),
    ),
    "dist_mode": _parser(
        "dist_mode",
        _arg("-e", "--enable", action="store_true"),
        _arg("-d", "--disable", action="store_true"),
    ),
    "dist_logs": _parser(
        "dist_logs",
        _arg("--ranks", default=None,
             help="target spec like [0,2]; default all"),
        _arg("-n", "--lines", type=int, default=20,
             help="tail length per rank"),
    ),
    "dist_pull": _parser(
        "dist_pull",
        _arg("name", help="worker variable name"),
        _arg("--rank", type=int, default=0, help="rank to pull from"),
        _arg("--all", dest="all_ranks", action="store_true",
             help="pull from every rank into a {rank: value} dict"),
        _arg("--as", dest="as_name", default=None,
             help="kernel name to bind (default: same name)"),
        _arg("--readonly", action="store_true",
             help="bind read-only views of the decode buffers "
                  "(zero assembly copies — cheapest way to inspect "
                  "a large value; tensor leaves are copied, torch "
                  "has no read-only tensor)"),
    ),
    "dist_push": _parser(
        "dist_push",
        _arg("name", help="kernel variable name"),
        _arg("--ranks", default=None,
             help="target spec like [0,2]; default all"),
    ),
    "dist_checkpoint": _parser(
        "dist_checkpoint",
        _arg("path", nargs="?", default=None,
             help="checkpoint directory (per-rank subdirs)"),
        _arg("names", nargs="*", help="worker variable names to save"),
        _arg("-b", "--background", action="store_true",
             help="return immediately; the device->host copy (of a "
                  "snapshot, so training can continue in place) and "
                  "the disk IO run on a worker thread"),
        _arg("--status", action="store_true",
             help="poll the in-flight background save instead of "
                  "saving"),
        _arg("--fetch", default=None, metavar="LOCAL_DIR",
             help="after a sync save, pull every rank's shard to "
                  "this coordinator-local directory over the chunked "
                  "bulk plane (no shared filesystem needed)"),
    ),
    "dist_restore": _parser(
        "dist_restore",
        _arg("path", help="checkpoint directory written by "
                          "%%dist_checkpoint"),
        _arg("names", nargs="*", help="names to restore (default: all)"),
        _arg("--ship", default=None, metavar="LOCAL_DIR",
             help="first push this coordinator-local checkpoint "
                  "(rank_<r>/ subdirs, e.g. from --fetch) to every "
                  "rank's <path> over the chunked bulk plane, then "
                  "restore — moves a checkpoint into a world with no "
                  "shared filesystem"),
    ),
    "timeline_save": _parser(
        "timeline_save",
        _arg("path", nargs="?", default="nbd_timeline.json"),
    ),
    "dist_lint": _parser(
        "dist_lint",
        _arg("command", nargs="?", default="status",
             choices=["strict", "warn", "off", "status", "deps",
                      "effects", "self"]),
        _arg("--dot", action="store_true",
             help="with `deps`: print the dependency DAG as Graphviz "
                  "dot instead of text"),
    ),
    "dist_wait": _parser(
        "dist_wait",
        _arg("--timeout", type=float, default=None,
             help="bound the drain in seconds (cells still pending "
                  "at the deadline stay in flight)"),
    ),
    "dist_chaos": _parser(
        "dist_chaos",
        _arg("command", nargs="?", default="status",
             choices=["on", "off", "status"]),
        _arg("--seed", type=int, default=0,
             help="fault plan seed (same seed = same fault sequence)"),
        _arg("--drop", type=float, default=0.0,
             help="probability a control frame is dropped"),
        _arg("--delay-p", type=float, default=0.0, dest="delay_p",
             help="probability a frame is delayed by --delay-s"),
        _arg("--delay-s", type=float, default=0.02, dest="delay_s"),
        _arg("--duplicate", type=float, default=0.0,
             help="probability a frame is sent twice"),
        _arg("--truncate", type=float, default=0.0,
             help="probability a frame is cut mid-write "
                  "(connection-fatal: exercises death handling)"),
        _arg("--freeze-heartbeats", action="store_true",
             help="stop worker pings (exercises degraded detection)"),
        _arg("--kill-rank", type=int, default=None,
             help="SIGKILL this rank ..."),
        _arg("--kill-at", type=int, default=None,
             help="... at this received-message index (1 = next)"),
        _arg("--side", default="both",
             choices=["coordinator", "worker", "both"],
             help="which send path(s) inject frame faults"),
        _arg("--partition", default=None,
             help="host pair 'hostA,hostB' whose link to blackhole "
                  "(labels from the world's host map, 'local' = the "
                  "coordinator's host)"),
        _arg("--partition-after", type=float, default=0.0,
             dest="partition_after",
             help="seconds after arming before the partition opens"),
        _arg("--partition-for", type=float, default=10.0,
             dest="partition_for",
             help="partition duration in seconds (0 = until "
                  "%%dist_chaos off — allowed with --side coordinator "
                  "only: a worker-side plan can't be cleared across "
                  "the link it cuts)"),
        _arg("--link-latency", type=float, default=0.0,
             dest="link_latency",
             help="added per-frame delay on the --link-hosts pair"),
        _arg("--link-loss", type=float, default=0.0, dest="link_loss",
             help="per-frame drop probability on the --link-hosts "
                  "pair"),
        _arg("--link-hosts", default=None, dest="link_hosts",
             help="host pair 'hostA,hostB' for --link-latency/"
                  "--link-loss ('*,hostB' matches any peer)"),
        _arg("--corrupt", default=None,
             help="param-leaf path substring to corrupt on "
                  "--corrupt-rank at --corrupt-step ('*' = first "
                  "leaf); fires inside the rank's guarded train loop"),
        _arg("--corrupt-rank", type=int, default=None,
             dest="corrupt_rank",
             help="rank whose params --corrupt damages"),
        _arg("--corrupt-step", type=int, default=1, dest="corrupt_step",
             help="guarded-step index at which the corruption fires "
                  "(one-shot, >= semantics)"),
        _arg("--corrupt-mode", default="bitflip",
             choices=["bitflip", "scale"], dest="corrupt_mode",
             help="bitflip: XOR seeded bits; scale: multiply a "
                  "seeded contiguous slice by --corrupt-scale"),
        _arg("--corrupt-bits", type=int, default=1, dest="corrupt_bits",
             help="bits to flip in bitflip mode"),
        _arg("--corrupt-scale", type=float, default=4.0,
             dest="corrupt_scale",
             help="multiplier for scale mode"),
        _arg("--corrupt-count", type=int, default=1,
             dest="corrupt_count",
             help="elements the scale-mode slice covers"),
    ),
    "dist_profile": _parser(
        "dist_profile",
        _arg("action", choices=["start", "stop"]),
        _arg("--log-dir",
             default=os.path.join(tempfile.gettempdir(), "nbd_profile"),
             help="per-worker trace dir (suffixed with the rank)"),
    ),
    "dist_trace": _parser(
        "dist_trace",
        _arg("action", nargs="?", default="status",
             choices=["start", "stop", "save", "status"]),
        _arg("path", nargs="?", default="nbd_trace.json",
             help="output file for `save` (Chrome-trace JSON; load in "
                  "ui.perfetto.dev)"),
    ),
    "dist_metrics": _parser(
        "dist_metrics",
        _arg("--prom", action="store_true",
             help="print Prometheus exposition text instead of the "
                  "summary"),
        _arg("--save", default=None,
             help="also write the full JSON snapshot (coordinator + "
                  "per-rank) to this path"),
    ),
    "dist_heal": _parser(
        "dist_heal",
        _arg("--restore", default=None,
             help="checkpoint directory to %%dist_restore once the "
                  "world is back"),
        _arg("--force", action="store_true",
             help="rebuild even when every worker looks alive"),
    ),
    "dist_supervise": _parser(
        "dist_supervise",
        _arg("command", nargs="?", default="status",
             choices=["on", "off", "status"]),
        _arg("--max-restarts", type=int, default=3,
             help="restart budget inside --window seconds"),
        _arg("--window", type=float, default=600.0,
             help="restart-budget window in seconds"),
        _arg("--degraded-after", type=float, default=6.0,
             help="heartbeat staleness (s) before a rank is flagged "
                  "degraded (slow/wedged — NOT restarted)"),
        _arg("--no-auto", action="store_true",
             help="observe and log transitions only; never heal"),
    ),
    "dist_guard": _parser(
        "dist_guard",
        _arg("command", nargs="?", default="status",
             choices=["status", "on", "off", "audit"]),
    ),
    "dist_watchdog": _parser(
        "dist_watchdog",
        _arg("command", nargs="?", default="status",
             choices=["on", "off", "status"]),
        _arg("--skew", type=float, default=None,
             help="seconds a rank may lag its peers' collective "
                  "position before the cell is flagged HUNG"),
        _arg("--stall", type=float, default=None,
             help="seconds a rank may stay busy with zero collective "
                  "progress before the cell is flagged HUNG"),
        _arg("--poll", type=float, default=None,
             help="watchdog poll cadence in seconds"),
        _arg("--grace", type=float, default=None,
             help="pause between escalation ladder steps"),
        _arg("--escalate", default=None,
             help="comma-separated ladder from: warn,dump,interrupt,"
                  "heal (default warn,dump)"),
    ),
    "dist_doctor": _parser(
        "dist_doctor",
        _arg("--save", default=None,
             help="also write the report to this path"),
        _arg("--no-stacks", action="store_true",
             help="skip the SIGUSR1 stack dump (read-only diagnosis)"),
    ),
    "dist_postmortem": _parser(
        "dist_postmortem",
        _arg("--last", action="store_true",
             help="show the newest bundle's report instead of "
                  "capturing a fresh one"),
        _arg("--save", default=None,
             help="capture the bundle into this directory"),
    ),
    "dist_attach": _parser(
        "dist_attach",
        _arg("run_dir", nargs="?", default=None,
             help="session run directory (default: NBD_RUN_DIR, else "
                  "the newest manifest with live pids under the runs "
                  "root)"),
        _arg("-t", "--timeout", type=float, default=None,
             help="per-request timeout for the new manager (default: "
                  "none — training mode)"),
        _arg("--attach-timeout", type=float, default=90.0,
             help="seconds to wait for orphaned workers to dial back"),
        _arg("--tenant", default=None,
             help="attach to a GATEWAY POOL as this tenant name "
                  "(%%dist_pool start spawns one) instead of adopting "
                  "a single-kernel fleet; reattaching under the same "
                  "name resumes the tenant session and drains its "
                  "parked results exactly once"),
        _arg("--priority", type=int, default=None,
             help="tenant scheduling priority in the pool's "
                  "fair-share queue (higher wins; tenant mode "
                  "only).  Omitted on a reattach = keep the "
                  "tenant's current priority (new tenants get 0)"),
    ),
    "dist_gc": _parser(
        "dist_gc",
        _arg("--dry-run", action="store_true",
             help="list what would be swept without removing anything"),
        _arg("--ttl", type=float, default=None,
             help="stale age in seconds (default: NBD_GC_TTL_S, "
                  "else 6h)"),
        _arg("--root", default=None,
             help="runs root to sweep (default: <tmpdir>/nbd_runs)"),
    ),
    "dist_serve": _parser(
        "dist_serve",
        _arg("command", nargs="?", default="status",
             choices=["start", "status", "stop", "submit", "result",
                      "stream", "lat"]),
        _arg("--spec", default=None,
             help="kernel variable holding the model-spec cell "
                  "(code that binds params/cfg in the serving "
                  "tenant's namespace on every rank)"),
        _arg("--tenant", default=None,
             help="serving tenant name (default 'serve')"),
        _arg("--params", default=None,
             help="params name in the serving namespace"),
        _arg("--cfg", default=None,
             help="config name in the serving namespace"),
        _arg("--max-batch", type=int, default=None,
             help="KV slots (continuous-batching width)"),
        _arg("--max-len", type=int, default=None),
        _arg("--pad-to", type=int, default=None),
        _arg("--eos", type=int, default=None),
        _arg("--steps", type=int, default=None,
             help="decode steps per serve tick"),
        _arg("--queue-depth", type=int, default=None),
        _arg("--inflight", type=int, default=None),
        _arg("--decode-ranks", type=int, default=None,
             help="decode ranks to drive (0 = every live rank; "
                  "default NBD_SERVE_DECODE_RANKS)"),
        _arg("--kv-block-tokens", type=int, default=None,
             help="paged-KV block size in tokens "
                  "(default NBD_KV_BLOCK_TOKENS)"),
        _arg("--kv-blocks", type=int, default=None,
             help="KV blocks per decode rank (0 = dense capacity; "
                  "default NBD_KV_BLOCKS_PER_RANK)"),
        _arg("--prefill-chunk", type=int, default=None,
             help="chunked-prefill size in tokens — long prompts "
                  "interleave with decode ticks "
                  "(default NBD_PREFILL_CHUNK_TOKENS)"),
        _arg("--kv-quantized", action="store_true",
             help="int8 KV cache on the decode servers"),
        _arg("--prompt", default=None,
             help="comma-separated token ids (submit)"),
        _arg("--max-new", type=int, default=16),
        _arg("--priority", type=int, default=None),
        _arg("--rid", default=None, help="request id (result/stream)"),
        _arg("--from", dest="from_offset", type=int, default=0,
             help="resume offset (stream) — your last acked token"),
        _arg("--wait", action="store_true",
             help="submit: block until the request finishes and "
                  "print its tokens"),
        _arg("--last", type=int, default=0,
             help="lat: also render the stage waterfall of the "
                  "last N completed requests"),
    ),
    "dist_pool": _parser(
        "dist_pool",
        _arg("command", nargs="?", default="status",
             choices=["start", "status", "stop", "resize", "migrate",
                      "template"]),
        _arg("-n", "--workers", type=int, default=2,
             help="pool world size (start / resize target)"),
        _arg("--backend", default="gpu", choices=["auto", "cpu", "gpu"],
             help="gpu (default): one GPU a rank, at most one rank a "
                  "card; cpu: gloo; auto: the GPU, raising on a host "
                  "without one"),
        _arg("--run-dir", default=None,
             help="pool run dir (start: minted when omitted; "
                  "status/stop: discovery override)"),
        _arg("--max-tenants", type=int, default=None),
        _arg("--sched", default=None, choices=[None, "fifo", "fair"]),
        _arg("--mesh-slots", type=int, default=None),
        _arg("--queue-depth", type=int, default=None),
        _arg("--tenant-inflight", type=int, default=None),
        _arg("--effects", action="store_true",
             help="effects-aware admission: with --mesh-slots > 1, "
                  "only cells PROVEN collective-free may overlap a "
                  "collective-bearing cell (NBD_POOL_SCHED_EFFECTS)"),
        _arg("--metrics-port", type=int, default=None,
             help="start: serve GET /metrics (Prometheus), /healthz "
                  "and /latency.json on this port, token-gated with "
                  "the pool token (default: NBD_METRICS_PORT; "
                  "0 = off)"),
        _arg("--start-timeout", type=float, default=240.0,
             help="seconds to wait for the daemon's readiness line"),
        _arg("--autoscale", default=None, nargs="?", const="show",
             metavar="MIN:MAX",
             help="start: arm the pressure-driven autoscaler with "
                  "this worker band (thresholds from the "
                  "NBD_AUTOSCALE_* knobs); status: render the "
                  "decision audit trail (no value needed)"),
        _arg("--tenant", default=None,
             help="migrate: the tenant to move"),
        _arg("--to", dest="dest", default=None,
             help="migrate: destination pool run dir (default: the "
                  "least-loaded other live pool)"),
        _arg("--force", action="store_true",
             help="migrate: move an ATTACHED tenant too"),
        _arg("--name", default="default",
             help="template: template name"),
        _arg("--file", dest="tpl_file", default=None,
             help="template: file whose contents become the "
                  "warm-start template cell (omit to list)"),
    ),
    "dist_lat": _parser(
        "dist_lat",
        _arg("--last", type=int, default=0,
             help="also render a waterfall for the last N cells"),
        _arg("--save", default=None,
             help="write the summary + raw stage records JSON here"),
    ),
}


class DistributedMagics:
    # Class-level singletons so re-registration survives %load_ext cycles
    # (reference: magic.py:95-98).
    _comm: CommunicationManager | None = None
    _pm: ProcessManager | None = None
    _world: int = 0
    _auto_active: bool = False
    _timeline: Timeline = Timeline()
    _active_display = None
    _display_lock = threading.Lock()
    _instance = None
    _proxy_registry: dict = {}
    _sidecar: str | None = None
    # Last successful %dist_init line — %dist_heal replays it after a
    # crash (kept across %dist_reset on purpose: healing after a reset
    # is the common recovery flow).
    _last_init_line: str | None = None
    # Last checkpoint path a %dist_checkpoint COMPLETED writing — the
    # auto-heal supervisor restores it after a respawn.  Background
    # saves park their path in _bg_ckpt_path until a --status poll
    # confirms every rank finished (an in-flight or failed save must
    # never become the heal target).
    _last_ckpt_path: str | None = None
    _bg_ckpt_path: str | None = None
    # Ranks whose in-flight background save has reported "done": the
    # worker consumes its async handle on the first done poll (later
    # polls say "idle"), so doneness must accumulate ACROSS polls.
    _bg_ckpt_done: set = set()

    @classmethod
    def _clear_bg_ckpt(cls) -> None:
        """Invalidate the pending background-save promotion (the two
        fields are one invariant — always cleared together)."""
        cls._bg_ckpt_path = None
        cls._bg_ckpt_done = set()

    # Session-wide pre-dispatch cell-vetting mode: None = resolve the
    # NBD_LINT knob at use time; %dist_lint warn|strict|off pins it.
    _lint_mode: str | None = None
    _async_exec = None          # messaging.pipeline.AsyncExecutor | None

    # True when this kernel joined the fleet via %dist_attach rather
    # than spawning it (durable sessions) — surfaced in %dist_status.
    _attached: bool = False
    # Tenant mode (gateway pools): this kernel is attached to a shared
    # pool as one tenant (`%dist_attach --tenant NAME`).  The client
    # replaces (comm, pm) — cells route through the gateway's
    # scheduler, and %dist_status/%dist_top render the pool view.
    _tenant = None              # gateway.client.TenantClient | None
    _pool_info: dict | None = None   # the gateway manifest we attached to

    # Active auto-heal supervisor (resilience/supervisor.py), or None.
    _supervisor = None
    # Live scrape endpoint (observability/httpd.py), or None — started
    # by %dist_init when NBD_METRICS_PORT is set; closed on shutdown.
    _metrics_httpd = None
    # Active hang watchdog (resilience/watchdog.py), or None.  Armed by
    # %dist_init when NBD_HANG enables it (default on, ladder
    # warn→dump); reconfigured by %dist_watchdog.
    _watchdog = None
    # True while %dist_heal is tearing down + respawning: shutdown_all
    # must NOT discard the watchdog then — the replayed %dist_init
    # re-binds the SAME instance, preserving a %dist_watchdog-
    # customized policy and the counters/event history.
    _healing: bool = False

    _cell_hooks: tuple | None = None

    def __init__(self, shell):
        # ``shell``: the IPython shell, or any object with a
        # ``user_ns`` dict and an ``input_transformers_cleanup`` list
        # (where there is no IPython, a program calls these methods
        # with each cell's line and text).
        self.shell = shell
        DistributedMagics._instance = self
        self._register_cell_hooks()

    # ==================================================================
    # whole-session timeline hooks
    #
    # The reference registers pre/post_run_cell at load so *every* cell
    # — local and distributed — lands in the timeline (reference:
    # magic.py:123-130, 647-707).  Distributed cells get their richer
    # record from _run_on_ranks; these hooks add kind="local" records
    # for everything else (plain local cells, magics, auto-mode off).

    def _register_cell_hooks(self) -> None:
        cls = DistributedMagics
        if cls._cell_hooks is not None:
            # A previous %load_ext cycle left its bound methods
            # registered — drop them or every cell records twice.
            cls.unregister_cell_hooks()
        if getattr(self.shell, "events", None) is None:
            return
        self.shell.events.register("pre_run_cell", self._pre_run_cell)
        self.shell.events.register("post_run_cell", self._post_run_cell)
        cls._cell_hooks = (self._pre_run_cell, self._post_run_cell,
                           self.shell)

    @classmethod
    def unregister_cell_hooks(cls) -> None:
        if cls._cell_hooks is None:
            return
        pre, post, shell = cls._cell_hooks
        cls._cell_hooks = None
        for name, cb in (("pre_run_cell", pre), ("post_run_cell", post)):
            try:
                shell.events.unregister(name, cb)
            except ValueError:
                pass

    def _pre_run_cell(self, info) -> None:
        self._cell_t0 = time.time()
        self._cell_raw = getattr(info, "raw_cell", "") or ""
        self._cell_recs_before = len(DistributedMagics._timeline.records)

    def _post_run_cell(self, result) -> None:
        t0 = getattr(self, "_cell_t0", None)
        if t0 is None:
            return
        self._cell_t0 = None
        tl = DistributedMagics._timeline
        if len(tl.records) <= self._cell_recs_before:
            # not distributed — record the local cell (distributed
            # cells were already recorded richer by _run_on_ranks)
            tl.record_local(self._cell_raw, t0, time.time() - t0,
                            ok=bool(getattr(result, "success", True)))
        self._flush_sidecar()

    def _flush_sidecar(self) -> bool:
        """Write the timeline sidecar after every cell when
        %timeline_sidecar is on — the server-side pre_save_hook
        (jupyter_hooks.py) folds it into the notebook's metadata at
        save time.  Fail-open (a write error must never break cells)
        but returns whether THIS write landed, so %timeline_sidecar on
        can fail loudly instead of trusting a stale file."""
        path = DistributedMagics._sidecar
        if not path:
            return False
        import json
        try:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(DistributedMagics._timeline.payload(), f)
            os.replace(tmp, path)
            return True
        except Exception:
            return False

    # ==================================================================
    # state helpers

    @classmethod
    def reset_class_state(cls) -> None:
        if cls._supervisor is not None:
            cls._supervisor.stop()
            cls._supervisor = None
        if cls._watchdog is not None:
            cls._watchdog.stop()
            cls._watchdog = None
        if cls._metrics_httpd is not None:
            try:
                cls._metrics_httpd.close()
            except Exception:
                pass
            cls._metrics_httpd = None
        # In-flight background-save tracking is world-specific (per-
        # rank doneness): stale entries from a previous (possibly
        # larger) world must not promote a half-written checkpoint in
        # the next one.
        cls._clear_bg_ckpt()
        cls._drop_tenant_state()
        cls._async_exec = None
        cls._comm = None
        cls._pm = None
        cls._world = 0
        cls._attached = False
        cls._auto_active = False
        cls._timeline = Timeline()
        cls._active_display = None
        cls._proxy_registry = {}
        cls._cell_rank_history = {}
        if cls._sidecar:
            try:
                os.remove(cls._sidecar)
            except OSError:
                pass
        cls._sidecar = None

    def on_extension_loaded(self) -> None:
        print("nbdistributed_tpu_torch loaded. Start workers with: "
              "%dist_init -n <N>")

    def _running(self) -> bool:
        return (self._comm is not None and self._pm is not None
                and self._pm.is_running())

    def _require_cluster(self) -> bool:
        if not self._running():
            if DistributedMagics._tenant is not None:
                # "%dist_init first" would be circular advice here —
                # %dist_init itself refuses in tenant mode.
                print(f"❌ attached to a gateway pool as tenant "
                      f"{DistributedMagics._tenant.name!r} — only "
                      "%%distributed cells run on a pool (subset "
                      "%%rank, %sync, interrupts and friends need a "
                      "dedicated fleet: %dist_shutdown to detach, "
                      "then %dist_init).")
            else:
                print("❌ No distributed cluster. Run %dist_init "
                      "first.")
            return False
        return True

    # ==================================================================
    # streaming plumbing

    def _feed_stream(self, rank: int, data: dict) -> None:
        """Output callback (IO thread).  Routes to the active cell's
        display, or prints directly for output that arrives outside any
        request (e.g. prints from background threads on workers)."""
        with DistributedMagics._display_lock:
            disp = DistributedMagics._active_display
        if disp is not None:
            disp.feed(rank, data)
        else:
            text = data.get("text", "")
            if text.strip():
                print(f"[rank {rank}] {text}", end=""
                      if text.endswith("\n") else "\n")

    def _run_on_ranks(self, code: str, ranks: list[int], kind: str,
                      deadline_s: float | None = None,
                      vet_s: float | None = None,
                      repeat: int | None = None,
                      until: str | None = None):
        """Send an execute request and stream output while waiting
        (reference: magic.py:1042-1129 runs the send in a helper thread
        and polls buffers from the main thread; same structure, 30 ms
        cadence instead of 100 ms).  ``repeat``/``until`` ride the
        payload: the worker compiles once and loops k steps."""
        # A synchronous cell is a sync point for the async window:
        # every streamed cell completes (and surfaces its errors)
        # before this one dispatches, so program order stays readable.
        self._drain_async("synchronous cell")
        comm = self._comm
        assert comm is not None
        disp = display_mod.StreamDisplay()
        rec = self._timeline.start(code, ranks, kind=kind)
        # Cell-level span while a span trace is active: the send span
        # (opened inside send_to_ranks, on the helper thread) nests
        # under it via activate(), and the timeline record carries its
        # ids so a row maps to the span tree.
        tr = comm.tracer
        cell_span = (tr.begin(f"cell/{kind}", kind="cell",
                              attrs={"ranks": list(ranks),
                                     "code": code.strip()[:120]})
                     if tr.enabled else None)
        if cell_span is not None:
            rec.trace_id = cell_span.trace_id
            rec.span_id = cell_span.span_id
        with DistributedMagics._display_lock:
            DistributedMagics._active_display = disp
        result: dict = {}
        error: list[Exception] = []

        def _send():
            try:
                # target_ranks ride the request: the worker publishes
                # them while the cell runs, and the eager
                # world-collectives raise at CALL time when entered by
                # a strict subset (runtime/collective_guard.py) —
                # BEFORE the control plane would hang on replies that
                # cannot come.
                payload = {"code": code, "target_ranks": list(ranks)}
                if deadline_s is not None:
                    # The worker echoes this back on heartbeats so
                    # the hang watchdog can enforce the budget with
                    # no coordinator-side bookkeeping.
                    payload["deadline_s"] = deadline_s
                if repeat is not None:
                    # Worker-side step loop: compile once, run k
                    # steps, report per-step progress on heartbeats.
                    payload["repeat"] = int(repeat)
                    if until:
                        payload["until"] = until
                with tr.activate(cell_span):
                    # vet_s: how long pre-dispatch vetting took — the
                    # latency observatory's "vet" stage.
                    result.update(comm.send_to_ranks(
                        ranks, "execute", payload, vet_s=vet_s))
            except Exception as e:
                error.append(e)

        worker_thread = threading.Thread(target=_send, daemon=True)
        worker_thread.start()
        try:
            try:
                while worker_thread.is_alive():
                    worker_thread.join(timeout=0.03)
                    disp.drain()
            except KeyboardInterrupt:
                # Jupyter's interrupt button SIGINTs the kernel while we
                # block here; forward it to the workers (their cells
                # abort with KeyboardInterrupt replies) and keep
                # collecting those replies.  A second Ctrl-C abandons
                # the wait.
                print("\n🛑 interrupt: signaling workers "
                      f"{self._pm.interrupt()} — waiting for aborted-"
                      "cell replies (Ctrl-C again to stop waiting)")
                try:
                    while worker_thread.is_alive():
                        worker_thread.join(timeout=0.03)
                        disp.drain()
                except KeyboardInterrupt:
                    print("🛑 not waiting for worker replies; "
                          "%sync to realign later")
            disp.drain()
            disp.finalize()
        finally:
            with DistributedMagics._display_lock:
                DistributedMagics._active_display = None
            tr.end(cell_span)
        self._timeline.finish(rec, result or None)
        if error:
            e = error[0]
            if isinstance(e, WorkerDied):
                print(f"💀 {e}")
                print("   Run %dist_status for details; %dist_reset to "
                      "rebuild the cluster.")
            elif isinstance(e, TimeoutError):
                print(f"⏱️ {e}")
            else:
                print(f"❌ {type(e).__name__}: {e}")
            return None
        display_mod.print_rank_errors(result)
        if repeat is not None and result:
            d0 = next((m.data for m in result.values()
                       if isinstance(getattr(m, "data", None), dict)
                       and m.data.get("steps") is not None), None)
            if d0 is not None and not d0.get("error"):
                early = (" (stopped early by --until)"
                         if d0.get("stopped_early") else "")
                last = d0.get("last_scalar")
                print(f"🔁 {d0['steps']}/{d0.get('repeat')} steps in "
                      f"{d0.get('duration_s', 0):.2f}s — "
                      f"{d0.get('steps_per_s', 0):.1f} steps/s, one "
                      f"dispatch{early}"
                      + (f" · last {last:g}" if last is not None
                         else ""))
        self._record_cell_ranks(result, ranks)
        return result

    # Coordinator-side record of which ranks executed each cell (the
    # SURVEY §5.2 check): keyed by the worker-computed source hash.
    _cell_rank_history: dict = {}

    def _record_cell_ranks(self, result: dict, ranks: list[int]) -> None:
        """Track per-cell rank coverage and warn when a cell that
        ACTUALLY invoked world-collectives (runtime count, not a text
        scan) completed on a strict subset of the world.  The
        deadlocking case raises on the worker at call time
        (runtime/collective_guard.py) and its per-rank error already
        tells the story — the warning is suppressed when any reply
        errored.  The accumulated history names the cell's earlier
        rank coverage so the user can see the drift; it is bounded and
        cleared on shutdown/reset."""
        ops, h, errored = 0, None, False
        for msg in result.values():
            d = getattr(msg, "data", None)
            if isinstance(d, dict):
                h = d.get("cell_sha1", h)
                ops = max(ops, int(d.get("collective_ops") or 0))
                errored = errored or "error" in d
        hist = DistributedMagics._cell_rank_history
        prior = set(hist.get(h, ())) if h is not None else set()
        if h is not None:
            hist[h] = prior | set(ranks)
            while len(hist) > 512:            # bound a long session
                hist.pop(next(iter(hist)))
        if ops and len(ranks) < self._world and not errored:
            extra = (f" (earlier runs of this cell covered ranks "
                     f"{sorted(prior)})" if prior - set(ranks) else "")
            print(f"⚠️ This cell made {ops} world-collective call(s) "
                  f"but ran on ranks {sorted(ranks)} of "
                  f"{self._world} — collective results computed by a "
                  f"subset diverge from the mesh; run it on all "
                  f"ranks.{extra}")

    # ==================================================================
    # %dist_init

    def dist_init(self, line):
        """Start N workers and route subsequent cells to them
        (reference: magic.py:397-536)."""
        args = _parse("dist_init", line)
        if args.attach_dir is not None:
            return self.dist_attach(args.attach_dir)
        if DistributedMagics._tenant is not None:
            # Tenant mode routes every cell to the pool; a second
            # local fleet here would spawn, hold GPUs, and never
            # receive a cell.
            print(f"⚠️ attached to a gateway pool as tenant "
                  f"{DistributedMagics._tenant.name!r} — "
                  "%dist_shutdown (detaches, pool survives) first.")
            return
        if self._running():
            print(f"⚠️ {self._world} workers already running. "
                  "%dist_shutdown first.")
            return
        from ..manager import topology as _topo
        t0 = time.time()
        num_workers = args.num_workers
        if args.chips_per_worker != 1:
            # A rank owns one GPU (NCCL refuses two ranks of one
            # communicator on one device, and a rank drives one card):
            # more GPUs are more ranks.
            print(f"❌ --chips-per-worker {args.chips_per_worker}: a rank "
                  "owns one GPU here — run more ranks instead (-n N, or "
                  "--hosts host:N).")
            return
        # Explicit GPU pinning (reference: magic.py:454-488): parse
        # and sanity-check before anything spawns; the count and
        # availability checks run pre-spawn in start_workers.
        gpus = None
        if args.gpu_ids:
            try:
                gpus = _topo.parse_gpu_ids(args.gpu_ids.strip()
                                           .strip("'\""))
            except ValueError as e:
                print(f"❌ {e}")
                return
            if args.hosts:
                print("❌ --gpu-ids is a single-host option; host plans "
                      "give each host's ranks its GPUs by local rank.")
                return
        host_specs = None
        agents = None
        if args.hosts:
            from ..manager import multihost
            try:
                host_specs = multihost.parse_hosts(args.hosts)
            except ValueError as e:
                print(f"❌ {e}")
                return
            num_workers = sum(h.workers for h in host_specs)
            if args.agents:
                from ..manager import hostagent
                try:
                    # The non-posix arg_split keeps quote chars inside
                    # the token; strip them like %dist_attach.
                    agents = hostagent.parse_agents(
                        args.agents.strip().strip("'\""))
                except ValueError as e:
                    print(f"❌ {e}")
                    return
        elif args.agents:
            print("❌ --agents requires a --hosts plan naming the "
                  "agent hosts.")
            return
        # "auto" resolves to the GPU here and raises on a host without
        # one: the CPU runs only when the caller asks for it.
        backend = (_topo.detect_backend() if args.backend == "auto"
                   else args.backend)
        if gpus is not None:
            if backend != "gpu":
                # Reference parity: magic.py:481-483.
                print("⚠️  CUDA not available, GPU IDs will be ignored")
                gpus = None
            else:
                print(f"Using GPUs: {gpus}")
        # Remote hosts must be able to dial the control plane: bind all
        # interfaces when the plan leaves this machine (default stays
        # loopback-only) — and require a per-cluster shared secret on
        # that bind: this port executes code, so an unauthenticated
        # non-loopback listener would be remote code execution for
        # anyone who can reach it.
        bind_host, auth_token = "127.0.0.1", None
        if host_specs is not None and any(h.host != "local"
                                          for h in host_specs):
            import secrets
            bind_host = "0.0.0.0"
            auth_token = secrets.token_hex(16)
        # Durable session identity: the token ties workers and the
        # manifest to ONE session; epoch 1 is this first coordinator's
        # tenancy.
        from ..resilience import session as session_mod
        session_token = session_mod.mint_token()
        session_env = {"NBD_SESSION_TOKEN": session_token,
                       "NBD_SESSION_EPOCH": "1"}
        comm = CommunicationManager(num_workers=num_workers,
                                    host=bind_host,
                                    timeout=args.timeout,
                                    auth_token=auth_token,
                                    session_token=session_token,
                                    session_epoch=1)
        pm = ProcessManager()
        pm.add_death_callback(lambda r, rc: comm.mark_worker_dead(r))
        pm.add_death_callback(self._announce_death)
        try:
            print(f"🚀 Spawning {num_workers} workers "
                  f"(backend={args.backend}"
                  + (f", hosts={args.hosts}" if args.hosts else "")
                  + ")...")
            if host_specs is not None:
                # Agents authenticate with their daemon-start secret
                # (export the same one as NBD_AGENT_TOKEN here), NOT
                # this session's minted control-plane token.
                agent_token = _knobs.get_str("NBD_AGENT_TOKEN")
                if agents and agent_token is None:
                    print("⚠️ NBD_AGENT_TOKEN is not set — dialing the "
                          "agents with this session's minted secret, "
                          "which only works if the daemons were "
                          "started with it")
                pm.start_workers_multihost(
                    host_specs, comm.port,
                    coordinator_host=args.coordinator_addr,
                    backend=backend, auth_token=auth_token,
                    agents=agents, agent_token=agent_token,
                    extra_env=session_env)
            else:
                pm.start_workers(num_workers, comm.port, backend=backend,
                                 gpus=gpus, extra_env=session_env)
            from ..manager import wait_until_ready
            wait_until_ready(
                comm, pm, args.attach_timeout,
                on_wait=lambda: print(
                    f"   ... waiting ({len(comm.connected_ranks())}/"
                    f"{num_workers} attached)"))
        except Exception as e:
            print(f"❌ Worker startup failed: {e}")
            pm.shutdown()
            comm.shutdown()
            return
        comm.set_output_callback(self._feed_stream)
        # Host topology → link shaping, partition sentry, per-host
        # status (single-host worlds: everything "local", inert).
        comm.set_host_map(pm.hosts)
        DistributedMagics._comm = comm
        DistributedMagics._pm = pm
        DistributedMagics._world = num_workers
        DistributedMagics._attached = False
        if host_specs is not None:
            # Multi-host session bootstrap: the workers got the
            # session token/epoch via their env; the hello exchange
            # mirrors the session manifest to every worker so the
            # orphan reconnect loop can rediscover the endpoint
            # WITHOUT a shared run-dir filesystem.  No run-dir
            # manifest: pid adoption and the shared file assume one
            # pid namespace and filesystem.
            mirror = session_mod.make_manifest(
                world_size=num_workers,
                control_host=args.coordinator_addr,
                control_port=comm.port, bind_host=bind_host,
                token=session_token, epoch=1,
                pids={r: p.pid for r, p in pm.processes.items()},
                backend=pm.backend, dist_port=pm.dist_port,
                auth_token=auth_token, init_line=line)
            try:
                comm.send_to_all(
                    "hello", {"token": session_token, "epoch": 1,
                              "manifest": mirror}, timeout=30)
            except Exception as e:
                print(f"⚠️ manifest mirror hello failed ({e}) — "
                      "orphaned workers will only retry the "
                      "spawn-time endpoint")
        else:
            # Session manifest: the run dir's record of this fleet,
            # which %dist_attach reads to adopt it after this kernel
            # dies.
            from ..observability import flightrec as _flightrec
            _rd = _flightrec.run_dir()
            _existing = session_mod.read_manifest(_rd)
            if (_existing is not None
                    and _existing.get("token") != session_token
                    and session_mod.live_pids(_existing)):
                # NBD_RUN_DIR points at ANOTHER session whose fleet is
                # still alive: clobbering its manifest would strand it.
                print(f"⚠️ {_rd} already holds a LIVE session's "
                      "manifest — not overwriting it; this world is "
                      "NOT reattachable. Unset NBD_RUN_DIR and re-init.")
            else:
                try:
                    session_mod.write_manifest(
                        _rd, session_mod.make_manifest(
                            world_size=num_workers,
                            control_host="127.0.0.1",
                            control_port=comm.port, bind_host="127.0.0.1",
                            token=session_token, epoch=1,
                            pids={r: p.pid
                                  for r, p in pm.processes.items()},
                            backend=pm.backend, dist_port=pm.dist_port,
                            init_line=line,
                            supervised=DistributedMagics._supervisor
                            is not None))
                except OSError as e:
                    print(f"⚠️ session manifest not written ({e})")
        if DistributedMagics._last_init_line != line:
            # A DIFFERENT world configuration invalidates the previous
            # world's checkpoint as an auto-heal restore target (its
            # rank layout / model state need not fit this world).  A
            # same-line re-init — the heal replay path — keeps it.
            DistributedMagics._last_ckpt_path = None
        DistributedMagics._last_init_line = line
        self._enable_auto_mode()
        self._maybe_start_watchdog()
        self._maybe_start_metrics_httpd()
        print(_BANNER.format(n=num_workers,
                             backend=pm.backend,
                             secs=time.time() - t0))

    def _maybe_start_metrics_httpd(self) -> None:
        """Start the live scrape endpoint when NBD_METRICS_PORT asks
        for one: /metrics (Prometheus), /healthz, /latency.json over
        this kernel's coordinator.  Loopback-bound and ungated."""
        port = _knobs.get_int("NBD_METRICS_PORT", 0)
        if not port or DistributedMagics._metrics_httpd is not None \
                or self._comm is None:
            return
        from ..observability import httpd as obs_httpd
        try:
            DistributedMagics._metrics_httpd = obs_httpd.start_for_comm(
                self._comm, port=port)
            print(f"📈 scrape endpoint: http://127.0.0.1:"
                  f"{DistributedMagics._metrics_httpd.port}/metrics "
                  f"(/healthz, /latency.json)")
        except OSError as e:
            print(f"⚠️ metrics endpoint not started "
                  f"(NBD_METRICS_PORT={port}): {e}")

    def _announce_death(self, rank: int, rc: int | None) -> None:
        # Runs on the monitor thread; a print is best-effort context.
        print(f"\n💀 worker {rank} exited (code {rc}). "
              "%dist_status / %dist_heal [--restore ckpt] / %dist_reset")
        # Automatic postmortem: recover the dead rank's flight ring and
        # last telemetry NOW, while the evidence is fresh.  When a
        # supervisor is attached it owns capture (on its own thread,
        # before the heal destroys the world); otherwise this monitor-
        # thread capture is the only shot.
        if DistributedMagics._supervisor is None \
                and DistributedMagics._comm is not None:
            from ..observability import postmortem as pm_mod
            manifest = pm_mod.capture(
                DistributedMagics._comm, [rank],
                reason=f"worker {rank} exited (code {rc})")
            if manifest is not None:
                print(f"🛩  postmortem bundle → {manifest['dir']} "
                      f"(%dist_postmortem --last)")

    def dist_heal(self, line):
        """Recover from worker death: tear the remnants down, respawn
        the world with the SAME ``%dist_init`` configuration, and
        optionally restore a checkpoint into the fresh namespaces.

        A ``torch.distributed`` process group is fixed-membership — a
        dead rank cannot rejoin a live communicator — so recovery is a
        full restart + state restore: pair with periodic
        ``%dist_checkpoint path names --background`` and healing costs
        one respawn plus one restore, not a lost session.  Each rank
        respawns on its GPU (a rank that cannot get its card fails the
        heal) and joins a fresh rendezvous port; the restore binds new
        tensors on each leaf's recorded device, so re-run the cell that
        builds the step function after it."""
        args = _parse("dist_heal", line)
        replay = DistributedMagics._last_init_line
        if replay is None:
            print("❌ nothing to heal from: no successful %dist_init "
                  "recorded in this session")
            return
        dead: list[int] = []
        pm = DistributedMagics._pm
        if pm is not None and self._running():
            alive = set(pm.alive_ranks())
            dead = sorted(set(range(self._world)) - alive)
            if not dead and not args.force:
                print(f"✅ all {self._world} workers alive; nothing to "
                      f"heal (--force rebuilds anyway)")
                return
        print(f"🩹 healing: dead ranks {dead if dead else '(world down)'}"
              f" — rebuilding with: %dist_init {replay}")
        sup = DistributedMagics._supervisor  # survives a manual heal
        DistributedMagics._healing = True    # so does the watchdog
        try:
            # Tears down this kernel's fleet only (the process groups
            # of its workers), as %dist_shutdown does.
            self.shutdown_all()
            self.dist_init(replay)
        finally:
            DistributedMagics._healing = False
        if not self._running():
            print("❌ heal failed: the replayed %dist_init did not "
                  "bring the world up")
            if sup is not None and not sup.on_own_thread():
                print("⚠️ supervision was stopped by this heal and is "
                      "now OFF — %dist_supervise on after recovery")
            return
        if args.restore:
            self.dist_restore(args.restore)
        if sup is not None and not sup.on_own_thread():
            # Manual heal with supervision active: re-bind the
            # supervisor to the fresh world (shutdown_all stopped it).
            # The supervisor-driven path re-binds itself from the heal
            # callback's return value instead.
            sup.attach(self._comm, self._pm)
            DistributedMagics._supervisor = sup

    # ==================================================================
    # resilience: auto-heal supervision, the training guard

    def _supervised_heal(self, force: bool = False):
        """Heal callback the supervisor runs on worker death: replay
        the recorded %dist_init, restore the last checkpoint (when one
        was taken), hand the fresh (comm, pm) back for re-binding.
        ``force``: rebuild a world whose workers are all alive — the
        watchdog's heal rung (:meth:`_watchdog_heal`), whose hung ranks
        are alive by definition."""
        line = "--force" if force else ""
        ckpt = DistributedMagics._last_ckpt_path
        if ckpt:
            # Verbatim, NOT shlex-quoted: arg_split keeps quote
            # characters inside the token (non-posix), so
            # _last_ckpt_path already holds exactly the token the user
            # typed; re-emitting it unchanged reproduces the same token
            # through dist_heal's parse.
            line += f" --restore {ckpt}"
        print("\n🛡  supervisor: auto-healing...")
        self.dist_heal(line.strip())
        if not self._running():
            raise RuntimeError("auto-heal failed: the replayed "
                               "%dist_init did not bring the world up")
        return DistributedMagics._comm, DistributedMagics._pm

    def _watchdog_heal(self):
        """The watchdog's heal rung: a forced :meth:`_supervised_heal`.
        The JAX package wires the unforced callback, whose
        ``%dist_heal`` finds every hung rank alive, rebuilds nothing and
        hands the same world back; the watchdog then re-detects the
        hang and heals "again" every poll (ROADMAP queue A)."""
        return self._supervised_heal(force=True)

    def dist_supervise(self, line):
        """Auto-heal supervisor: watches process deaths + heartbeat
        staleness; on death, takes a postmortem bundle, replays
        %dist_init and restores the last %dist_checkpoint, within a
        capped restart budget.  ``%dist_supervise on [knobs] | off |
        status``; every transition also shows in %dist_status."""
        from ..resilience.supervisor import Supervisor, SupervisorPolicy
        args = _parse("dist_supervise", line)
        sup = DistributedMagics._supervisor
        if args.command == "off":
            if sup is None:
                print("supervisor: not running")
                return
            sup.stop()
            DistributedMagics._supervisor = None
            print("✅ supervisor stopped")
            self._note_supervised(False)
            return
        if args.command == "status":
            if sup is None:
                print("supervisor: not running (%dist_supervise on)")
            else:
                print(sup.describe())
            return
        if not self._require_cluster():
            return
        if sup is not None:
            sup.stop()
        policy = SupervisorPolicy(
            degraded_after_s=args.degraded_after,
            max_restarts=args.max_restarts,
            restart_window_s=args.window,
            auto_heal=not args.no_auto)
        sup = Supervisor(policy, heal=self._supervised_heal)
        sup.attach(self._comm, self._pm)
        DistributedMagics._supervisor = sup
        self._note_supervised(True)
        print(f"✅ supervising {self._world} workers: auto-heal "
              f"{'ON' if policy.auto_heal else 'OFF'}, budget "
              f"{policy.max_restarts} restarts/{policy.restart_window_s:.0f}s, "
              f"degraded after {policy.degraded_after_s:.0f}s silence"
              + ("" if DistributedMagics._last_ckpt_path else
                 " · no checkpoint yet — heal will restore nothing "
                 "(%dist_checkpoint to protect state)"))

    @staticmethod
    def _note_supervised(on: bool) -> None:
        """Record the supervision flag in the session manifest:
        ``%dist_attach`` re-arms supervision when it says so."""
        from ..resilience import session as session_mod
        d = _knobs.get_str("NBD_RUN_DIR")
        if d:
            session_mod.update_manifest(d, supervised=on)

    def dist_guard(self, line):
        """Training-integrity guard control: ``%dist_guard`` reports
        each rank's TrainGuard (skips, audits, repairs, rollbacks,
        quarantine suspects); ``on``/``off`` toggles the host-side
        machinery; ``audit`` forces a replica-consistency audit now on
        every rank (the fan-out is what keeps the audit's all-gather
        aligned)."""
        args = _parse("dist_guard", line)
        if not self._require_cluster():
            return
        action = args.command
        try:
            resps = self._comm.send_to_all("guard", {"action": action},
                                           timeout=60)
        except Exception as e:
            print(f"❌ guard {action} failed: {e}")
            return
        for r in sorted(resps):
            d = resps[r].data or {}
            if d.get("error"):
                print(f"🔹 rank {r}: ⚠ {d['error']}")
                continue
            if not d.get("active"):
                print(f"🔹 rank {r}: enabled={d.get('enabled')} · "
                      f"no live TrainGuard")
                continue
            line_out = (f"🔹 rank {r}: step {d.get('step')} · "
                        f"skips {d.get('skips')} "
                        f"(streak {d.get('skip_streak')}/"
                        f"{d.get('skip_budget')}) · "
                        f"audits {d.get('audits')} "
                        f"(last @{d.get('last_audit_step')}: "
                        f"{d.get('last_verdict')}) · "
                        f"repairs {d.get('repairs')} · "
                        f"rollbacks {d.get('rollbacks')}")
            if d.get("suspects"):
                line_out += f" · 🔶 suspects {d['suspects']}"
            print(line_out)
        if action == "audit":
            print("✅ audit fanned out to every rank")
        elif action in ("on", "off"):
            print(f"✅ guard {action}")

    # ==================================================================
    # hang watchdog + stuck-cell doctor

    def _maybe_start_watchdog(self) -> None:
        """Arm (or, after a heal, re-bind) the hang watchdog for the
        world that just came up.  Policy comes from the NBD_HANG_* env
        knobs (NBD_HANG=0 disables; %dist_watchdog reconfigures)."""
        from ..resilience.watchdog import HangPolicy, HangWatchdog
        wd = DistributedMagics._watchdog
        if wd is not None:
            # Heal path: the surviving watchdog re-binds to the fresh
            # world, keeping any %dist_watchdog-customized policy —
            # before any env parsing, so it never keeps watching the
            # torn-down world's comm/pm.
            wd.attach(self._comm, self._pm)
            return
        try:
            policy = HangPolicy.from_env()
        except ValueError as e:
            print(f"⚠️ hang watchdog NOT started: {e}")
            return
        if not policy.enabled:
            return
        wd = HangWatchdog(policy, heal=self._watchdog_heal)
        wd.attach(self._comm, self._pm)
        DistributedMagics._watchdog = wd

    @staticmethod
    def _hang_piggyback_off() -> bool:
        """Workers gate the heartbeat collective-position piggyback on
        NBD_HANG at SPAWN time: with it off, a coordinator-side
        watchdog can only ever see coarse busy state (stall detection;
        no skew, no --deadline)."""
        return not _knobs.get_bool("NBD_HANG", True)

    def dist_watchdog(self, line):
        """Collective hang watchdog: compares every rank's position in
        the collective stream (piggybacked on heartbeats; the seeded
        ``dist``'s collectives count) and flags a cell HUNG — cross-rank
        skew, absolute stall, or a blown ``%%distributed --deadline`` —
        distinct from merely slow, then walks the escalation ladder:
        warn → stack-dump (SIGUSR1) → interrupt → heal.
        ``%dist_watchdog on [knobs] | off | status``; armed at
        %dist_init unless NBD_HANG=0.

        On NCCL, ``interrupt`` breaks a cell looping in Python, and its
        worker survives; it cannot break a rank blocked in CUDA behind
        a collective its peer never joined (the SIGINT waits for the
        main thread to return to Python, and the collective stays
        enqueued): only ``heal`` clears that.  The process group's
        timeout (120 s) bounds every NCCL collective as well: when it
        fires, torch aborts the communicator and the rank exits, which
        the supervisor reads as a death.  So with ``heal`` on the
        ladder, keep ``--stall``/``--skew`` plus the ladder's grace
        steps well inside 120 s (the default stall window is 120 s)."""
        from ..resilience.watchdog import (HangPolicy, HangWatchdog,
                                           parse_ladder)
        args = _parse("dist_watchdog", line)
        wd = DistributedMagics._watchdog
        if args.command != "on" and any(
                v is not None for v in (args.skew, args.stall,
                                        args.poll, args.grace,
                                        args.escalate)):
            # Knobs without 'on' would be parsed and silently dropped
            # — the user would believe the policy changed.
            print("❌ policy flags require the 'on' subcommand "
                  "(%dist_watchdog on --stall ...); nothing changed")
            return
        if args.command == "off":
            if wd is None:
                print("hang watchdog: not running")
                return
            wd.stop()
            DistributedMagics._watchdog = None
            print("✅ hang watchdog stopped")
            return
        if args.command == "status":
            if wd is None:
                print("hang watchdog: not running (%dist_watchdog on)")
            else:
                print(wd.describe())
            return
        if not self._require_cluster():
            return
        # Lenient env parse: a typo'd NBD_HANG_ESCALATE must not wedge
        # the one command that can fix it.
        base = (wd.policy if wd is not None
                else HangPolicy.from_env_lenient())
        try:
            policy = HangPolicy(
                enabled=True,
                poll_s=args.poll if args.poll is not None
                else base.poll_s,
                skew_s=args.skew if args.skew is not None
                else base.skew_s,
                stall_s=args.stall if args.stall is not None
                else base.stall_s,
                grace_s=args.grace if args.grace is not None
                else base.grace_s,
                escalate=parse_ladder(args.escalate.strip("'\""))
                if args.escalate is not None else base.escalate)
        except ValueError as e:
            print(f"❌ {e}")
            return
        if wd is not None:
            # Reconfigure the LIVE instance: a policy change mid-hang
            # must not zero ladder progress, counters, or history.
            wd.set_policy(policy)
        else:
            wd = HangWatchdog(policy, heal=self._watchdog_heal)
            wd.attach(self._comm, self._pm)
            DistributedMagics._watchdog = wd
        print(f"✅ hang watchdog ON: {policy.describe()}")
        if self._hang_piggyback_off():
            print("   ⚠ NBD_HANG=0: workers spawned with it send no "
                  "collective positions — skew/--deadline detection "
                  "is unavailable (coarse busy-stall only); unset "
                  "NBD_HANG and re-%dist_init for full detection")
        if "heal" in policy.escalate \
                and not DistributedMagics._last_ckpt_path:
            print("   · no checkpoint yet — a heal step would restore "
                  "nothing (%dist_checkpoint to protect state)")

    def dist_doctor(self, line):
        """The stuck-cell doctor: one report naming the lagging
        rank(s) and the divergence point — per-rank collective
        positions and busy ages, the skew table, in-flight requests,
        watchdog verdicts, freshly dumped all-thread stacks (SIGUSR1 →
        faulthandler, per-rank files under the run dir), and each
        flight ring's last events.  Works mid-hang: nothing here goes
        through the workers' (possibly wedged) serial request
        loops."""
        if self._pm is None or self._comm is None:
            print("❌ No cluster. %dist_init to start one.")
            return
        from ..resilience.watchdog import hang_report
        args = _parse("dist_doctor", line)
        ex = DistributedMagics._async_exec
        report = hang_report(self._comm, self._pm,
                             DistributedMagics._watchdog,
                             dump_stacks=not args.no_stacks,
                             async_window=(ex.snapshot()
                                           if ex is not None else None))
        print(report)
        if args.save:
            try:
                with open(args.save, "w") as f:
                    f.write(report + "\n")
                print(f"✅ report → {args.save}")
            except OSError as e:
                print(f"❌ could not write {args.save}: {e}")

    # ==================================================================
    # pre-dispatch cell vetting

    @classmethod
    def _lint_mode_now(cls) -> str:
        """The effective vetting mode: the pinned value, else the
        NBD_LINT env knob, else ``warn``."""
        if cls._lint_mode is not None:
            return cls._lint_mode
        mode = (_knobs.get_str("NBD_LINT", "warn") or "warn").lower()
        return mode if mode in ("warn", "strict", "off") else "warn"

    @staticmethod
    def _note_effects(code: str) -> None:
        """Record a dispatched cell's effect footprint in the
        preflight store: the substrate of the session dependency DAG
        ``%dist_lint deps`` renders and the async in-flight window
        consults.  Best effort — effect inference must never break
        dispatch."""
        try:
            from ..analysis import infer_effects, preflight
            from ..runtime.collective_guard import cell_hash
            preflight.note_effects(cell_hash(code),
                                   infer_effects(code))
        except Exception:
            pass

    def _vet_cell(self, code: str, ranks: list[int], *,
                  strict: bool = False) -> bool:
        """Statically vet a cell BEFORE ``send_to_ranks``:
        rank-conditional collectives, subset-rankspec collectives,
        rank-conditional early exits, blocking host syncs in loops,
        namespace shadowing.  Findings print as inline annotations;
        error-severity findings block dispatch only under
        ``--strict`` / ``%dist_lint strict``.  Returns False when the
        cell must not ship.  Unparseable source NEVER blocks — it
        degrades to the legacy regex warning for subset cells and
        dispatches.  Every cell that WILL dispatch also gets its
        effect footprint recorded (``_note_effects``); ``off`` mode
        skips analysis entirely, effect tracking included."""
        mode = self._lint_mode_now()
        if mode == "off" and not strict:
            return True  # an explicit per-cell --strict still vets
        try:
            from .. import analysis
            res = analysis.vet_cell(code, ranks=ranks,
                                    world=self._world)
        except Exception:
            return True  # the analyzer must never break dispatch
        if not res.parsed:
            if len(ranks) < self._world \
                    and _COLLECTIVE_TOKENS.search(code):
                print(f"⚠️ Cell names a collective but targets only "
                      f"ranks {ranks} of {self._world}. A collective "
                      "run by a subset deadlocks the mesh; %sync can "
                      "realign after errors.")
            # Unparseable cells still dispatch — their footprint is
            # OPAQUE, which poisons the dependency DAG on purpose.
            self._note_effects(code)
            return True
        if not res.findings:
            self._note_effects(code)
            return True
        from ..analysis import preflight
        from ..observability import flightrec
        from ..observability import metrics as obs_metrics
        from ..runtime.collective_guard import cell_hash
        sha = cell_hash(code)
        reg = obs_metrics.registry()
        for f in res.findings:
            reg.counter("nbd_lint_findings_total",
                        "pre-dispatch cell-vetting findings",
                        {"rule": f.rule}).inc()
            flightrec.record("lint_finding", rule=f.rule,
                             severity=f.severity, line=f.line,
                             cell=sha)
            print(f.render())
        errors = res.errors
        if errors and (strict or mode == "strict"):
            print(f"⛔ cell NOT dispatched: {len(errors)} error-"
                  f"severity finding(s) under strict vetting — fix "
                  f"the cell, or loosen with %dist_lint warn (or "
                  f"drop --strict) to dispatch anyway")
            return False
        # Dispatched despite findings: remember them so a later
        # diagnosis of this cell can cite the pre-flight warning.
        preflight.note(sha, res.findings)
        self._note_effects(code)
        return True

    @staticmethod
    def _render_effects_entry(e: dict, *, verbose: bool) -> str:
        """One dispatched cell's footprint as a compact line."""
        col = e.get("collective_verdict", "?")
        n = len(e.get("collectives") or ())
        if col == "exact":
            col = f"exact({n})"
        flags = []
        if e.get("opaque"):
            flags.append("OPAQUE")
        if e.get("host_sync_in_loop"):
            flags.append("host-sync-loop")
        elif e.get("host_sync"):
            flags.append("host-sync")
        if e.get("pure"):
            flags.append("pure")

        def names(key, cap=6):
            vals = list(e.get(key) or ())
            if not vals:
                return "∅"
            shown = ", ".join(vals[:cap])
            extra = len(vals) - cap
            return shown + (f" +{extra}" if extra > 0 else "")

        line = (f"#{e['seq']} {e['sha'][:8]} · collectives={col}"
                + (f" [{' '.join(flags)}]" if flags else ""))
        if verbose:
            line += (f"\n      writes {names('writes')} · mutates "
                     f"{names('mutates')} · dels {names('deletes')}"
                     f"\n      reads  {names('reads', 8)}")
            sites = e.get("collectives") or ()
            if sites:
                line += "\n      order  " + " → ".join(
                    f"{s['op']}@L{s['line']}"
                    + (f"(via {s['via']})" if s.get("via") else "")
                    for s in sites[:8])
            for t in (e.get("taints") or ())[:3]:
                line += f"\n      ? {t}"
            for r in (e.get("opaque_reasons") or ())[:3]:
                line += f"\n      ! {r}"
        return line

    def dist_lint(self, line):
        """Pre-dispatch SPMD cell vetting: every ``%%distributed`` /
        ``%%rank`` / auto-distributed cell is AST-analyzed
        coordinator-side before dispatch — rank-conditional
        collectives (``if rank == 0: dist.all_reduce(t)`` deadlocks
        the process group), collectives in subset-``%%rank`` cells,
        rank-conditional ``return``/``break``/``raise`` that desync
        the collective sequence, blocking host syncs inside loops
        (``.item()``, ``.cpu()``, ``torch.cuda.synchronize()``,
        printing device values), and shadowed framework names.
        ``%dist_lint warn`` (default) annotates, ``strict`` blocks
        error-severity cells, ``off`` disables; the NBD_LINT env knob
        sets the session default, and ``%%distributed --strict`` arms
        strict for one cell.  Never blocks on unparseable source.

        ``%dist_lint effects`` lists each dispatched cell's inferred
        effect footprint (reads/writes, ordered collective sites,
        opacity); ``%dist_lint deps`` renders the session cell
        dependency DAG (RAW/WAR/WAW hazard edges) — the gate of the
        async window; ``--dot`` emits it as Graphviz dot.

        ``%dist_lint self`` runs the framework's own ten self-lint
        passes over the checkout — the CLI ``nbd-torch-lint --self``
        in-notebook: env-knob / codec-header / protocol registries,
        thread-shared-state, the lock-discipline passes (lock-order,
        blocking-under-lock, callback-under-lock), and the lifecycle
        passes (resource-leak, bracket-discipline,
        shutdown-completeness) — and reports per-pass counts."""
        args = _parse("dist_lint", line)
        if args.command == "self":
            from ..analysis.cli import _repo_root
            from ..analysis.selfcheck import _PKG, run_self_lint
            root = _repo_root(None)
            if root is None:
                print(f"🔎 %dist_lint self needs a repo checkout "
                      f"(README.md next to {_PKG}/) — from an "
                      f"installed wheel run `nbd-torch-lint --self "
                      f"--root <checkout>` instead")
                return
            results = run_self_lint(root)
            total = sum(len(v) for v in results.values())
            print(f"🔎 framework self-lint — {len(results)} passes "
                  f"over {root}:")
            for name, findings in results.items():
                status = ("clean" if not findings
                          else f"{len(findings)} finding(s)")
                print(f"   · {name}: {status}")
                for f in findings[:5]:
                    print(f"     {f.render()}")
                if len(findings) > 5:
                    print(f"     … +{len(findings) - 5} more "
                          f"(nbd-torch-lint --self for the full list)")
            print("   all passes clean ✅" if not total
                  else f"   {total} finding(s) — the self-lint gate "
                       f"fails on these")
            return
        if args.command in ("deps", "effects"):
            from ..analysis import preflight
            entries = preflight.effects_log()
            if not entries:
                print("🔎 no dispatched cells recorded this session "
                      "(effect footprints are captured at dispatch; "
                      "%dist_lint off disables them)")
                return
            if args.command == "effects":
                print(f"🔎 effect footprints — {len(entries)} "
                      f"dispatched cell(s), oldest first:")
                for e in entries:
                    print("  " + self._render_effects_entry(
                        e, verbose=True))
                return
            dag = preflight.deps_dag()
            if args.dot:
                print(preflight.dag_to_dot(dag))
                return
            by_dst: dict = {}
            for edge in dag["edges"]:
                by_dst.setdefault(edge["dst"], []).append(edge)
            print(f"🔎 cell dependency DAG — {len(dag['nodes'])} "
                  f"cell(s), {len(dag['edges'])} write→read edge(s):")
            for e in dag["nodes"]:
                print("  " + self._render_effects_entry(
                    e, verbose=False))
                for edge in by_dst.get(e["seq"], ()):
                    names = ", ".join(edge["names"][:6])
                    extra = len(edge["names"]) - 6
                    if extra > 0:
                        names += f" +{extra}"
                    print(f"      ← #{edge['src']} via {{{names}}}")
            if not dag["edges"]:
                print("   (no edges: every recorded cell is "
                      "independent — safe to overlap)")
            return
        if args.command == "status":
            mode = self._lint_mode_now()
            src = ("pinned by %dist_lint"
                   if DistributedMagics._lint_mode is not None
                   else "from NBD_LINT / default")
            print(f"🔎 cell vetting: {mode} ({src})")
            from ..observability import metrics as obs_metrics
            counters = obs_metrics.registry().to_json()["counters"]
            found = {k: v for k, v in counters.items()
                     if k.startswith("nbd_lint_findings_total")}
            if found:
                print("   findings this session:")
                for k in sorted(found):
                    rule = k.split('rule="')[-1].rstrip('"}')
                    print(f"   · {rule}: {found[k]:.0f}")
            else:
                print("   no findings this session")
            return
        DistributedMagics._lint_mode = args.command
        verb = {"strict": "ON (strict — error-severity cells are "
                          "blocked pre-dispatch)",
                "warn": "ON (annotate only)",
                "off": "OFF"}[args.command]
        print(f"✅ cell vetting {verb}")

    # ==================================================================
    # async pipelined execution

    @classmethod
    def _async_window_armed(cls) -> bool:
        """Session-wide async mode: NBD_ASYNC_WINDOW > 0 makes every
        %%distributed cell stream through the window by default
        (--sync opts out per cell)."""
        return _knobs.get_int("NBD_ASYNC_WINDOW", 0) > 0

    def _ensure_async_executor(self):
        """The lazily-built AsyncExecutor over the live comm.  One per
        fleet: reset_class_state/shutdown_all drop it with the comm."""
        cls = DistributedMagics
        ex = cls._async_exec
        if ex is not None and ex.comm is self._comm:
            return ex
        from ..messaging.pipeline import AsyncExecutor
        ex = AsyncExecutor(
            self._comm,
            on_hold=lambda reason: print(f"⧗ held: {reason} — "
                                         "waiting for the window"),
            on_result=self._async_cell_done)
        cls._async_exec = ex
        return ex

    @staticmethod
    def _async_cell_done(cell) -> None:
        """Executor completion hook (IO thread): surface an async
        cell's ERROR the moment its reply lands — stdout already
        streamed live; a quiet success needs no echo, a silent error
        would vanish."""
        fut = cell.future
        if fut.state == "error" and not fut.consumed:
            fut.consumed = True
            print(f"\n✗ async cell #{fut.seq}: {fut.error}")

    def _warn_unconsumed_async(self) -> None:
        """The next-cell warn pass (the proxy-future consumption
        contract): errored futures nobody inspected are announced
        once instead of vanishing."""
        ex = DistributedMagics._async_exec
        if ex is None:
            return
        for fut in ex.unconsumed_errors():
            print(f"⚠️ async cell #{fut.seq} errored un-inspected: "
                  f"{fut.error} (.result() on its handle re-raises)")

    def _drain_async(self, why: str,
                     timeout: float | None = None) -> list:
        """Drain the in-flight window (the sync points: a synchronous
        cell, %sync, %dist_wait, %dist_shutdown, %dist_reset).
        Errors surface here — rendered once, futures marked
        consumed."""
        ex = DistributedMagics._async_exec
        if ex is None or ex.depth == 0:
            return []
        depth = ex.depth
        print(f"⧗ draining async window ({depth} in flight) — {why}")
        try:
            futures = ex.drain(timeout)
        except KeyboardInterrupt:
            print("🛑 drain interrupted — cells keep running on the "
                  "workers; %dist_wait to re-drain")
            return []
        for fut in futures:
            if fut.state == "error" and not fut.consumed:
                fut.consumed = True
                print(f"✗ async cell #{fut.seq}: {fut.error}")
        return futures

    def dist_wait(self, line):
        """Drain the async in-flight window: block until every
        ``%%distributed --async`` / ``NBD_ASYNC_WINDOW``-streamed cell
        has completed, render any errors, and refresh the IDE
        proxies.  The explicit sync point of async pipelined
        execution — a synchronous cell or ``%sync`` drains
        implicitly."""
        args = _parse("dist_wait", line)
        ex = DistributedMagics._async_exec
        if ex is None or ex.depth == 0:
            snap = ex.snapshot() if ex is not None else {}
            done = snap.get("completed", 0)
            print("✅ async window empty"
                  + (f" · {done} cell(s) completed this session, "
                     f"{snap.get('errored', 0)} errored"
                     if done else ""))
            return
        futures = self._drain_async("%dist_wait", args.timeout)
        still = [f for f in futures if not f.done]
        ok = sum(1 for f in futures if f.state == "done")
        err = sum(1 for f in futures if f.state == "error")
        print(f"✅ drained {ok} cell(s)"
              + (f" · {err} errored" if err else "")
              + (f" · {len(still)} still in flight (--timeout hit)"
                 if still else ""))
        if not still and self._running():
            self._sync_ide_quietly()

    def _run_async(self, code: str, ranks: list[int], *,
                   deadline_s=None, repeat=None, until=None,
                   vet_s=None):
        """Submit one cell through the async window and return its
        CellFuture (the cell magic's return value — IPython's display
        hook echoes the pending handle; the executor resolves it when
        the replies land)."""
        from ..analysis import preflight
        from ..runtime.collective_guard import cell_hash
        sha = cell_hash(code)
        # The entry _note_effects just recorded for THIS cell — the
        # admission gate's footprint (None → treated opaque, which
        # drains the window and serializes; %dist_lint off lands here
        # on purpose: no proofs, no overlap).
        entry = preflight.effects_for(sha)
        ex = self._ensure_async_executor()
        # The timeline row records the SUBMISSION (per-rank durations
        # live on the future; the row closes immediately — an async
        # cell must not look like a still-running cell forever).
        rec = self._timeline.start(code, ranks, kind="async")
        self._timeline.finish(rec, None)
        try:
            fut = ex.submit_cell(
                code, ranks, entry=entry, sha=sha,
                deadline_s=deadline_s, repeat=repeat, until=until,
                vet_s=vet_s)
        except KeyboardInterrupt:
            print("🛑 interrupted while held at the window gate — "
                  "nothing was submitted (%dist_wait drains the "
                  "window)")
            return None
        except Exception as e:
            print(f"❌ async submit failed: {type(e).__name__}: {e}")
            return None
        snap = ex.snapshot()
        print(f"⧗ async cell #{fut.seq} streamed to ranks {ranks} "
              f"(window {snap['depth']}/{snap['window']}"
              + (f", collective stream held by "
                 f"#{snap['collective_holder']}"
                 if snap.get("collective_holder") is not None else "")
              + ") — %dist_wait drains")
        return fut

    # ==================================================================
    # execution magics

    def distributed(self, line, cell):
        """Run the cell on every worker (reference: magic.py:1042-1129).
        ``--deadline 60`` arms a per-cell budget the hang watchdog
        enforces through its escalation ladder.  ``--async`` streams
        the cell through the bounded in-flight window and returns a
        pending future; ``--strict`` blocks it on an error-severity
        finding; ``--repeat K [--until EXPR]`` compiles once and loops
        worker-side.  In tenant mode (``%dist_attach --tenant``) the
        cell is submitted to the gateway pool instead — same vetting,
        explicit queued/shed verdicts, ``--priority``, per-tenant
        isolated namespace."""
        self._warn_unconsumed_async()
        if DistributedMagics._tenant is not None:
            try:
                args = _parse("distributed", line)
            except Exception as e:
                print(f"❌ {e}")
                return
            if args.use_async or args.repeat is not None:
                print("⚠️ --async/--repeat are single-kernel options "
                      "(the pool's scheduler owns tenant-mode "
                      "overlap) — dispatching synchronously")
            if not self._vet_cell(cell, list(range(self._world)),
                                  strict=args.strict):
                return
            return self._run_on_pool(cell, priority=args.priority,
                                     deadline_s=args.deadline)
        if not self._require_cluster():
            return
        try:
            args = _parse("distributed", line)
        except Exception as e:
            print(f"❌ {e}")
            return
        if args.priority is not None:
            print("⚠️ --priority only applies in tenant (pool) mode "
                  "— ignored")
        if args.use_async and args.use_sync:
            print("❌ choose one of --async / --sync")
            return
        if args.until is not None:
            # IPython's non-posix arg_split keeps quote chars inside
            # the token: without the strip, --until 'loss < 0.1'
            # evaluates a quoted STRING — always truthy — and stops
            # after one step.  Strip ONE matching outer pair only
            # (the expression may legitimately end in a quote:
            # --until "phase == 'done'").
            u = args.until.strip()
            if len(u) >= 2 and u[0] == u[-1] and u[0] in "'\"":
                u = u[1:-1]
            args.until = u
        if args.until and args.repeat is None:
            print("❌ --until requires --repeat K")
            return
        if args.repeat is not None and args.repeat < 1:
            print("❌ --repeat needs K >= 1")
            return
        if args.deadline is not None:
            if DistributedMagics._watchdog is None:
                print("⚠️ --deadline set but the hang watchdog is off "
                      "(%dist_watchdog on) — the budget will not be "
                      "enforced")
            elif self._hang_piggyback_off():
                print("⚠️ --deadline set but workers were spawned "
                      "with NBD_HANG=0 (no heartbeat piggyback) — "
                      "the budget will not be enforced")
        t_vet = time.monotonic()
        if not self._vet_cell(cell, list(range(self._world)),
                              strict=args.strict):
            return
        use_async = (args.use_async
                     or (self._async_window_armed()
                         and not args.use_sync))
        if use_async:
            # The window path: return the pending future — IPython's
            # display hook echoes it; the executor resolves it when
            # the replies land.  Its admission gate consults the
            # footprint _vet_cell just recorded.
            return self._run_async(
                cell, list(range(self._world)),
                deadline_s=args.deadline, repeat=args.repeat,
                until=args.until, vet_s=time.monotonic() - t_vet)
        result = self._run_on_ranks(cell, list(range(self._world)),
                                    kind="distributed",
                                    deadline_s=args.deadline,
                                    vet_s=time.monotonic() - t_vet,
                                    repeat=args.repeat,
                                    until=args.until)
        if result is not None:
            self._sync_ide_quietly()

    def rank(self, line, cell):
        """Run the cell on selected ranks: ``%%rank [0,2]`` / ``[0-2]``
        (reference: magic.py:1476-1565)."""
        self._warn_unconsumed_async()
        if not self._require_cluster():
            return
        try:
            ranks = rankspec.parse_ranks(line, self._world)
        except rankspec.RankSpecError as e:
            print(f"❌ {e}")
            return
        # Pre-dispatch vetting with the SUBSET context armed: the
        # analyzer upgrades the old regex warning to real findings
        # (calls = error under strict, bare references = warning) and
        # falls back to the regex only for unparseable source.
        t_vet = time.monotonic()
        if not self._vet_cell(cell, ranks):
            return
        self._run_on_ranks(cell, ranks, kind="rank",
                           vet_s=time.monotonic() - t_vet)

    def dist_interrupt(self, line):
        """SIGINT worker process(es) so the running cell aborts with a
        KeyboardInterrupt error and the workers stay alive.

        While a distributed cell is executing, the kernel itself is
        busy — use Jupyter's interrupt button (Ctrl-C) instead, which
        this framework forwards to the workers automatically; this
        magic is for targeted/after-the-fact signaling.  Limits: a cell
        blocked *inside* a native collective or kernel aborts only when
        that native call returns, and interrupting a subset of ranks
        mid-collective leaves the others blocked (run a full interrupt,
        then %sync)."""
        if not self._require_cluster():
            return
        args = _parse("dist_interrupt", line)
        ranks = None
        if args.ranks:
            try:
                ranks = rankspec.parse_ranks(args.ranks, self._world)
            except rankspec.RankSpecError as e:
                print(f"❌ {e}")
                return
        signaled = self._pm.interrupt(ranks)
        print(f"🛑 interrupt sent to ranks {signaled}")
        if ranks is not None and len(signaled) < self._world:
            print("⚠️ subset interrupt: if the cell was running a "
                  "collective, the un-signaled ranks stay blocked in "
                  "it — interrupt all ranks, then %sync.")
        # SIGINT delivery is asynchronous: a signal aimed at an *idle*
        # worker can land inside the NEXT cell and abort it instead.
        # Absorb that race with a sacrificial probe cell — it either
        # returns normally (signal was consumed by the idle recv) or
        # eats the late KeyboardInterrupt itself.  Short timeout: a
        # worker stuck in a native call can't serve the probe, and the
        # magic must not stall the kernel.
        try:
            self._comm.send_to_ranks(signaled, "execute",
                                     "'interrupt-probe'", timeout=2)
        except Exception:
            pass  # a busy/aborting worker answers the probe late; fine

    def sync(self, line):
        """Barrier across all workers (reference: magic.py:1567-1587).
        Also a sync point for the async window: in-flight streamed
        cells drain (and surface their errors) before the barrier."""
        if not self._require_cluster():
            return
        self._drain_async("%sync barrier")
        try:
            self._comm.send_to_all("sync", timeout=120)
            print(f"✅ All {self._world} workers synchronized")
        except Exception as e:
            print(f"❌ sync failed: {e}")

    # ==================================================================
    # auto-distributed mode (input transformer)

    def _auto_transformer(self, lines: list[str]) -> list[str]:
        """Prepend %%distributed to plain cells (reference:
        magic.py:709-741).  Skips magics, shell escapes, help syntax and
        comment-only cells."""
        if not DistributedMagics._auto_active or not lines:
            return lines
        stripped = [ln.strip() for ln in lines]
        first = next((s for s in stripped if s), "")
        if not first:
            return lines
        if first.startswith(("%", "!", "?")) or first.endswith("?"):
            return lines
        if all(s.startswith("#") or not s for s in stripped):
            return lines
        return ["%%distributed\n"] + lines

    def _enable_auto_mode(self) -> None:
        shell = self.shell
        if self._auto_transformer not in shell.input_transformers_cleanup:
            shell.input_transformers_cleanup.append(self._auto_transformer)
        DistributedMagics._auto_active = True

    def _disable_auto_mode(self) -> None:
        shell = self.shell
        try:
            shell.input_transformers_cleanup.remove(self._auto_transformer)
        except ValueError:
            pass
        DistributedMagics._auto_active = False

    def dist_mode(self, line):
        """Toggle auto-distribution of plain cells
        (reference: magic.py:1626-1677)."""
        args = _parse("dist_mode", line)
        if args.enable and args.disable:
            print("❌ choose one of -e / -d")
            return
        if args.enable:
            if not self._require_cluster():
                return
            self._enable_auto_mode()
            print("✅ Auto-distributed mode ON — plain cells run on all "
                  "workers")
        elif args.disable:
            self._disable_auto_mode()
            print("✅ Auto-distributed mode OFF — cells run locally; use "
                  "%%distributed / %%rank explicitly")
        else:
            state = "ON" if DistributedMagics._auto_active else "OFF"
            print(f"Auto-distributed mode: {state}")

    # ==================================================================
    # status / debug

    def dist_status(self, line):
        """Cluster tree report (reference: magic.py:743-809): per rank
        its process, its device (``cuda:i`` and the card's name, from
        the worker's ``get_status``), its memory and the process
        group's backend.  In tenant mode this is the POOL view:
        scheduler queue, tenant table (this tenant starred),
        tenant-attributed busy ranks."""
        if DistributedMagics._tenant is not None:
            client = DistributedMagics._tenant
            info = DistributedMagics._pool_info or {}
            print(f"🌐 tenant {client.name!r} @ pool "
                  f"{info.get('run_dir', '?')} · epoch "
                  f"{client.epoch} · "
                  f"{'alive' if client.alive else '💀 gateway gone'}")
            try:
                st = client.pool_status()
            except Exception as e:
                print(f"   (pool status unavailable: {e})")
                return
            self._render_pool_status(st, info.get("run_dir"))
            return
        if self._pm is None:
            print("❌ No cluster. %dist_init to start one.")
            return
        proc_status = self._pm.get_status()
        live: dict[int, dict] = {}
        alive = self._pm.alive_ranks()
        # Heartbeats carry the worker loop's busy state; a rank busy in
        # a long cell cannot answer get_status (the request loop is
        # serial), so probing it would stall this magic for the full
        # timeout — skip busy ranks and report what the pings say.
        busy: dict[int, dict] = {}
        if self._comm is not None:
            from ..runtime.worker import HEARTBEAT_INTERVAL_S
            now = time.time()
            for r in alive:
                ping = self._comm.last_ping(r)
                if (ping is not None and ping[1].get("busy_s") is not None
                        and now - ping[0] < 3 * HEARTBEAT_INTERVAL_S):
                    busy[r] = {"type": ping[1].get("busy_type"),
                               "s": ping[1]["busy_s"] + (now - ping[0])}
                    col = ping[1].get("col")
                    # Seconds since the rank last ENTERED a collective
                    # — a long cell actively advancing through
                    # collectives is busy, never stalled.
                    busy[r]["col_age"] = (
                        (col.get("age") or 0) + (now - ping[0])
                        if col else None)
        idle = [r for r in alive if r not in busy]
        if self._comm is not None and idle:
            try:
                resp = self._comm.send_to_ranks(idle, "get_status",
                                                timeout=5)
                live = {r: m.data for r, m in resp.items()}
            except Exception:
                pass  # degrade to process-level info (reference does too)
        mode = "ON" if self._auto_active else "OFF"
        print(f"🌐 Cluster: {self._world} workers · backend="
              f"{self._pm.backend} · auto-mode {mode}")
        if self._comm is not None and getattr(self._comm,
                                              "session_token", None):
            from ..resilience import session as session_mod
            ttl = _knobs.get_raw("NBD_ORPHAN_TTL_S") or "600"
            print(f"🔑 session: run {_knobs.get_str('NBD_RUN_DIR', '-')}"
                  f" · token {session_mod.token_fingerprint(self._comm.session_token)}"
                  f" · epoch {self._comm.session_epoch}"
                  f" · {'attached' if DistributedMagics._attached else 'orphan-capable'}"
                  f" (orphan TTL {ttl}s)")
        connected = (set(self._comm.connected_ranks())
                     if self._comm is not None else None)
        # Stall threshold for the ⚠ state: the active watchdog's
        # verdicts, else the env-configured window — a rank busy beyond
        # it is rendered stalled even without a watchdog.
        wd = DistributedMagics._watchdog
        stalled: set = set()
        if wd is not None:
            # An armed watchdog is the authority: a rank is stalled
            # when its current assessment says HUNG, never merely
            # long-busy (the "distinct from slow" contract).
            for v in wd.last_verdicts:
                stalled.update(v.get("ranks") or ())
        else:
            from ..resilience.watchdog import HangPolicy
            pol = HangPolicy.from_env_lenient()
            # NBD_HANG=0 turns hang detection OFF everywhere — a long
            # legitimate cell must then render busy, never stalled.
            if pol.enabled:
                for r, b in busy.items():
                    if b["s"] > pol.stall_s and (
                            b.get("col_age") is None
                            or b["col_age"] > pol.stall_s):
                        stalled.add(r)
        # Multi-host worlds: group ranks per host, with the link's
        # health (RTT from clock samples, worst heartbeat age,
        # redeliveries ≈ loss) on each host header.
        hosts_map = dict(getattr(self._pm, "hosts", None) or {})
        multi = len(set(hosts_map.values())) > 1
        link = None
        if multi and self._comm is not None:
            try:
                link = self._comm.link_stats()
            except Exception:
                link = None
        order = (sorted(proc_status,
                        key=lambda r: (hosts_map.get(r, "local"), r))
                 if multi else sorted(proc_status))
        cur_host = None
        for rank_id in order:
            if multi:
                h = hosts_map.get(rank_id, "local")
                if h != cur_host:
                    cur_host = h
                    hdr = f"┌ host {h}"
                    hs = ((link or {}).get("hosts") or {}).get(h)
                    if hs:
                        from ..resilience.partition import \
                            format_link_suffix
                        hdr += f" · {format_link_suffix(hs)}"
                    print(hdr)
            p = proc_status[rank_id]
            if not p["running"]:
                state = f"✖ exited ({p['returncode']})"
            elif connected is not None and rank_id not in connected:
                # Process alive but not attached to THIS coordinator.
                state = "◌ orphaned"
            elif rank_id in stalled:
                # Alive and heartbeating, but stuck by the watchdog's
                # assessment (or, unarmed, busy past the stall window
                # with zero collective progress).
                state = "⚠ stalled"
            else:
                state = "● running"
            line_txt = f"├─ Rank {rank_id}: pid {p['pid']} {state}"
            if rank_id in live:
                st = live[rank_id]
                devs = st.get("devices", [])
                if devs:
                    d = devs[0]
                    line_txt += f" · {d['platform']}:{d['id']} ({d['kind']})"
                    mem = d.get("memory_gb") or {}
                    if mem.get("in_use") is not None:
                        line_txt += (f" · mem {mem['in_use']:.2f}"
                                     f"/{mem.get('limit') or 0:.2f} GB")
                line_txt += (f" · {st['world_size']} ranks on "
                             f"{st['backend']}")
                if st.get("profiling"):
                    line_txt += f" · 🔬 profiling → {st['profiling']}"
                if st.get("tracing"):
                    line_txt += (f" · 📡 tracing "
                                 f"({st.get('trace_spans', 0)} spans)")
            if rank_id in busy:
                b = busy[rank_id]
                line_txt += (f" · ⚙ busy: {b['type']} running "
                             f"{b['s']:.1f}s")
            if self._comm is not None:
                seen = self._comm.last_seen(rank_id)
                if seen is not None:
                    line_txt += f" · seen {time.time() - seen:.1f}s ago"
                # Heartbeat age as its own column: `seen` refreshes on
                # ANY frame, so a rank whose heartbeat thread froze is
                # only visible here.
                ping = self._comm.last_ping(rank_id)
                line_txt += (f" · hb {time.time() - ping[0]:.1f}s"
                             if ping is not None else " · hb –")
            print(line_txt)
        if self._comm is not None:
            # Clock-skew surfacing: big offsets silently degrade stage
            # attribution — say so here, where the operator looks.
            from ..observability import latency as lat_mod
            for w in lat_mod.skew_warnings(self._comm.clock.stats()):
                print(w)
        ex = DistributedMagics._async_exec
        if ex is not None:
            snap = ex.snapshot()
            if snap["depth"]:
                holder = snap.get("collective_holder")
                print(f"⧗ async window: {snap['depth']}/"
                      f"{snap['window']} in flight"
                      + (f" · collective stream held by cell "
                         f"#{holder}" if holder is not None
                         else " · all proven collective-free"))
                for c in snap["cells"]:
                    print(f"   #{c['seq']} {c['sha'] or '?'} · "
                          f"{c['collective']} · {c['age_s']}s in "
                          f"flight · {c['state']}")
            elif snap["submitted"]:
                print(f"⧗ async window idle · {snap['completed']} "
                      f"cell(s) completed"
                      + (f", {snap['errored']} errored"
                         if snap["errored"] else "")
                      + (f", held {snap['held_total']}×"
                         if snap["held_total"] else ""))
        sup = DistributedMagics._supervisor
        if sup is not None:
            print(sup.describe())
        if wd is not None:
            print(wd.describe())
        plan = self._comm.fault_plan() if self._comm is not None else None
        if plan is not None:
            print(f"💥 chaos active (coordinator side): {plan.counters}")
        if self._comm is not None and self._comm.tracer.enabled:
            print(f"📡 span trace active: {len(self._comm.tracer)} "
                  f"coordinator spans — %dist_trace save <path> / "
                  f"%dist_trace stop")

    def dist_logs(self, line):
        """Tail the raw process stdio of worker(s) — output that
        bypassed the streaming path (native-library prints, NCCL logs,
        crash output captured before the control plane came up).
        """
        if not self._require_cluster():
            return
        args = _parse("dist_logs", line)
        args.lines = max(1, args.lines)  # tail(0/-n) would mis-slice
        ranks = sorted(self._pm.io)
        if args.ranks:
            try:
                ranks = rankspec.parse_ranks(args.ranks, self._world)
            except rankspec.RankSpecError as e:
                print(f"❌ {e}")
                return
        for r in ranks:
            io = self._pm.io.get(r)
            text = io.tail(args.lines) if io else ""
            print(f"── rank {r} stdio (last {args.lines} lines) ──")
            print(text if text.strip() else "(empty)")

    def dist_debug(self, line):
        """Internals dump (reference: magic.py:1589-1624)."""
        print(f"comm manager : {self._comm}")
        if self._comm:
            print(f"  port       : {self._comm.port}")
            print(f"  connected  : {self._comm.connected_ranks()}")
        print(f"process mgr  : {self._pm}")
        if self._pm:
            print(f"  backend    : {self._pm.backend}")
            print(f"  dist port  : {self._pm.dist_port}")
            print(f"  status     : {self._pm.get_status()}")
        print(f"world size   : {self._world}")
        print(f"auto mode    : {self._auto_active}")
        print(f"timeline     : {len(self._timeline.records)} records")

    # ==================================================================
    # variable transfer (latent in the reference: SURVEY §2.1 #9)

    def dist_pull(self, line):
        """Copy a variable from worker(s) into the kernel namespace.
        Tensors come back as CPU tensors, numpy arrays as arrays.
        Values at or above ``NBD_XFER_THRESHOLD_BYTES`` stream over
        the chunked bulk plane (messaging/xfer.py) straight into
        preallocated destination arrays; smaller ones ride one
        round-trip."""
        if not self._require_cluster():
            return
        args = _parse("dist_pull", line)
        target = args.as_name or args.name
        ranks = (list(range(self._world)) if args.all_ranks
                 else [args.rank])
        pulled: dict = {}
        how = None
        for r in ranks:
            try:
                pulled[r], h = self._pull_one(r, args.name,
                                              readonly=args.readonly)
            except Exception as e:
                print(f"❌ rank {r}: {e}")
                return
            how = how or h
        suffix = f" [{how}]" if how else ""
        if args.all_ranks:
            self.shell.user_ns[target] = pulled
            print(f"✅ {target} = {{rank: value}} from "
                  f"{sorted(pulled)} ranks{suffix}")
        else:
            value = pulled[args.rank]
            self.shell.user_ns[target] = value
            print(f"✅ {target} = {self._describe_pulled(value)} "
                  f"(from rank {args.rank}){suffix}")

    def _pull_one(self, rank: int, name: str, *,
                  readonly: bool = False):
        """One rank's value: chunked plane first, legacy ``get_var``
        when the value cannot ride the buffer path.  Returns
        ``(value, how)`` where ``how`` describes a chunked move (None
        for the one-round-trip paths)."""
        from ..messaging import xfer
        try:
            value, stats = xfer.pull_value(self._comm, rank, name,
                                           readonly=readonly)
            how = None
            if stats.get("chunks"):
                how = (f"chunked: {stats['bytes'] / 1e6:.1f} MB in "
                       f"{stats['chunks']} chunks, "
                       f"{stats['seconds']:.1f}s")
            return value, how
        except xfer.XferFallback:
            pass
        resp = self._comm.send_to_rank(
            rank, "get_var", name, timeout=xfer.scaled_timeout(0))
        if resp.data.get("error"):
            raise RuntimeError(resp.data["error"])
        return self._pulled_value(resp, readonly=readonly), None

    @staticmethod
    def _describe_pulled(value) -> str:
        import numpy as np
        import torch
        if isinstance(value, torch.Tensor):
            return (f"tensor{tuple(value.shape)} "
                    f"{str(value.dtype).removeprefix('torch.')}")
        if isinstance(value, np.ndarray):
            return f"array{tuple(value.shape)} {value.dtype}"
        if isinstance(value, (dict, list, tuple)):
            return f"pytree ({type(value).__name__})"
        return repr(value)

    @staticmethod
    def _pulled_value(msg, readonly: bool = False):
        """Reconstruct one rank's get_var reply: a raw buffer (a CPU
        tensor when the worker's value was a tensor — its reply names
        the tensor's device), a pytree on the buffer path (treedef
        JSON + leaf bufs — no pickle), or a plain JSON value.
        Writable results are assembled with exactly ONE copy;
        ``readonly`` hands back the decode views of numpy leaves."""
        import numpy as np
        import torch

        from ..messaging.codec import copy_leaf, unflatten_pytree_wire

        def leaf(a, is_tensor: bool):
            if is_tensor and not isinstance(a, torch.Tensor):
                return torch.from_numpy(np.array(a))
            return a if readonly and not is_tensor else copy_leaf(a)

        if msg.data.get("array"):
            return leaf(msg.bufs["value"], "device" in msg.data)
        if msg.data.get("pytree") is not None:
            return unflatten_pytree_wire(msg.data["pytree"], msg.bufs,
                                         leaf)
        return msg.data.get("value")

    def dist_push(self, line):
        """Copy a kernel variable to workers' namespaces: arrays and
        tensors land as tensors on each rank's device.  Values at or
        above ``NBD_XFER_THRESHOLD_BYTES`` stream over the chunked
        bulk plane (crc-verified, resumable, window-bounded memory);
        smaller ones ride one legacy frame with a payload-scaled
        deadline."""
        if not self._require_cluster():
            return
        args = _parse("dist_push", line)
        if args.name not in self.shell.user_ns:
            print(f"❌ {args.name!r} is not defined in the kernel")
            return
        value = self.shell.user_ns[args.name]
        ranks = list(range(self._world))
        if args.ranks:
            try:
                ranks = rankspec.parse_ranks(args.ranks, self._world)
            except rankspec.RankSpecError as e:
                print(f"❌ {e}")
                return
        import numpy as np
        import torch

        from ..messaging import xfer
        est = xfer.approx_nbytes(value)
        if est >= xfer.threshold_bytes():
            try:
                stats = xfer.push_value(self._comm, ranks, args.name,
                                        value)
                extra = ""
                if stats["resumed_chunks"] or stats["resent_chunks"]:
                    extra = (f", resumed {stats['resumed_chunks']} / "
                             f"resent {stats['resent_chunks']}")
                print(f"✅ pushed {args.name} to ranks {ranks} "
                      f"[chunked: {stats['bytes'] / 1e6:.1f} MB in "
                      f"{stats['chunks']} chunks, "
                      f"{stats['seconds']:.1f}s{extra}]")
                return
            except xfer.XferFallback:
                pass        # not a buffer-path value: legacy frame
            except xfer.XferError as e:
                print(f"❌ push failed: {e}")
                return
        try:
            if isinstance(value, (np.ndarray, torch.Tensor)):
                buf = (value.detach().cpu() if isinstance(value,
                                                          torch.Tensor)
                       else value)
                self._comm.send_to_ranks(
                    ranks, "set_var", {"name": args.name},
                    bufs={"value": buf},
                    timeout=xfer.scaled_timeout(est))
            else:
                # Pytrees of arrays (params/optimizer state) take the
                # buffer path: treedef as JSON, leaves as raw bufs —
                # never the codec's pickle fallback.
                payload = {"name": args.name, "value": value}
                bufs = None
                if isinstance(value, (dict, list, tuple)):
                    from ..messaging.codec import flatten_pytree_wire
                    try:
                        meta, bufs = flatten_pytree_wire(value)
                        payload = {"name": args.name, "pytree": meta}
                    except TypeError:
                        bufs = None
                self._comm.send_to_ranks(
                    ranks, "set_var", payload, bufs=bufs,
                    timeout=xfer.scaled_timeout(est))
        except Exception as e:
            print(f"❌ push failed: {e}")
            return
        print(f"✅ pushed {args.name} to ranks {ranks}")

    # ==================================================================
    # IDE sync

    def _sync_ide_quietly(self) -> None:
        try:
            self._sync_ide(verbose=False)
        except Exception:
            pass

    def _sync_ide(self, verbose: bool = True) -> None:
        resp = self._comm.send_to_ranks([0], "get_namespace_info",
                                        timeout=30)
        info = resp[0].data.get("namespace_info", {})
        n = proxies.sync_namespace(self.shell.user_ns, info,
                                   DistributedMagics._proxy_registry)
        if verbose:
            print(f"✅ synced {n} names from rank 0 into the kernel "
                  "namespace (proxies)")

    def dist_sync_ide(self, line):
        """Refresh kernel-side proxies for worker variables
        (reference: magic.py:1756-1776)."""
        if not self._require_cluster():
            return
        try:
            self._sync_ide(verbose=True)
        except Exception as e:
            print(f"❌ IDE sync failed: {e}")

    # ==================================================================
    # checkpoint / restore (SURVEY §5.4 upgrade — absent in the reference,
    # whose users hand-roll torch.save in cells)

    def dist_checkpoint(self, line):
        """Snapshot named variables from every worker's namespace:
        ``%dist_checkpoint ckpt/step100 params opt_state``.  With
        ``--background`` the save overlaps subsequent cells; poll it
        with ``%dist_checkpoint --status``."""
        if not self._require_cluster():
            return
        args = _parse("dist_checkpoint", line)
        if args.status:
            try:
                resps = self._comm.send_to_all(
                    "checkpoint", {"action": "status"}, timeout=60)
            except Exception as e:
                print(f"❌ checkpoint status failed: {e}")
                return
            for r in sorted(resps):
                d = resps[r].data
                state = d.get("error") or d.get("status")
                extra = ""
                if d.get("status") == "done":
                    total = sum(v.get("bytes", 0) for v in
                                d.get("summary", {}).values())
                    extra = f" ({total / 1e6:.1f} MB)"
                print(f"🔹 Rank {r}: {state}{extra}")
            if DistributedMagics._bg_ckpt_path is not None:
                for r, m in resps.items():
                    if m.data.get("error"):
                        # A failed rank save disqualifies the whole
                        # checkpoint.
                        DistributedMagics._clear_bg_ckpt()
                        break
                    if m.data.get("status") == "done":
                        DistributedMagics._bg_ckpt_done.add(r)
                if (DistributedMagics._bg_ckpt_path is not None
                        and DistributedMagics._bg_ckpt_done
                        >= set(range(self._world))):
                    # Every rank finished cleanly (each said "done"
                    # once, over however many polls).
                    DistributedMagics._last_ckpt_path = \
                        DistributedMagics._bg_ckpt_path
                    DistributedMagics._clear_bg_ckpt()
            return
        if not args.path or not args.names:
            print("usage: %dist_checkpoint <path> <names...> "
                  "[--background] [--fetch DIR] | "
                  "%dist_checkpoint --status")
            return
        if args.fetch and args.background:
            # A background save has nothing on disk to ship yet; the
            # user can fetch once --status shows every rank done.
            print("❌ --fetch needs a sync save (drop --background)")
            return
        try:
            resps = self._comm.send_to_all(
                "checkpoint", {"action": "save", "path": args.path,
                               "names": args.names,
                               "background": args.background},
                timeout=600)
        except Exception as e:
            print(f"❌ checkpoint failed: {e}")
            return
        verb = (f"background save started → {args.path} "
                f"(poll: %dist_checkpoint --status)"
                if args.background else f"saved → {args.path}")
        for r in sorted(resps):
            prev = resps[r].data.get("previous_error")
            if prev:
                print(f"⚠️  Rank {r}: {prev}")
        if self._report_checkpoint(resps, verb):
            if args.background:
                DistributedMagics._bg_ckpt_path = args.path
                DistributedMagics._bg_ckpt_done = set()
            else:
                DistributedMagics._last_ckpt_path = args.path
                # This sync save is now the newest completed
                # checkpoint: drop any older background save still
                # pending promotion.
                DistributedMagics._clear_bg_ckpt()
                if args.fetch:
                    try:
                        total = self._fetch_ckpt(args.path, args.fetch)
                    except Exception as e:
                        print(f"❌ fetch failed: {e}")
                        return
                    print(f"✅ fetched {self._world} rank shards → "
                          f"{args.fetch} [{total / 1e6:.1f} MB over "
                          f"the bulk plane]")

    def dist_restore(self, line):
        """Load checkpointed variables back into every worker's
        namespace: ``%dist_restore ckpt/step100 [params ...]``.  A
        live tensor of the same shape and dtype is written in place."""
        if not self._require_cluster():
            return
        args = _parse("dist_restore", line)
        if args.ship:
            try:
                total = self._ship_ckpt(args.ship, args.path)
            except Exception as e:
                print(f"❌ ship failed: {e}")
                return
            print(f"📦 shipped {args.ship} → {self._world} ranks at "
                  f"{args.path} [{total / 1e6:.1f} MB over the bulk "
                  f"plane]")
        try:
            resps = self._comm.send_to_all(
                "checkpoint", {"action": "restore", "path": args.path,
                               "names": args.names or None}, timeout=600)
        except Exception as e:
            print(f"❌ restore failed: {e}")
            return
        if self._report_checkpoint(resps, f"restored ← {args.path}"):
            self._sync_ide_quietly()
        else:
            # Help the user see what the checkpoint actually holds
            # (single-host: the coordinator shares the filesystem).
            from ..runtime import checkpoint as ckpt_mod
            meta = ckpt_mod.info(args.path)
            if meta["ranks"]:
                for r, m in sorted(meta["ranks"].items()):
                    print(f"   rank {r} has: {', '.join(m['names'])} "
                          f"(saved from world of {m['world_size']})")
            else:
                print(f"   no checkpoint data found under {args.path!r}")

    # One rank's shard on disk (runtime/checkpoint.py layout): the
    # array payload, its manifest, and the pickled tree descriptions.
    _CKPT_FILES = ("manifest.json", "arrays.npz", "aux.pkl")

    def _fetch_ckpt(self, remote_path: str, local_dir: str) -> int:
        """Gather every rank's checkpoint shard to ``local_dir`` over
        the chunked bulk plane.  Returns total bytes moved."""
        from ..messaging import xfer
        total = 0
        for r in range(self._world):
            sub = f"rank_{r}"
            for fname in self._CKPT_FILES:
                src = os.path.join(remote_path, sub, fname)
                dst = os.path.join(local_dir, sub, fname)
                try:
                    stats = xfer.pull_file(self._comm, r, src, dst)
                except xfer.XferError as e:
                    if fname == "aux.pkl":
                        continue    # shard had no non-array state
                    raise RuntimeError(f"rank {r} {fname}: {e}")
                total += stats.get("bytes", 0)
        return total

    def _ship_ckpt(self, local_dir: str, remote_path: str) -> int:
        """Push a coordinator-local checkpoint (``rank_<r>/`` subdirs)
        to each rank's filesystem at ``remote_path``.  Returns total
        bytes moved."""
        from ..messaging import xfer
        total = 0
        for r in range(self._world):
            sub = f"rank_{r}"
            src_dir = os.path.join(local_dir, sub)
            if not os.path.isdir(src_dir):
                raise RuntimeError(
                    f"{src_dir} missing — need one rank_<r>/ shard "
                    f"per worker (write them with %dist_checkpoint "
                    f"--fetch)")
            for fname in self._CKPT_FILES:
                src = os.path.join(src_dir, fname)
                if not os.path.exists(src):
                    continue
                stats = xfer.push_file(
                    self._comm, [r], src,
                    os.path.join(remote_path, sub, fname))
                total += stats.get("bytes", 0)
        return total

    def _report_checkpoint(self, resps: dict, verb: str) -> bool:
        """Print per-rank checkpoint results; True if all ranks ok."""
        ok = True
        for rank in sorted(resps):
            data = resps[rank].data
            if data.get("error"):
                print(f"❌ rank {rank}: {data['error']}")
                ok = False
        if ok:
            summary = resps[min(resps)].data.get("summary", {})
            total = sum(s["bytes"] for s in summary.values())
            names = ", ".join(f"{n} ({s['leaves']} leaves)"
                              for n, s in sorted(summary.items()))
            print(f"✅ {len(resps)} ranks {verb}: {names} "
                  f"[{total / 1e6:.1f} MB/rank]")
        return ok

    # ==================================================================
    # fault injection, profiling, tracing, metrics, latency, telemetry

    def dist_chaos(self, line):
        """Deterministic fault injection on the live control plane:
        ``%dist_chaos on --drop 0.1 --seed 7`` / ``off`` / ``status``.
        The same knobs drive tests through the NBD_FAULT_PLAN env spec;
        pair with retries (NBD_RETRY_TIMEOUT_S) so a lost frame is
        redelivered instead of surfacing as a timeout."""
        from ..resilience.faults import FaultPlan
        args = _parse("dist_chaos", line)
        if not self._require_cluster():
            return
        if args.command == "off":
            self._comm.set_fault_plan(None)
            try:
                resps = self._comm.send_to_all(
                    "chaos", {"action": "clear"}, timeout=30)
                for r in sorted(resps):
                    c = resps[r].data.get("counters")
                    if c:
                        print(f"🔹 rank {r} injected: {c}")
            except Exception as e:
                print(f"⚠️ worker-side clear failed: {e}")
            print("✅ chaos off")
            return
        if args.command == "status":
            plan = self._comm.fault_plan()
            print(f"coordinator side: "
                  f"{plan.counters if plan else 'off'}")
            try:
                resps = self._comm.send_to_all(
                    "chaos", {"action": "status"}, timeout=30)
                for r in sorted(resps):
                    d = resps[r].data
                    print(f"🔹 rank {r}: {d.get('status')} "
                          f"counters={d.get('counters')} "
                          f"dedup_hits={d.get('dedup_hits')}")
            except Exception as e:
                print(f"⚠️ worker-side status failed: {e}")
            return
        # Reconfiguring while chaos is active: clear the coordinator
        # plan FIRST (like the 'off' path) so the arming broadcast
        # below doesn't have to fight the outgoing fault schedule it
        # replaces.
        self._comm.set_fault_plan(None)
        spec = {"seed": args.seed, "drop": args.drop,
                "delay_p": args.delay_p, "delay_s": args.delay_s,
                "duplicate": args.duplicate, "truncate": args.truncate,
                "freeze_heartbeat": args.freeze_heartbeats}

        def _host_pair(raw: str) -> list[str] | None:
            # Non-posix arg_split keeps quote chars inside the token.
            raw = raw.strip().strip("'\"")
            pair = [h.strip() for h in raw.split(",") if h.strip()]
            if len(pair) != 2:
                print(f"❌ host pair must be 'hostA,hostB', got {raw!r}")
                return None
            return pair

        links = []
        if args.partition:
            pair = _host_pair(args.partition)
            if pair is None:
                return
            if not args.partition_for and args.side != "coordinator":
                # An open-ended partition shipped to the WORKERS can
                # never be cleared: `%dist_chaos off` cannot traverse
                # the link the plan itself blackholes.
                print("❌ --partition-for 0 (until cleared) is "
                      "coordinator-side only — the 'off' that would "
                      "clear a worker-side plan can't cross the "
                      "partition. Use --side coordinator, or give a "
                      "finite --partition-for.")
                return
            links.append({"hosts": pair,
                          "after_s": args.partition_after,
                          "for_s": args.partition_for})
        if args.link_latency or args.link_loss:
            if not args.link_hosts:
                print("❌ --link-latency/--link-loss need --link-hosts "
                      "'hostA,hostB' to name the link")
                return
            pair = _host_pair(args.link_hosts)
            if pair is None:
                return
            links.append({"hosts": pair,
                          "latency_s": args.link_latency,
                          "loss": args.link_loss})
        if links:
            known = set((self._pm.hosts or {}).values()) | {"local", "*"}
            for lk in links:
                unknown = set(lk["hosts"]) - known
                if unknown:
                    print(f"⚠️ link hosts {sorted(unknown)} are not in "
                          f"this world's host map {sorted(known)} — "
                          "the spec will match nothing")
            spec["links"] = links
        corrupt = None
        if args.corrupt is not None:
            if args.corrupt_rank is None:
                print("❌ --corrupt needs --corrupt-rank to name the "
                      "rank whose params get damaged")
                return
            from ..resilience.faults import CorruptSpec
            try:
                # Build the real CorruptSpec (validation) and ship its
                # spec() — the same dict FaultPlan.from_spec rebuilds.
                corrupt = CorruptSpec(
                    rank=args.corrupt_rank, step=args.corrupt_step,
                    name=args.corrupt.strip().strip("'\""),
                    mode=args.corrupt_mode, bits=args.corrupt_bits,
                    scale=args.corrupt_scale,
                    count=args.corrupt_count).spec()
            except (TypeError, ValueError) as e:
                print(f"❌ bad --corrupt spec: {e}")
                return
            if args.side == "coordinator":
                print("⚠️ --corrupt ignored: corruption fires inside "
                      "the workers' guarded train loop, but --side "
                      "coordinator never ships them a plan")
                corrupt = None
        kill_armed = (args.kill_rank is not None
                      and args.side in ("worker", "both"))
        if args.kill_rank is not None and not kill_armed:
            print("⚠️ --kill-rank ignored: the kill arms on workers, "
                  "but --side coordinator never ships them a plan")
        if args.freeze_heartbeats and args.side == "coordinator":
            print("⚠️ --freeze-heartbeats ignored: only the worker "
                  "heartbeat loop consults it, but --side coordinator "
                  "never ships workers a plan")
        if args.side in ("worker", "both"):
            wspec = dict(spec)
            if kill_armed:
                wspec["kill_rank"] = args.kill_rank
                wspec["kill_at"] = args.kill_at or 1
            if corrupt is not None:
                wspec["corrupt"] = [corrupt]
            try:
                self._comm.send_to_all("chaos", {"action": "set",
                                                 "spec": wspec},
                                       timeout=30)
            except Exception as e:
                print(f"❌ arming worker-side chaos failed: {e}")
                return
        if args.side in ("coordinator", "both"):
            # Different stream than the workers' (offset seed) so the
            # two directions don't mirror each other's decisions.
            cspec = dict(spec)
            cspec["seed"] = args.seed + 1
            self._comm.set_fault_plan(FaultPlan.from_spec(cspec))
        warn = (" · ⚠ no retry policy on this manager — lost frames "
                "only surface as timeouts"
                if not self._comm.retry.enabled() else "")
        print(f"💥 chaos ON ({args.side}): {spec}"
              + (f" · kill rank {args.kill_rank} at msg "
                 f"{args.kill_at or 1}" if kill_armed else "")
              + (f" · corrupt rank {corrupt['rank']} step "
                 f"{corrupt['step']} {corrupt['mode']} "
                 f"{corrupt['name']!r}" if corrupt else "") + warn)

    def dist_profile(self, line):
        """``torch.profiler`` traces on every worker (CPU ops and, on
        a GPU rank, CUDA kernels): ``start``, run cells, ``stop``;
        each rank writes ``<log-dir>/rank<r>/trace.json``, a Chrome
        trace Perfetto opens."""
        if not self._require_cluster():
            return
        args = _parse("dist_profile", line)
        try:
            # One broadcast; each worker suffixes its own rank directory.
            self._comm.send_to_all(
                "profile", {"action": args.action,
                            "log_dir": args.log_dir}, timeout=60)
        except Exception as e:
            print(f"❌ profile {args.action} failed: {e}")
            return
        if args.action == "start":
            print(f"🔬 profiling started → {args.log_dir}/rank*/")
        else:
            print(f"🔬 profiling stopped; traces in {args.log_dir}/rank*/")

    def dist_trace(self, line):
        """Cross-rank span tracing: ``%dist_trace start`` records
        coordinator spans around every request and worker spans around
        handler dispatch / cell execution / checkpoints / eager
        collectives, all under ONE trace id propagated in the wire
        envelope; ``save`` merges coordinator + all ranks onto the
        coordinator's timebase (per-rank clock offsets estimated from
        request RTTs) into one Perfetto-loadable file, with any active
        fault plan's decisions folded in as instant events.  Off by
        default with near-zero overhead."""
        if not self._require_cluster():
            return
        args = _parse("dist_trace", line)
        comm = self._comm
        tr = comm.tracer
        if args.action == "start":
            import uuid
            tid = uuid.uuid4().hex[:16]
            try:
                # Workers first (adopting the shared trace id), so the
                # coordinator never stamps a request that lands on a
                # not-yet-tracing worker.
                comm.send_to_all("trace", {"action": "start",
                                           "trace_id": tid}, timeout=30)
            except Exception as e:
                print(f"❌ starting worker tracers failed: {e}")
                return
            tr.start(trace_id=tid)
            print(f"📡 tracing ON (trace {tid}) — run cells, then "
                  f"%dist_trace save <path>")
            return
        if args.action == "stop":
            n = tr.stop()
            try:
                resps = comm.send_to_all("trace", {"action": "stop"},
                                         timeout=30)
                per_rank = {r: resps[r].data.get("spans")
                            for r in sorted(resps)}
            except Exception as e:
                per_rank = f"<worker stop failed: {e}>"
            print(f"📡 tracing OFF — buffered spans: coordinator {n}, "
                  f"workers {per_rank} (%dist_trace save still works)")
            return
        if args.action == "status":
            state = "ON" if tr.enabled else "off"
            print(f"coordinator: tracing {state}, {len(tr)} spans "
                  f"buffered"
                  + (f", trace {tr.trace_id}" if tr.trace_id else ""))
            try:
                resps = comm.send_to_all("trace", {"action": "status"},
                                         timeout=30)
                for r in sorted(resps):
                    d = resps[r].data
                    print(f"🔹 rank {r}: {d.get('status')} "
                          f"({d.get('spans', 0)} spans)")
            except Exception as e:
                print(f"⚠️ worker-side status failed: {e}")
            return
        # save: collect per-rank dumps + fault events, merge on the
        # coordinator's timebase, write one Chrome-trace JSON.
        from ..observability import export as obs_export
        try:
            resps = comm.send_to_all("trace", {"action": "dump"},
                                     timeout=120)
        except Exception as e:
            print(f"❌ collecting worker traces failed: {e}")
            return
        rank_dumps = {r: m.data.get("trace") or {}
                      for r, m in resps.items()}
        rank_faults = {r: m.data.get("fault_events") or []
                       for r, m in resps.items()}
        plan = comm.fault_plan()
        cdump = tr.dump()
        offsets = comm.clock.offsets()
        merged = obs_export.merge_trace(
            cdump, rank_dumps, offsets,
            coordinator_faults=plan.events() if plan is not None else [],
            rank_faults=rank_faults)
        try:
            n = obs_export.save_trace(args.path, merged)
        except OSError as e:
            print(f"❌ could not write {args.path}: {e}")
            return
        n_spans = {r: len(d.get("spans", [])) for r, d in
                   sorted(rank_dumps.items())}
        offs = {r: round(o * 1e3, 3) for r, o in sorted(offsets.items())}
        print(f"✅ {n} events → {args.path} (coordinator "
              f"{len(cdump['spans'])} spans, ranks {n_spans}, "
              f"clock offsets {offs} ms) — load in ui.perfetto.dev")

    def dist_metrics(self, line):
        """One coherent view of the session's metrics: wire messages /
        bytes, retries, dedup hits, cell and collective durations,
        fault injections — from the coordinator's registry and every
        rank's, with resilience counters mirrored in at snapshot
        time."""
        if not self._require_cluster():
            return
        args = _parse("dist_metrics", line)
        comm = self._comm
        from ..observability import flightrec as _flightrec
        from ..observability import latency as _lat_mod
        from ..observability import metrics as obs_metrics
        reg = obs_metrics.registry()
        # Mirror coordinator-side resilience state into the registry so
        # the export is self-contained — including the flight ring's
        # health and the clock estimator's per-rank offsets.
        _flightrec.export_health(reg)
        _lat_mod.export_clock_metrics(comm.clock, reg)
        now = time.time()
        for r in comm.connected_ranks():
            seen = comm.last_seen(r)
            if seen is not None:
                reg.gauge("nbd_heartbeat_staleness_seconds",
                          "seconds since this rank was last heard",
                          {"rank": str(r)}).set(round(now - seen, 3))
        plan = comm.fault_plan()
        if plan is not None:
            for action, c in plan.counters.items():
                reg.gauge("nbd_fault_injections",
                          "fault-plan decisions by action",
                          {"action": action}).set(c)
        try:
            resps = comm.send_to_all(
                "metrics",
                {"format": "prometheus" if args.prom else "json"},
                timeout=30)
        except Exception as e:
            print(f"❌ metrics fetch failed: {e}")
            return
        if args.prom:
            print("── coordinator ──")
            print(reg.prometheus_text(), end="")
            for r in sorted(resps):
                print(f"── rank {r} ──")
                print(resps[r].data.get("text", ""), end="")
            return
        coord = reg.to_json()
        rank_json = {r: resps[r].data.get("metrics", {})
                     for r in sorted(resps)}
        if args.save:
            import json
            with open(args.save, "w") as f:
                json.dump({"coordinator": coord,
                           "ranks": {str(r): v
                                     for r, v in rank_json.items()}}, f,
                          indent=1)
            print(f"✅ full snapshot → {args.save}")

        def _total(snap: dict, name: str) -> float:
            """Sum every series of ``name`` across counters+gauges."""
            tot = 0.0
            for sect in ("counters", "gauges"):
                for k, v in snap.get(sect, {}).items():
                    if k == name or k.startswith(name + "{"):
                        tot += v
            return tot

        def _hist(snap: dict, name: str) -> tuple[int, float]:
            count, total = 0, 0.0
            for k, v in snap.get("histograms", {}).items():
                if k == name or k.startswith(name + "{"):
                    count += v.get("count", 0)
                    total += v.get("sum", 0.0)
            return count, total

        print(f"📊 coordinator: wire tx/rx "
              f"{_total(coord, 'nbd_wire_messages_total'):.0f} msgs · "
              f"{_total(coord, 'nbd_wire_bytes_total') / 1e6:.2f} MB · "
              f"retries {_total(coord, 'nbd_retries_total'):.0f}")
        for r in sorted(rank_json):
            snap = rank_json[r]
            cells, cell_s = _hist(snap, "nbd_cell_seconds")
            colls, coll_s = _hist(snap, "nbd_collective_seconds")
            print(f"🔹 rank {r}: cells {cells} ({cell_s:.2f}s) · "
                  f"collectives {colls} ({coll_s:.2f}s) · dedup "
                  f"{_total(snap, 'nbd_dedup_hits'):.0f} · wire "
                  f"{_total(snap, 'nbd_wire_messages_total'):.0f} msgs "
                  f"{_total(snap, 'nbd_wire_bytes_total') / 1e6:.2f} MB"
                  + (f" · faults "
                     f"{_total(snap, 'nbd_fault_injections'):.0f}"
                     if _total(snap, "nbd_fault_injections") else "")
                  + (f" · parked "
                     f"{_total(snap, 'nbd_mailbox_parked'):.0f}"
                     if _total(snap, "nbd_mailbox_parked") else "")
                  + (f" · orphan transitions "
                     f"{_total(snap, 'nbd_orphan_transitions'):.0f}"
                     if _total(snap, "nbd_orphan_transitions") else ""))

    def dist_lat(self, line):
        """The latency observatory: WHERE each cell's wall-clock went,
        as eight contiguous stages (vet → queue → wire → dispatch →
        compile → execute → reply → deliver) stamped by the
        coordinator and workers and clock-corrected onto one
        timebase.  Default: per-stage p50/p95/p99 table over the
        recent-cells ring (``NBD_LAT_RING``); ``--last N`` adds an
        ASCII waterfall per cell.  In tenant mode the observatory
        lives in the gateway daemon — this reads its pool-status
        latency block.  ``NBD_LAT=0`` disables stamping entirely."""
        args = _parse("dist_lat", line)
        from ..observability import latency as lat_mod
        if DistributedMagics._tenant is not None:
            client = DistributedMagics._tenant
            try:
                st = client.pool_status()
            except Exception as e:
                print(f"❌ pool status failed: {e}")
                return
            block = st.get("latency") or {}
            n_recs = len(block.get("records") or ())
            if args.last > n_recs or (args.save and n_recs
                                      < lat_mod.DEFAULT_RING):
                # The gateway ships a bounded tail of its ring in the
                # status payload — say so instead of silently
                # rendering/saving fewer records than asked for.
                print(f"ℹ️ tenant mode: the gateway's status payload "
                      f"carries its last {n_recs} record(s); the full "
                      f"ring is on the daemon's /latency.json "
                      f"(%dist_pool start --metrics-port)")
        elif self._comm is not None:
            block = self._comm.lat.status_block(
                records=max(args.last, 32))
        else:
            print("❌ No cluster. %dist_init (or %dist_attach "
                  "--tenant) first.")
            return
        print(lat_mod.format_stage_table(block.get("summary") or {}))
        if args.last:
            recs = (block.get("records") or [])[-args.last:]
            print(lat_mod.format_waterfall(recs))
        if args.save:
            import json
            with open(args.save, "w") as f:
                json.dump(block, f, indent=1)
            print(f"✅ latency snapshot → {args.save}")

    @staticmethod
    def _fmt_gb(n) -> str:
        return "-" if n is None else f"{n / 1e9:.2f}"

    def dist_top(self, line):
        """Live per-rank dashboard from the PUSH path: process state,
        busy cell, heartbeat age, device memory in-use/limit/peak
        (the CUDA caching allocator's), dedup hits — all read from
        heartbeat piggybacks and the process table, so it renders
        instantly even while every worker is busy mid-cell (a
        ``get_status`` probe would stall behind the serial request
        loop).  In tenant mode the pool view is the dashboard."""
        if DistributedMagics._tenant is not None:
            return self.dist_status(line)
        if self._pm is None or self._comm is None:
            print("❌ No cluster. %dist_init to start one.")
            return
        from ..observability.telemetry import hbm_totals
        from ..runtime.worker import HEARTBEAT_INTERVAL_S
        comm, pm = self._comm, self._pm
        sup_states = {}
        if DistributedMagics._supervisor is not None:
            sup_states = DistributedMagics._supervisor.status()["states"]
        proc = pm.get_status()
        now = time.time()
        print(f"⏱  cluster top · {self._world} workers · backend="
              f"{pm.backend} · {time.strftime('%H:%M:%S')}")
        # Serving KV column only when some rank reports a decode
        # server — idle clusters keep the pre-serving layout.
        kv_seen = any((comm.last_ping(r) or (0, {}))[1].get("srv")
                      for r in range(self._world))
        # Guard column only when some rank's ping carries a
        # TrainGuard snapshot — guard-free sessions keep their layout.
        guard_seen = any((comm.last_ping(r) or (0, {}))[1].get("tg")
                         for r in range(self._world))
        hdr = (f"{'rank':<5}{'state':<11}{'busy':<18}"
               f"{'hb-age':<8}"
               f"{'col#':<7}{'HBM use/limit GB':<18}{'peak':<7}"
               + (f"{'kv':<12}{'frag':<6}" if kv_seen else "")
               + (f"{'guard':<16}" if guard_seen else "")
               + f"{'bufs':<6}{'compiles':<9}{'dedup':<6}")
        print(hdr)
        print("─" * len(hdr))
        for r in range(self._world):
            p = proc.get(r) or {}
            ping = comm.last_ping(r)
            tel = comm.last_telemetry(r) or {}
            if not p.get("running", False):
                state = f"✖ dead({p.get('returncode')})"
            elif sup_states.get(r) in ("degraded", "healing"):
                state = "◐ " + sup_states[r]
            elif (ping is not None
                    and now - ping[0] > 3 * HEARTBEAT_INTERVAL_S):
                state = "◐ stale"
            else:
                state = "● alive"
            busy = "-"
            if ping is not None and ping[1].get("busy_s") is not None:
                busy = (f"{ping[1].get('busy_type')} "
                        f"{ping[1]['busy_s'] + (now - ping[0]):.1f}s")
                rep = ping[1].get("rep")
                if rep:
                    # Step-loop progress: one dispatch, k steps — the
                    # per-step view without a probe.
                    busy = (f"step {rep.get('i')}/{rep.get('k')} "
                            f"{rep.get('sps', 0)}/s")
                    if rep.get("last") is not None:
                        busy += f" {rep['last']:g}"
            hb = f"{now - ping[0]:.1f}s" if ping is not None else "-"
            # Collective-stream position (heartbeat piggyback): "#7*"
            # = entered collective 7 and still inside it — the
            # cross-rank skew on this column IS the hang signature.
            col = "-"
            if ping is not None and ping[1].get("col"):
                c = ping[1]["col"]
                col = (f"#{c.get('seq')}"
                       + ("*" if c.get("in") else ""))
            hbm = hbm_totals(tel) or {}
            mem = (f"{self._fmt_gb(hbm.get('in_use'))}"
                   f"/{self._fmt_gb(hbm.get('limit'))}"
                   if hbm.get("in_use") is not None else "-")
            peak = self._fmt_gb(hbm.get("peak"))
            kvcol = ""
            if kv_seen:
                srv = (ping[1].get("srv") or {}) if ping else {}
                kvb = srv.get("kvb") or ()
                if len(kvb) == 2:
                    kvcol = f"{f'{kvb[0]}/{kvb[1]}blk':<12}"
                elif srv:
                    kvcol = (f"{srv.get('occ', 0)}"
                             f"/{srv.get('slots', 0)}")
                    kvcol = f"{kvcol:<12}"
                else:
                    kvcol = f"{'-':<12}"
                # Fragmentation: the rank's largest contiguous
                # free-block run.
                frag = srv.get("frag")
                kvcol += (f"{frag:<6}" if frag is not None
                          else f"{'-':<6}")
            gcol = ""
            if guard_seen:
                tg = (ping[1].get("tg") or {}) if ping else {}
                if tg:
                    # skips · last audit verdict (· rollbacks / 🔶
                    # quarantine suspects when present).
                    g = f"s{tg.get('sk', 0)} {tg.get('v', '?')}"
                    if tg.get("rb"):
                        g += f" rb{tg['rb']}"
                    if tg.get("qr"):
                        g += f" 🔶{tg['qr']}"
                    gcol = f"{g:<16}"
                else:
                    gcol = f"{'-':<16}"
            print(f"{r:<5}{state:<11}{busy:<18}{hb:<8}{col:<7}"
                  f"{mem:<18}"
                  f"{peak:<7}{kvcol}{gcol}{str(tel.get('bufs', '-')):<6}"
                  f"{str(tel.get('compiles', '-')):<9}"
                  f"{str(tel.get('dedup', '-')):<6}")
        print(f"coordinator: retries sent {comm.retries_sent} · "
              f"run dir {_knobs.get_str('NBD_RUN_DIR', '(unset)')}")

    # ==================================================================
    # crash postmortems

    def dist_postmortem(self, line):
        """Crash postmortems from the always-on flight recorder.

        Default: capture a fresh bundle NOW — recover every process's
        flight ring (including rings left by dead/SIGKILLed workers),
        attach the last heartbeat telemetry per rank, coordinator
        spans, and fault-plan decisions, merge everything into one
        clock-aligned Chrome trace, and print the report.  ``--last``
        re-prints the newest existing bundle (e.g. the one the
        supervisor captured before auto-healing); ``--save DIR``
        captures into a directory of your choosing."""
        args = _parse("dist_postmortem", line)
        from ..observability import postmortem as pm_mod
        if args.last:
            sup = DistributedMagics._supervisor
            bundle = None
            if sup is not None and sup.last_postmortem is not None:
                bundle = sup.last_postmortem["dir"]
            else:
                bundles = pm_mod.list_bundles()
                bundle = bundles[-1] if bundles else None
            if bundle is None:
                print("❌ no postmortem bundle captured yet in this "
                      "run (%dist_postmortem captures one on demand)")
                return
            try:
                with open(os.path.join(bundle, "report.txt")) as f:
                    print(f.read())
            except OSError as e:
                print(f"❌ could not read {bundle}: {e}")
            return
        if self._comm is None:
            print("❌ no coordinator in this session — use "
                  "%dist_postmortem --last to view an existing bundle")
            return
        dead = []
        if self._pm is not None:
            alive = set(self._pm.alive_ranks())
            dead = sorted(set(range(self._world)) - alive)
        # A capture taken mid-hang keeps the doctor's diagnosis next
        # to the black boxes (read-only: no stack-dump signal here —
        # the bundle must not perturb what it records).
        hang = None
        wd = DistributedMagics._watchdog
        if wd is not None and (wd.last_verdicts or wd.status()["active"]):
            from ..resilience.watchdog import hang_report
            try:
                hang = hang_report(self._comm, self._pm, wd,
                                   dump_stacks=False)
            except Exception:
                hang = None
        manifest = pm_mod.capture(self._comm, dead, out_dir=args.save,
                                  reason="on demand (%dist_postmortem)",
                                  hang_report=hang)
        if manifest is None:
            print("❌ postmortem capture failed (is the run directory "
                  "writable?)")
            return
        try:
            with open(os.path.join(manifest["dir"], "report.txt")) as f:
                print(f.read())
        except OSError:
            pass
        print(f"✅ bundle → {manifest['dir']} (trace.json loads in "
              f"ui.perfetto.dev)")

    # ==================================================================
    # durable sessions: reattach + stale-run GC

    def dist_attach(self, line):
        """Reattach this kernel to a fleet that survived its
        coordinator's death (durable sessions), or — with
        ``--tenant NAME`` — attach to a shared gateway pool as one
        tenant of many.

        The single-kernel path reads the session manifest under the
        run dir, adopts the worker pids, re-binds the control
        endpoint, bumps the session epoch (fencing out any stale
        coordinator), verifies the session token with a per-rank
        hello, and drains results the workers parked while orphaned —
        the interrupted cell's output is redelivered exactly once, and
        every worker's namespace and CUDA tensors are exactly as the
        crash left them.  The tenant path does the same dance against
        the gateway: a reattach under the same name proves the tenant
        token, bumps the TENANT epoch (fencing the crashed kernel's
        old connection), and drains the tenant's own parked-result
        partition exactly once."""
        from ..resilience import session as session_mod
        args = _parse("dist_attach", line)
        if self._running() or DistributedMagics._tenant is not None:
            what = ("tenant " + DistributedMagics._tenant.name
                    if DistributedMagics._tenant is not None
                    else f"{self._world} workers")
            print(f"⚠️ already attached ({what}). "
                  "%dist_shutdown first.")
            return
        t0 = time.time()
        run_dir = (args.run_dir or "").strip().strip("'\"") or None
        if args.tenant:
            return self._attach_tenant(
                run_dir, args.tenant.strip().strip("'\""),
                priority=args.priority, timeout=args.timeout)
        try:
            comm, pm, manifest, hello = session_mod.attach(
                run_dir, attach_timeout=args.attach_timeout,
                request_timeout=args.timeout)
        except Exception as e:
            print(f"❌ attach failed: {e}")
            return
        pm.add_death_callback(self._announce_death)
        comm.set_output_callback(self._feed_stream)
        comm.set_host_map(pm.hosts)
        DistributedMagics._comm = comm
        DistributedMagics._pm = pm
        DistributedMagics._world = comm.num_workers
        DistributedMagics._attached = True
        if manifest.get("init_line") is not None:
            # %dist_heal replays the ORIGINAL init of this session.
            DistributedMagics._last_init_line = manifest["init_line"]
        self._enable_auto_mode()
        sizes = sorted({(m.data or {}).get("namespace_size") or 0
                        for m in hello.values()})
        print(f"🔗 reattached to {comm.num_workers} workers "
              f"(epoch {comm.session_epoch}, "
              f"run {_knobs.get_str('NBD_RUN_DIR')}, "
              f"{time.time() - t0:.1f}s) — namespaces intact "
              f"({'/'.join(str(s) for s in sizes)} names/rank)")
        # Exactly-once redelivery of results parked while orphaned.
        if any((m.data or {}).get("parked") for m in hello.values()):
            try:
                drained = session_mod.drain_mailboxes(comm)
            except Exception as e:
                print(f"⚠️ mailbox drain failed: {e} — parked results "
                      "remain claimable on the workers")
                drained = {}
            for r in sorted(drained):
                for mid, res in drained[r].items():
                    self._render_late_result(
                        r, res, "finished while orphaned", mid=mid)
        if manifest.get("supervised") \
                and DistributedMagics._supervisor is None:
            print("🛡  re-arming supervision (the session had "
                  "%dist_supervise on)")
            self.dist_supervise("on")
        self._maybe_start_watchdog()
        print("Every cell runs on ALL workers again. %dist_status "
              "shows the session header.")

    @staticmethod
    def _render_late_result(rank, res, suffix: str, *, mid: str = "",
                            prefix: str = "") -> None:
        """One 📬 line for a cell result that outlived its waiter —
        drained from a mailbox (orphaned/detached) or delivered late
        after an interrupt.  The single render path for all three."""
        res = res or {}
        text = (res.get("error")
                or str(res.get("output") or "").strip()
                or "(no output)")
        tag = f" {mid[:8]}…" if mid else ""
        print(f"{prefix}📬 rank {rank} · interrupted cell{tag} "
              f"{suffix}: {text}")

    def _render_drained_reply(self, mid, res, suffix: str, *,
                              prefix: str = "") -> None:
        """Render one claimed/late reply: per-rank lines when it
        carries results, else its gateway-level verdict.  The crash
        verdicts (worker death, request timeout, shed) have no
        ``results`` key, and the claim that surfaced them was
        destructive — the verdict renders here or nowhere."""
        res = res or {}
        results = res.get("results") or {}
        if not results:
            text = (res.get("error")
                    or f"status={res.get('status') or '?'} "
                       "(no output)")
            tag = f" {mid[:8]}…" if mid else ""
            print(f"{prefix}📬 interrupted cell{tag} {suffix}: {text}")
            return
        first = True
        for r in sorted(results, key=int):
            self._render_late_result(r, results[r], suffix, mid=mid,
                                     prefix=prefix if first else "")
            first = False

    def dist_gc(self, line):
        """Sweep abandoned session run dirs: siblings whose manifest
        (or directory) is older than the TTL and whose recorded pids
        are all dead.  The current session's run dir, any dir with a
        live pid, and any dir a live gateway daemon owns are never
        touched."""
        from ..resilience import session as session_mod
        args = _parse("dist_gc", line)
        root = (args.root or "").strip().strip("'\"") or None
        res = session_mod.gc_runs(root, ttl_s=args.ttl,
                                  dry_run=args.dry_run)
        verb = "would sweep" if args.dry_run else "swept"
        print(f"🧹 {verb} {len(res['swept'])} stale run dir(s) under "
              f"{res['root']} (ttl {res['ttl_s']:.0f}s) · "
              f"kept {len(res['kept'])}")
        for d in res["swept"]:
            print(f"   - {d}")
        if args.dry_run:
            # Say WHY each survivor was skipped — "my pool's run dir
            # vanished" and "why is this old dir still here" get the
            # same one-line answer.
            for d in res["kept"]:
                why = res.get("kept_why", {}).get(d)
                print(f"   = kept {d}" + (f" — {why}" if why else ""))
        for e in res["errors"]:
            print(f"   ⚠ {e}")

    # ==================================================================
    # session gateway: tenant attach + %dist_pool

    @classmethod
    def _drop_tenant_state(cls, *, detach: bool = False) -> str | None:
        """The one tenant-teardown path (reset, %dist_shutdown,
        %dist_pool stop): close the client, clear the pool
        bookkeeping.  Returns the tenant name, or None when this
        kernel was not attached."""
        t = cls._tenant
        if t is None:
            return None
        try:
            t.close(detach=detach)
        except Exception:
            pass
        cls._tenant = None
        cls._pool_info = None
        cls._world = 0
        cls._attached = False
        return t.name

    def _attach_tenant(self, run_dir, name, *, priority=None,
                       timeout=None):
        from ..gateway import daemon as gw_mod
        from ..gateway.client import TenantClient
        d = gw_mod.discover_gateway(run_dir)
        if d is None:
            print("❌ no gateway pool found"
                  + (f" in {run_dir}" if run_dir else
                     " (start one: %dist_pool start -n 4, or pass "
                     "its run dir)"))
            return
        manifest = gw_mod.read_gateway_manifest(d)
        if manifest is None or not gw_mod.gateway_alive(manifest):
            print(f"❌ {d} has no live gateway daemon "
                  "(%dist_pool status / %dist_gc --dry-run to "
                  "inspect)")
            return
        plane = manifest.get("tenant_plane") or {}
        # A prior session under this name: its token (recorded in the
        # gateway manifest, same-filesystem trust like session.json)
        # proves we RESUME it — the gateway bumps the tenant epoch and
        # fences the crashed kernel's old connection.
        token = ((manifest.get("tenants") or {}).get(name)
                 or {}).get("token")
        t0 = time.time()
        try:
            client = TenantClient(
                plane.get("host") or "127.0.0.1",
                int(plane.get("port") or 0), name, token=token,
                pool_token=manifest.get("pool_token"),
                priority=priority, on_stream=self._feed_stream,
                hello_timeout=float(timeout) if timeout else 30.0)
        except Exception as e:
            print(f"❌ tenant attach failed: {e}")
            return

        def _on_parked(_d: dict) -> None:
            # A cell that was in flight ACROSS the reattach just
            # finished and parked — the hello's parked list predates
            # it, so this nudge is the only signal it exists.  Drain
            # off the reader thread: drain() waits on a reply the
            # reader itself delivers.
            def _drain_bg():
                try:
                    drained = client.drain()
                except Exception:
                    return   # stays claimable on the next attach
                first = True
                for mid, res in sorted(drained.items()):
                    self._render_drained_reply(
                        mid, res, "finished while reattaching",
                        prefix="\n" if first else "")
                    first = False
            threading.Thread(target=_drain_bg, daemon=True,
                             name="nbd-parked-drain").start()

        client.on_parked = _on_parked
        DistributedMagics._tenant = client
        DistributedMagics._pool_info = {"run_dir": d, **manifest}
        DistributedMagics._world = client.world_size
        DistributedMagics._attached = True
        verb = ("🔗 reattached" if client.attach_status == "reattached"
                else "🤝 attached")
        pol = client.policy or {}
        print(f"{verb} to pool {d} as tenant {name!r} "
              f"(epoch {client.epoch}, {client.world_size} ranks, "
              f"sched {pol.get('mode', '?')}, "
              f"{time.time() - t0:.1f}s)")
        if client.parked:
            # Exactly-once redelivery of results that finished while
            # this tenant had no kernel.
            def _late_drain(claimed: dict) -> None:
                # The drain reply outlived its waiter (timeout or
                # Ctrl-C mid-attach).  The gateway's claim was already
                # destructive, so render from the reader thread — the
                # alternative is losing the results on both sides.
                first = True
                for mid, res in sorted(claimed.items()):
                    self._render_drained_reply(
                        mid, res, "finished while detached",
                        prefix="\n" if first else "")
                    first = False
            try:
                drained = client.drain(on_late=_late_drain)
            except Exception as e:
                print(f"⚠️ mailbox drain failed: {e} — parked results "
                      "remain claimable on the gateway")
                drained = {}
            for mid, res in sorted(drained.items()):
                self._render_drained_reply(mid, res,
                                           "finished while detached")
        print("Cells (%%distributed) now run on the POOL under this "
              "tenant's isolated namespace; `shared` is the opt-in "
              "cross-tenant dict. %dist_pool status shows the queue.")

    def _pool_endpoint(self, run_dir=None):
        """(manifest, run_dir) of the pool to administer: the attached
        one first, else discovery."""
        from ..gateway import daemon as gw_mod
        if run_dir is None and DistributedMagics._pool_info is not None:
            d = DistributedMagics._pool_info.get("run_dir")
            m = gw_mod.read_gateway_manifest(d)
            # No silent fallback to discovery here: a bare
            # `%dist_pool stop` targets THE ATTACHED pool, and if its
            # manifest is gone, discovering the newest other live pool
            # would aim the shutdown at a pool the user never meant
            # (possibly someone else's).  Name the problem instead.
            if m is None:
                print(f"⚠️ attached pool {d} has no readable manifest "
                      "(daemon exited?) — pass --run-dir explicitly "
                      "to administer a different pool")
            return m, d
        d = gw_mod.discover_gateway(run_dir)
        if d is None:
            return None, None
        return gw_mod.read_gateway_manifest(d), d

    def dist_pool(self, line):
        """Gateway pool admin: ``%dist_pool start -n 4`` spawns a
        gateway daemon owning a pooled fleet of GPU ranks that N
        notebook kernels share (``%dist_attach --tenant NAME``);
        ``status`` shows the scheduler queue, per-tenant counters, and
        tenant-attributed per-rank busy state; ``stop`` shuts the
        daemon and its workers down.  Elastic pools: ``resize -n N``
        changes the world size via a drain-barrier epoch bump,
        ``start --autoscale MIN:MAX`` arms the pressure-driven
        autoscaler, and ``template --file CELL.py`` registers a
        warm-start cell re-run on every resized fleet.  A ``gpu`` pool
        holds at most one rank a card: a start or a resize past the
        host's GPUs is refused.  ``migrate --tenant T [--to RUN_DIR]``
        moves a tenant, its parked results and its serving journal to
        another pool.  Scheduling/admission
        defaults come from the ``NBD_POOL_*``/``NBD_TENANT_*``
        knobs."""
        import subprocess
        import sys as _sys

        from ..gateway import daemon as gw_mod
        args = _parse("dist_pool", line)
        if args.command == "start":
            # "auto" is the GPU and raises on a host without one, as
            # %dist_init --backend auto does: never the CPU unasked.
            from ..manager import topology as _topo
            backend = (_topo.detect_backend() if args.backend == "auto"
                       else args.backend)
            refusal = gw_mod.gpu_refusal(backend, args.workers)
            if refusal:
                print(f"❌ {refusal}")
                return
            run_dir = (args.run_dir or "").strip().strip("'\"")
            if not run_dir:
                from ..resilience import session as session_mod
                root = session_mod.default_runs_root()
                os.makedirs(root, exist_ok=True)
                run_dir = tempfile.mkdtemp(prefix="pool-", dir=root)
            os.makedirs(run_dir, exist_ok=True)
            cmd = [_sys.executable, "-m",
                   "nbdistributed_tpu_torch.gateway.daemon",
                   "-n", str(args.workers), "--backend", backend,
                   "--run-dir", run_dir]
            for flag, v in (("--max-tenants", args.max_tenants),
                            ("--sched", args.sched),
                            ("--mesh-slots", args.mesh_slots),
                            ("--queue-depth", args.queue_depth),
                            ("--tenant-inflight",
                             args.tenant_inflight),
                            ("--metrics-port", args.metrics_port),
                            ("--autoscale", args.autoscale)):
                if v is not None:
                    cmd += [flag, str(v)]
            if args.effects:
                cmd += ["--effects"]
            env = dict(os.environ)
            env.pop("NBD_RUN_DIR", None)  # the daemon owns its own
            # The daemon imports this package: its checkout goes first
            # on the daemon's path, whatever this kernel's cwd is.
            root = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
            env["PYTHONPATH"] = os.pathsep.join(
                [root] + [p for p in env.get("PYTHONPATH", "")
                          .split(os.pathsep) if p])
            print(f"🚀 starting gateway pool ({args.workers} workers, "
                  f"backend={backend}) → {run_dir}")
            # Daemon output goes to a log FILE, not a pipe: the
            # daemon outlives this kernel by design and nobody would
            # drain a pipe — one chatty dependency later the ~64 KiB
            # buffer fills and every daemon write (and the pool with
            # it) wedges.
            log_path = os.path.join(run_dir, "gateway.log")
            with open(log_path, "ab") as logf:
                proc = subprocess.Popen(cmd, env=env, stdout=logf,
                                        stderr=subprocess.STDOUT,
                                        start_new_session=True)
            deadline = time.time() + args.start_timeout
            m = None
            while time.time() < deadline:
                if proc.poll() is not None:
                    try:
                        with open(log_path, "rb") as f:
                            out = f.read().decode("utf-8", "replace")
                    except OSError:
                        out = ""
                    print(f"❌ gateway daemon exited "
                          f"({proc.returncode}):\n{out[-2000:]}")
                    return
                m = gw_mod.read_gateway_manifest(run_dir)
                if gw_mod.gateway_alive(m):
                    break
                time.sleep(0.3)
            if not gw_mod.gateway_alive(m):
                # SIGTERM, not SIGKILL: the daemon installs its
                # handlers before spawning, so a graceful stop reaps
                # the half-started fleet — SIGKILL orphaned those
                # workers (and the GPUs they held) until the orphan
                # TTL expired.
                proc.terminate()
                try:
                    proc.wait(timeout=15)
                except Exception:
                    proc.kill()
                print("❌ gateway daemon never became ready "
                      f"(waited {args.start_timeout:.0f}s)")
                return
            plane = m.get("tenant_plane") or {}
            print(f"✅ pool up: pid {m.get('pid')} · tenant plane "
                  f"{plane.get('host')}:{plane.get('port')} · "
                  f"policy {m.get('policy')} · run dir {run_dir}")
            met = m.get("metrics") or {}
            if met:
                print(f"📈 scrape endpoint: http://{met.get('host')}:"
                      f"{met.get('port')}/metrics?token=<pool token> "
                      f"(/healthz, /latency.json)")
            print(f"   attach kernels with: %dist_attach --tenant "
                  f"NAME {run_dir}")
            return
        manifest, d = self._pool_endpoint(
            (args.run_dir or "").strip().strip("'\"") or None)
        if manifest is None:
            print("❌ no gateway pool found (start one: %dist_pool "
                  "start -n 4)")
            return
        plane = manifest.get("tenant_plane") or {}
        host = plane.get("host") or "127.0.0.1"
        port = int(plane.get("port") or 0)
        if args.command == "stop":
            from ..gateway.client import pool_shutdown
            try:
                res = pool_shutdown(host, port,
                                    manifest.get("pool_token"))
            except Exception as e:
                print(f"❌ pool stop failed: {e}")
                return
            attached_dir = (DistributedMagics._pool_info or {}).get(
                "run_dir")
            # Only tear down this kernel's attachment when the pool
            # we just stopped IS the attached one (stop --run-dir X
            # must not drop a live attachment to pool Y).
            if (DistributedMagics._tenant is not None
                    and attached_dir == d):
                DistributedMagics._drop_tenant_state()
            print(f"🛑 pool {d}: {res.get('status', res)}")
            return
        if args.command == "resize":
            from ..gateway.client import pool_resize
            print(f"🔧 resizing pool {d} → {args.workers} workers "
                  f"(drain barrier + epoch bump — in-flight cells "
                  f"finish first)...")
            try:
                res = pool_resize(host, port, manifest.get("pool_token"),
                                  args.workers)
            except Exception as e:
                print(f"❌ pool resize failed: {e}")
                return
            if res.get("status") == "resized":
                print(f"✅ resized: {res.get('world_size')} ranks · "
                      f"epoch {res.get('epoch')} · generation "
                      f"{res.get('generation')} · drain "
                      f"{res.get('drain_s')}s"
                      + ("" if res.get("drained") else
                         " (drain TIMED OUT — in-flight cells were "
                         "aborted with explicit verdicts)")
                      + f" · total {res.get('wall_s')}s")
                if (DistributedMagics._tenant is not None
                        and (DistributedMagics._pool_info or {})
                        .get("run_dir") == d):
                    # This kernel's cells now span the new world.
                    DistributedMagics._world = int(res["world_size"])
            elif res.get("status") == "noop":
                print(f"ℹ pool is already {res.get('world_size')} "
                      f"ranks")
            else:
                print(f"❌ {res.get('error') or res}")
            return
        if args.command == "migrate":
            if not args.tenant:
                print("❌ migrate needs --tenant NAME")
                return
            from ..gateway.router import (MigrationError,
                                          PoolDirectory,
                                          migrate_tenant)
            dest = args.dest
            if not dest:
                placed = PoolDirectory().place(exclude=d)
                if placed is None:
                    print("❌ no OTHER live pool to migrate to "
                          "(start one, or name it with --to)")
                    return
                dest = placed[0]
            print(f"🚚 migrating tenant {args.tenant!r}: {d} → "
                  f"{dest} ...")
            try:
                res = migrate_tenant(args.tenant, d, dest,
                                     force=args.force)
            except MigrationError as e:
                print(f"❌ migration refused: {e}")
                return
            except Exception as e:
                print(f"❌ migration failed: {type(e).__name__}: {e}")
                return
            print(f"✅ migrated to {dest} (epoch "
                  f"{res.get('epoch')}) · parked results moved: "
                  f"{res.get('parked_moved')} · serve journal: "
                  f"{'yes' if res.get('journal_moved') else 'no'}"
                  + ("" if res.get("src_alive") else
                     " · source pool was DEAD — recovered from its "
                     "manifest + journal")
                  + ("" if res.get("released") else
                     " · ⚠ source copy NOT released (re-run the "
                     "migration once the source answers)"))
            print(f"   reattach kernels with: %dist_attach --tenant "
                  f"{args.tenant} {dest}")
            return
        if args.command == "template":
            from ..gateway.client import pool_template
            code = None
            if args.tpl_file:
                path = args.tpl_file.strip().strip("'\"")
                try:
                    with open(path) as f:
                        code = f.read()
                except OSError as e:
                    print(f"❌ cannot read {path}: {e}")
                    return
            try:
                res = pool_template(host, port,
                                    manifest.get("pool_token"),
                                    code, name=args.name)
            except Exception as e:
                print(f"❌ pool template failed: {e}")
                return
            if code is None:
                tpls = res.get("templates") or []
                print(f"📋 templates: {', '.join(tpls) if tpls else '(none)'}"
                      f" — register one with --file CELL.py; each "
                      f"re-runs on every resized fleet so new workers "
                      f"start warm")
            elif res.get("status") == "ok":
                print(f"✅ template {args.name!r} ran on ranks "
                      f"{res.get('ranks')} — it will re-run after "
                      f"every resize")
            else:
                print(f"❌ {res.get('error') or res.get('errors') or res}")
            return
        # status — the attached tenant connection only answers for
        # ITS pool: `status --run-dir X` while attached to pool Y
        # must probe X, not render Y's queue under X's run dir
        # (same cross-pool guard as stop above).
        attached_dir = (DistributedMagics._pool_info or {}).get(
            "run_dir")
        client = (DistributedMagics._tenant if attached_dir == d
                  else None)
        try:
            if client is not None and client.alive:
                st = client.pool_status()
            else:
                from ..gateway.client import pool_status_probe
                st = pool_status_probe(host, port,
                                       manifest.get("pool_token"))
        except Exception as e:
            print(f"❌ pool status failed: {e}")
            return
        self._render_pool_status(
            st, d, show_autoscale=args.autoscale is not None)

    def _render_pool_status(self, st: dict, run_dir, *,
                            show_autoscale: bool = False) -> None:
        sched = st.get("scheduler") or {}
        pol = sched.get("policy") or {}
        mem = st.get("membership") or {}
        epoch_bit = (f" · epoch {st.get('epoch')} · gen "
                     f"{mem.get('generation')}"
                     if st.get("epoch") is not None else "")
        print(f"🏊 pool {run_dir} · pid {st.get('pid')} · "
              f"{st.get('world_size')} ranks{epoch_bit} · sched "
              f"{pol.get('mode')} (slots {pol.get('mesh_slots')}, "
              f"queue {sched.get('queued', 0)}/"
              f"{pol.get('queue_depth') or '∞'}, active "
              f"{sched.get('active', 0)}, shed "
              f"{sched.get('shed_total', 0)} total)")
        if st.get("autoscale"):
            print(f"⚖ autoscale armed: {st['autoscale']}")
        if show_autoscale:
            self._render_autoscale_audit(
                st.get("autoscale_decisions"))
        trans = mem.get("transition")
        if trans:
            print(f"⚠ resize in flight: {trans.get('from_world')} → "
                  f"{trans.get('to_world')} ranks (epoch "
                  f"{trans.get('from_epoch')} → "
                  f"{trans.get('to_epoch')}, reason: "
                  f"{trans.get('reason')}) — queued cells hold, "
                  f"in-flight cells drain")
        lat = (st.get("latency") or {}).get("summary") or {}
        if lat.get("count"):
            e = lat.get("e2e_ms") or {}
            q = (lat.get("stages") or {}).get("queue") or {}
            x = (lat.get("stages") or {}).get("execute") or {}
            print(f"⏱ cells: e2e p50/p99 {e.get('p50', 0)}/"
                  f"{e.get('p99', 0)} ms · queue p99 "
                  f"{q.get('p99', 0)} ms · execute p99 "
                  f"{x.get('p99', 0)} ms "
                  f"({lat['count']} recorded — %dist_lat for stages)")
        if st.get("metrics_port"):
            print(f"📈 scrape endpoint on port {st['metrics_port']} "
                  f"(/metrics, /healthz, /latency.json — pool token)")
        tenants = (st.get("tenants") or {}).get("tenants") or {}
        me = (DistributedMagics._tenant.name
              if DistributedMagics._tenant is not None else None)
        if tenants:
            hdr = (f"{'tenant':<14}{'state':<10}{'epoch':<7}"
                   f"{'prio':<6}{'queued':<8}{'active':<8}"
                   f"{'done':<7}{'shed':<6}{'rej':<5}{'parked':<7}")
            print(hdr)
            print("─" * len(hdr))
            per = (sched.get("tenants") or {})
            for name in sorted(tenants):
                t = tenants[name]
                s = per.get(name) or {}
                mark = "*" if name == me else ""
                state = ("attached" if t.get("attached")
                         else "detached")
                print(f"{(name + mark):<14}{state:<10}"
                      f"{t.get('epoch', '-'):<7}"
                      f"{t.get('priority', 0):<6}"
                      f"{s.get('queued', 0):<8}{s.get('active', 0):<8}"
                      f"{s.get('completed', 0):<7}"
                      f"{s.get('shed', 0):<6}{s.get('rejected', 0):<5}"
                      f"{t.get('parked', 0):<7}")
        else:
            print("(no tenants attached yet)")
        ranks = st.get("ranks") or {}
        mranks = mem.get("ranks") or {}
        draining = {r for r, m in mranks.items()
                    if m.get("state") == "draining"}
        stalled: set = set()
        for v in st.get("hang_verdicts") or ():
            stalled.update(str(r) for r in v.get("ranks") or ())
        # A draining rank is parked by the resize barrier ON PURPOSE —
        # rendering it stalled would be exactly the watchdog
        # mis-blame the drain path exists to prevent.
        stalled -= draining
        rows = [(r, v) for r, v in sorted(ranks.items(),
                                          key=lambda kv:
                                          int(kv[0]))
                if v.get("busy_type") or v.get("srv")
                or r in draining or r in stalled
                or (mranks.get(r) or {}).get("join_epoch", 1) > 1]
        for r, v in rows:
            who = (f" · tenant {v['tenant']}" if v.get("tenant")
                   else "")
            if r in draining:
                busy = "⚠ draining"
            elif r in stalled:
                busy = "⚠ stalled"
            elif v.get("busy_type"):
                busy = f"⚙ {v['busy_type']} {v.get('busy_s', 0):.1f}s"
            else:
                busy = "idle"
            je = (mranks.get(r) or {}).get("join_epoch")
            joined = (f" · joined ep {je}"
                      if je is not None and je > 1 else "")
            srv = v.get("srv") or {}
            kvb = srv.get("kvb") or ()
            scol = (f" · 🔄 {srv.get('tps', 0)} tok/s · KV "
                    f"{srv.get('occ', 0)}/{srv.get('slots', 0)}"
                    + (f" · {kvb[0]}/{kvb[1]} blk" if len(kvb) == 2
                       else "")
                    if srv else "")
            print(f"   rank {r}: {busy}{joined}{who}{scol}")
        if st.get("serving"):
            self._render_serve_status(st["serving"])
        for v in st.get("hang_verdicts") or ():
            print(f"   ⚠ HUNG [{v.get('kind')}] {v.get('detail')}")

    @staticmethod
    def _render_autoscale_audit(decisions) -> None:
        """The autoscaler decision audit trail: one row per recent
        observation — pressure inputs, sustain/cooldown state,
        verdict — newest last."""
        decs = decisions or []
        if not decs:
            print("   (no autoscale audit records — arm the "
                  "autoscaler with %dist_pool start --autoscale "
                  "MIN:MAX)")
            return
        hdr = (f"   {'age':>6} {'world':>5} {'verdict':<8} "
               f"{'target':>6} {'queued':>6} {'backlog':>7} "
               f"{'p95':>7} {'sustain':>8} reason")
        print(hdr)
        print("   " + "─" * (len(hdr) - 3))
        now = time.time()
        for rec in decs[-12:]:
            inp = rec.get("inputs") or {}
            age = max(0.0, now - float(rec.get("ts") or now))
            reason = rec.get("reason") \
                or ", ".join(rec.get("pressure") or ()) or "-"
            if rec.get("clamp"):
                reason = f"[clamp] {reason}"
            cd = rec.get("cooldown_s") or 0
            if cd and rec.get("verdict") == "hold":
                reason = f"cooldown {cd:.0f}s"
            tgt = rec.get("target")
            print(f"   {f'-{age:.0f}s':>6} "
                  f"{rec.get('world', '-'):>5} "
                  f"{rec.get('verdict', '-'):<8} "
                  f"{tgt if tgt is not None else '-':>6} "
                  f"{inp.get('queued', 0):>6} "
                  f"{inp.get('backlog', 0):>7} "
                  f"{inp.get('queue_p95_s', 0):>6.2f}s "
                  f"{rec.get('sustain_s', 0):>7.1f}s {reason}")

    def _run_on_pool(self, code: str, *, priority=None,
                     deadline_s=None):
        """Tenant-mode cell dispatch: submit to the gateway, surface
        the explicit queue-position / shed / rejected verdicts, and
        render per-rank results the way the single-kernel path does.
        Returns the per-rank results, or None when the cell did not
        run (a verdict, a fence, the gateway gone)."""
        from ..gateway.client import (CellSubmitError, GatewayGone,
                                      TenantFenced)
        client = DistributedMagics._tenant
        rec = self._timeline.start(code,
                                   list(range(self._world or 0)),
                                   kind="pool")

        def _late(d: dict) -> None:
            # The interrupted cell's terminal reply arrived on this
            # still-live connection (so the gateway delivered it and
            # nothing parked): render it instead of dropping it —
            # including the no-results verdicts (worker death, request
            # timeout, shed), which are exactly the crash outcomes.
            self._render_drained_reply("", d, "finished", prefix="\n")

        data = None
        try:
            data = client.execute(
                code, priority=priority, deadline_s=deadline_s,
                timeout=None,
                on_queued=lambda n: print(
                    f"⏳ pool busy — queued at position "
                    f"{n.get('position')}"
                    + (f"\n   🚧 {n['reason']}" if n.get("reason")
                       else "")),
                on_late=_late)
        except CellSubmitError as e:
            v = e.verdict
            if v.get("status") == "shed":
                print(f"🪓 {v.get('error')}")
            else:
                print(f"🚦 {v.get('error')}")
            return None
        except TenantFenced as e:
            print(f"⛔ {e}\n   Another kernel reattached as tenant "
                  f"{client.name!r}: this connection is fenced.")
            return None
        except GatewayGone as e:
            print(f"💀 {e}\n   The pool (or its daemon) is gone — "
                  "%dist_pool status, or %dist_attach --tenant "
                  f"{client.name} once it is back.")
            return None
        except KeyboardInterrupt:
            print("\n🛑 interrupt: the cell keeps running on the "
                  "pool; its result will print here when it finishes "
                  "(or parks for redelivery on the next attach if "
                  "this kernel exits first)")
            return None
        except Exception as e:
            print(f"❌ {type(e).__name__}: {e}")
            return None
        finally:
            self._timeline.finish(rec, None)
        # Only errors render from the reply: stdout AND the result
        # repr already arrived live as tenant-routed stream_output
        # frames (same contract as the single-kernel display path —
        # printing the reply's "output" here would double everything).
        data = data or {}
        if data.get("error"):
            # Gateway-level failure (worker death, request timeout):
            # there are no per-rank results to render the error from —
            # without this line the cell looks like a silent success.
            print(f"❌ pool: {data['error']}")
        results = data.get("results") or {}
        for r in sorted(results, key=int):
            d = results[r] or {}
            if d.get("error"):
                print(f"❌ rank {r}: {d['error']}")
        return results

    # ==================================================================
    # the gateway's serving plane

    def dist_serve(self, line):
        """Serving through the gateway (tenant mode): ``%dist_serve
        start --spec SPEC_VAR`` opens a continuous-batching decode
        loop on the pool; ``submit --prompt 1,2,3 --max-new 16``
        enters a generation request (explicit accepted/shed/rejected
        verdicts, tokens stream back live); ``result``/``stream
        --from K`` poll or resume a stream; ``status``/``stop`` manage
        the plane.  Accepted requests are journaled and survive rank
        death — see README "The gateway's serving plane"."""
        from ..gateway.client import CellSubmitError, GatewayGone
        client = DistributedMagics._tenant
        if client is None:
            print("❌ not attached to a gateway pool — %dist_attach "
                  "--tenant NAME first (%dist_pool start spawns one)")
            return
        args = _parse("dist_serve", line)
        try:
            if args.command == "start":
                spec = None
                if args.spec:
                    spec = self.shell.user_ns.get(args.spec)
                    if not isinstance(spec, str):
                        print(f"❌ --spec {args.spec}: no string "
                              "variable of that name in this kernel")
                        return
                st = client.serve_start(
                    spec, tenant=args.tenant, params=args.params,
                    cfg=args.cfg, max_batch=args.max_batch,
                    max_len=args.max_len, pad_to=args.pad_to,
                    eos_id=args.eos, steps=args.steps,
                    queue_depth=args.queue_depth,
                    inflight=args.inflight,
                    decode_ranks=args.decode_ranks,
                    kv_block_tokens=args.kv_block_tokens,
                    kv_blocks=args.kv_blocks,
                    prefill_chunk=args.prefill_chunk,
                    kv_quantized=(True if args.kv_quantized
                                  else None))
                kv = st.get("kv") or {}
                print(f"🍽️ serving as tenant {st.get('tenant')!r}: "
                      f"{st.get('slots')} KV slots · max_len "
                      f"{st.get('max_len')} · decode rank "
                      f"{st.get('decode_rank')}"
                      + (f" · {kv.get('blocks_per_rank')} KV blocks"
                         f"/rank × {kv.get('block_tokens')} tok"
                         if kv else ""))
            elif args.command == "submit":
                if not args.prompt:
                    print("❌ submit needs --prompt 1,2,3")
                    return
                prompt = [int(t) for t in args.prompt.replace(",", " ")
                          .split()]
                v = client.serve_submit(prompt, args.max_new,
                                        priority=args.priority)
                rid = v.get("rid")
                pos = (f" (queued at {v['position']})"
                       if v.get("queued") else "")
                print(f"✅ accepted {rid}{pos} — tokens stream here; "
                      f"%dist_serve result --rid {rid} to poll")
                if args.wait:
                    while True:
                        r = client.serve_result(rid)
                        if r.get("done"):
                            print(f"🧾 {rid} {r.get('status')}: "
                                  f"{r.get('tokens')}")
                            break
                        time.sleep(0.3)
            elif args.command == "result":
                if not args.rid:
                    print("❌ result needs --rid rN")
                    return
                r = client.serve_result(args.rid)
                print(f"{args.rid}: {r.get('status')} "
                      f"{r.get('tokens')}"
                      + (f" — {r['error']}" if r.get("error") else ""))
            elif args.command == "stream":
                if not args.rid:
                    print("❌ stream needs --rid rN")
                    return
                r = client.serve_stream(args.rid, args.from_offset)
                print(f"{args.rid}[{r.get('offset')}:]: "
                      f"{r.get('tokens')} "
                      f"({'done' if r.get('done') else 'decoding'})")
            elif args.command == "stop":
                st = client.serve_stop()
                print(f"🛑 serving stopped: {st.get('completed')} "
                      f"completed · {st.get('tokens_total')} tokens")
            elif args.command == "lat":
                st = client.serve_status()
                if st.get("status") == "off":
                    print("(no serving plane running — %dist_serve "
                          "start)")
                    return
                self._render_serve_lat(st.get("lat") or {},
                                       last=args.last)
            else:  # status
                st = client.serve_status()
                if st.get("status") == "off":
                    print("(no serving plane running — %dist_serve "
                          "start)")
                    return
                self._render_serve_status(st)
        except CellSubmitError as e:
            v = e.verdict
            mark = "🪓" if v.get("status") == "shed" else "🚦"
            print(f"{mark} {v.get('error')}")
        except GatewayGone as e:
            print(f"💀 {e}")
        except Exception as e:
            print(f"❌ {type(e).__name__}: {e}")

    @staticmethod
    def _render_serve_status(st: dict) -> None:
        dranks = st.get("decode_ranks") or []
        rank_str = (str(st.get("decode_rank")) if len(dranks) <= 1
                    else ",".join(str(r) for r in sorted(dranks)))
        print(f"🍽️ serving[{st.get('tenant')}] · decode rank"
              f"{'s' if len(dranks) > 1 else ''} {rank_str} · KV "
              f"{st.get('decoding', 0)}/{st.get('slots')} · pending "
              f"{st.get('pending', 0)} · tokens "
              f"{st.get('tokens_total', 0)}")
        kv = st.get("kv") or {}
        if kv.get("used") or kv.get("free"):
            per_rank = " · ".join(
                f"r{r}: {v.get('placed', 0)} req, "
                f"{v.get('kv_used', 0)} blk"
                for r, v in sorted((st.get("ranks") or {}).items(),
                                   key=lambda kv_: int(kv_[0])))
            print(f"   KV blocks {kv.get('used', 0)}/"
                  f"{kv.get('used', 0) + kv.get('free', 0)} used · "
                  f"{kv.get('block_tokens')} tok/block"
                  + (f" · {per_rank}" if per_rank else ""))
            tb = kv.get("tenants") or {}
            if tb:
                print("   blocks by tenant: " + " · ".join(
                    f"{t}: {n}" for t, n in sorted(tb.items())))
        # Utilization line: recent batch fill + the
        # prefill/decode token split + per-rank fragmentation.
        util = (st.get("lat") or {}).get("util") or {}
        if util.get("count"):
            frag = " · ".join(
                f"r{r}: run {v.get('frag', '?')}"
                + (f", defer {v['pending']}"
                   if v.get("pending") else "")
                for r, v in sorted((util.get("ranks") or {}).items(),
                                   key=lambda kv_: int(kv_[0])))
            print(f"   util: batch fill {util.get('fill_mean', 0):.0%}"
                  f" mean / {util.get('fill_max', 0):.0%} max · "
                  f"prefill share "
                  f"{util.get('prefill_share', 0):.0%} of "
                  f"{util.get('prefill_toks', 0) + util.get('decode_toks', 0)}"
                  f" tok" + (f" · {frag}" if frag else ""))
        print(f"   accepted {st.get('accepted', 0)} · completed "
              f"{st.get('completed', 0)} · shed {st.get('shed', 0)} · "
              f"rejected {st.get('rejected', 0)} · replayed "
              f"{st.get('replayed', 0)} · resumed "
              f"{st.get('resumed', 0)} · failovers "
              f"{st.get('failovers', 0)} · dup-dropped "
              f"{st.get('dup_dropped', 0)}")
        slo = st.get("slo") or {}

        def _pp(block: dict, key: str) -> str:
            s = (block or {}).get(key + "_ms")
            return (f"{s['p50']:g}/{s['p99']:g}" if s else "–")

        if slo:
            print(f"   SLO p50/p99 ms · TTFT {_pp(slo, 'ttft')} · "
                  f"TPOT {_pp(slo, 'tpot')} · queue "
                  f"{_pp(slo, 'queue')} · e2e {_pp(slo, 'e2e')}")
            for t, b in sorted((slo.get("tenants") or {}).items()):
                print(f"     {t}: TTFT {_pp(b, 'ttft')} · TPOT "
                      f"{_pp(b, 'tpot')} · queue {_pp(b, 'queue')} · "
                      f"e2e {_pp(b, 'e2e')}")
        if st.get("last_error"):
            print(f"   ⚠ last driver error: {st['last_error']}")

    @staticmethod
    def _render_serve_lat(lat: dict, *, last: int = 0) -> None:
        """``%dist_serve lat``: per-stage percentile table over the
        observatory ring, plus (with ``--last N``) the ASCII stage
        waterfall of the most recent completions."""
        from ..observability import servingobs as _sobs
        summ = lat.get("summary") or {}
        if not summ.get("count"):
            print("(no completed serving requests recorded yet — "
                  "submit some, or check NBD_SERVE_LAT)")
            return
        print(f"⏱ serving stage decomposition ({summ['count']} "
              f"recorded, {summ.get('dropped', 0)} dropped):")
        print(_sobs.format_serve_stage_table(summ))
        if last:
            recs = (lat.get("records") or [])[-last:]
            if recs:
                print()
                print(_sobs.format_serve_waterfall(recs))
            else:
                print("(no per-request records in the status "
                      "payload)")

    # ==================================================================
    # timeline magics (reference: magic.py:1778-1870)

    def timeline_show(self, line):
        print(self._timeline.summary())

    def timeline_save(self, line):
        args = _parse("timeline_save", line)
        n = self._timeline.save(args.path)
        print(f"✅ saved {n} cell records → {args.path}")

    def timeline_clear(self, line):
        self._timeline.clear()
        print("✅ timeline cleared")

    def timeline_debug(self, line):
        """Dump every record's raw internals (reference:
        %timeline_debug, magic.py:1778-1870)."""
        print(self._timeline.debug_dump())

    def timeline_sidecar(self, line):
        """``%timeline_sidecar on [path] | off`` — auto-flush the
        timeline to a sidecar JSON after every cell; the server-side
        ``pre_save_hook`` (nbdistributed_tpu_torch.jupyter_hooks)
        folds it into the notebook's ``metadata.execution_timelines``
        at save (reference: magic.py:196-233, without its
        classic-frontend-only injected JS).  With no explicit path,
        the notebook's own path is taken from ``JPY_SESSION_NAME``
        when the front-end provides it."""
        parts = line.split(None, 1)
        mode = parts[0] if parts else "on"
        if mode == "off":
            old = DistributedMagics._sidecar
            DistributedMagics._sidecar = None
            # Remove the file too: a stale sidecar would keep being
            # embedded into the notebook on every later save.
            if old:
                try:
                    os.remove(old)
                except OSError:
                    pass
            print("✅ timeline sidecar off (file removed; a timeline "
                  "already embedded by an earlier save stays in the "
                  "notebook's metadata until overwritten)")
            return
        if mode != "on":
            print("usage: %timeline_sidecar on [path] | off")
            return
        if len(parts) > 1:
            # Everything after "on" is the path (spaces allowed;
            # surrounding quotes stripped).
            nb_path = parts[1].strip().strip("'\"")
        else:
            nb_path = os.environ.get("JPY_SESSION_NAME")
            if not nb_path:
                print("❌ no notebook path available (JPY_SESSION_NAME "
                      "unset — older front-end?); pass one explicitly: "
                      "%timeline_sidecar on my_notebook.ipynb")
                return
            if not os.path.isabs(nb_path):
                # JPY_SESSION_NAME is server-root-relative while this
                # kernel runs in the notebook's own directory — resolve
                # the BASENAME in the cwd, the file the server-side
                # pre_save_hook will read.
                nb_path = os.path.basename(nb_path)
        from ..jupyter_hooks import sidecar_path
        DistributedMagics._sidecar = sidecar_path(nb_path)
        if not self._flush_sidecar():
            # The per-cell flush is fail-open; the explicit 'on' is
            # the one moment to fail loudly.
            bad = DistributedMagics._sidecar
            DistributedMagics._sidecar = None
            print(f"❌ could not write {bad} (missing directory or "
                  f"permissions?); sidecar NOT enabled")
            return
        print(f"✅ timeline sidecar → {DistributedMagics._sidecar} "
              f"(enable the pre_save_hook in jupyter_server_config.py "
              f"to embed it into the notebook at save)")

    # ==================================================================
    # shutdown / reset (tiered, reference: magic.py:810-1040)

    @classmethod
    def shutdown_all(cls) -> None:
        """Polite tier: control-plane shutdown broadcast, then process
        teardown (reference: magic.py:1005-1036).  Stops the
        supervisor, the watchdog and the scrape endpoint — except that
        a heal keeps the watchdog (it re-binds to the healed world) and
        a supervisor or watchdog tearing down from its own thread keeps
        itself."""
        sup = cls._supervisor
        if sup is not None and not sup.on_own_thread():
            # A user-initiated shutdown ends supervision; when the
            # SUPERVISOR is the caller (mid-heal, tearing down the old
            # world before respawning), it must stay alive.
            sup.stop()
            cls._supervisor = None
        wd = cls._watchdog
        if wd is not None and not wd.on_own_thread() \
                and not cls._healing:
            # Same own-thread rule: a watchdog-driven heal goes through
            # this teardown; the watchdog re-binds to the healed world
            # instead of stopping itself mid-ladder.  During ANY
            # %dist_heal (_healing) the instance likewise survives so
            # the replayed %dist_init re-binds it.
            wd.stop()
            cls._watchdog = None
        # An in-flight background save dies with its world; its
        # per-rank doneness must not leak into the next world and
        # promote a half-written checkpoint as the heal target.
        cls._clear_bg_ckpt()
        if cls._comm is not None:
            # A cell still waiting gets the shutdown's verdict now,
            # before any rank is told to leave: a planned exit must not
            # reach it first as a death.
            cls._comm.fail_pending()
        if cls._pm is not None:
            cls._pm.quiesce()  # planned exits are not deaths
        if cls._comm is not None:
            try:
                cls._comm.post(cls._comm.connected_ranks(), "shutdown")
                time.sleep(0.3)
            except Exception:
                pass
            try:
                cls._comm.shutdown()
            except Exception:
                pass
        if cls._pm is not None:
            try:
                cls._pm.shutdown()
            except Exception:
                pass
        if cls._metrics_httpd is not None:
            try:
                cls._metrics_httpd.close()
            except Exception:
                pass
            cls._metrics_httpd = None
        inst = cls._instance
        if inst is not None:
            try:
                inst._disable_auto_mode()
            except Exception:
                cls._auto_active = False
            try:
                # Raising stubs and stale mirrors must not outlive the
                # cluster they point at.
                proxies.remove_proxies(inst.shell.user_ns,
                                       cls._proxy_registry)
            except Exception:
                pass
        # Window futures still pending at teardown resolve through the
        # handles' death/disconnect aborts; the executor itself dies
        # with the comm it wraps.
        cls._async_exec = None
        cls._comm = None
        cls._pm = None
        cls._world = 0

    @classmethod
    def _end_durable_session(cls, token: str | None, epoch: int) -> None:
        """EXPLICIT fleet teardown ends the durable session (manifest
        removed) — but only when THIS kernel still owns it: another
        session's manifest, or one handed to a newer epoch, stays."""
        from ..resilience import session as session_mod
        d = _knobs.get_str("NBD_RUN_DIR")
        if not d or token is None:
            return
        m = session_mod.read_manifest(d)
        if m is None:
            return
        if m.get("token") != token:
            return  # another session's manifest — not ours to remove
        if int(m.get("epoch") or 0) > epoch:
            print("⚠️ this session was reattached by a newer "
                  "coordinator (manifest epoch "
                  f"{m.get('epoch')} > ours {epoch}); leaving its "
                  "manifest in place")
            return
        session_mod.end_session(d)

    @classmethod
    def _session_identity(cls) -> tuple[str | None, int]:
        comm = cls._comm
        return (getattr(comm, "session_token", None) if comm else None,
                int(getattr(comm, "session_epoch", 0) or 0)
                if comm else 0)

    def dist_shutdown(self, line):
        """Stop all workers (reference: magic.py:810-837): the workers
        and the session manifest are destroyed.  The workers go by
        ``ProcessManager.shutdown``'s SIGTERM then SIGKILL of each
        rank's process group; unlike the JAX package's, nothing
        pkills every worker on the host, which would take other
        kernels' fleets with it.  Streamed cells still in flight drain
        first (for at most ``_SHUTDOWN_DRAIN_S``), so their errors
        surface instead of dying with the fleet.  In tenant mode the
        POOL belongs to every tenant: this kernel only detaches (its
        in-flight results park for a later ``%dist_attach --tenant``;
        ``%dist_pool stop`` ends the pool)."""
        if DistributedMagics._tenant is not None:
            name = DistributedMagics._drop_tenant_state(detach=True)
            print(f"✅ detached tenant {name!r} from the pool (the "
                  "pool keeps running — %dist_pool stop ends it; "
                  f"%dist_attach --tenant {name} resumes this "
                  "tenant)")
            return
        had = self._world
        self._drain_async("%dist_shutdown", _SHUTDOWN_DRAIN_S)
        token, epoch = self._session_identity()
        self.shutdown_all()
        self._end_durable_session(token, epoch)
        print(f"✅ shut down {had} workers" if had else "✅ nothing to "
              "shut down")

    def dist_reset(self, line):
        """Full reset for a fresh start (reference: magic.py:963-1003);
        the async window drains first, as at ``%dist_shutdown``."""
        self._drain_async("%dist_reset", _SHUTDOWN_DRAIN_S)
        token, epoch = self._session_identity()
        self.shutdown_all()
        self._end_durable_session(token, epoch)
        DistributedMagics._timeline = Timeline()
        print("✅ reset complete — %dist_init to start a new cluster")
