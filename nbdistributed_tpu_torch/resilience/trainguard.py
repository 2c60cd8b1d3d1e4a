"""Training integrity guard: silent-data-corruption detection and
recovery around the train step (counterpart of
``nbdistributed_tpu/resilience/trainguard.py``).

Four cooperating mechanisms, as in the JAX package:

1. **Guarded step.**  ``make_tp_train_step(..., guard=True)`` (and
   ``make_ddp_step`` and the ZeRO builders) checks the fp32 global
   gradient norm² and the loss, skips a non-finite step (params, the
   optimizer's moments and its step count untouched) and returns
   ``(loss, {"v": [ok, loss, gnorm]})``.  :class:`TrainGuard` resolves
   those verdicts lagged and batched: one stack and one transfer per
   ~lag steps.  (The port's step already reads its verdict on the host
   once per step to decide the skip; the guard's resolution is its
   bookkeeping, not that decision.)

2. **Replica-consistency audit.**  Every N steps each rank folds its
   params into a 2×32-bit fingerprint (:func:`tree_fingerprint`, the
   same bits as the JAX package's for the same bytes), the ranks that
   should hold identical params all-gather the fingerprints as four
   int32 half-words, and each computes the same majority verdict
   (:func:`vote`) from the same rows.  A minority rank is repaired by a
   broadcast from the lowest majority rank; with no majority the guard
   restores the durable checkpoint.

   *Which ranks vote.*  A JAX process is a whole replica, so the JAX
   guard gathers over every process.  A port rank holds one GPU, and a
   mesh spans ranks, so the port votes among the ranks that hold the
   same shard:

   - no ``mesh``: the world (independent replicas, each training the
     whole model on a mesh of its own, or DDP over the world);
   - a ``mesh``: its ``dp_axis`` group, the ranks holding replicas of
     this rank's shard.  Under Megatron tp the tp shards differ by
     design, and each dp group votes on its own shard.  Positions in the
     verdict (``minority``, ``majority_rank``) are coordinates on
     ``dp_axis``.  Where some dp group finds no majority, every rank of
     the mesh restores the durable checkpoint (a pmax of that flag over
     the mesh's other axes), so that all shards go back to one step;
   - ZeRO (the optimizer is :class:`..parallel.zero._Zero`): each rank's
     moment slice has no replica, and it is computed from the
     dp-reduced gradient, so it is as sound on a minority rank as on
     any other; the repair re-broadcasts the params only.  Otherwise
     the repair covers the params and every optimizer tensor and step
     count (replicated over the group);
   - params split over ``dp_axis`` (FSDP, HSDP's dp axis, by ``rules``):
     no rank holds a replica of another's shard, so there is nothing to
     vote among, and ``TrainGuard(audit_every > 0)`` raises.

3. **Rollback.**  A bounded ring of in-memory snapshots (clones of the
   params and of the optimizer's state: AdamW's ``mu``, ``nu`` and
   ``step``, or the ZeRO slices and their state), taken only while no
   skip is outstanding, and durable checkpoints by
   :func:`..runtime.checkpoint.save_async` at a coarser cadence.  A
   blown consecutive-skip budget or a confirmed loss spike copies the
   last snapshot back **in place** (the optimizer keeps stepping the
   same tensors; the ring entry stays intact for a second rollback).

4. **Bit-flip chaos.**  :class:`.faults.CorruptSpec` entries of the
   process fault plan fire inside :meth:`TrainGuard.step`, flipping
   seeded bits of a named param leaf on a chosen rank
   (:func:`apply_corrupt`): the same leaf and bytes as the JAX package
   for the same spec and seed.

Thread model: every mutation happens on the thread that calls
:meth:`TrainGuard.step` (the worker's serial request loop).  Counters
and containers shared with its rarer paths are guarded by
``self._lock``; the per-step path mutates only single-writer state
(``_i``, ``_pending``) and takes no lock.  The heartbeat thread reads
only the atomically rebound ``_snap`` dict (the ``tg`` ping field).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..observability import flightrec
from ..observability import metrics as obs_metrics
from ..utils import knobs
from ..utils.pytree import tree_leaves, tree_leaves_with_path
from . import faults

# Attributes with exactly one writer thread (or GIL-atomic mutation)
# that deliberately skip the lock.
_LINT_SINGLE_WRITER = {
    "TrainGuard._i":
        "written only by the thread calling step(); the heartbeat "
        "thread reads the atomically-rebound _snap dict and describe() "
        "reads a GIL-atomic int — the hot path must not pay a lock "
        "acquisition per train step",
    "TrainGuard._pending":
        "appended only by the thread calling step() and drained by "
        "the same thread in _resolve_pending (deque ops are GIL-"
        "atomic); no other thread touches the queue",
}


# ----------------------------------------------------------------------
# fingerprints (PyTorch ops on the leaf's device)

_M32 = 0xFFFFFFFF
# Words folded per vectorized slice: bounds the int64 temporaries.
_SLICE = 1 << 24
_SIGNED = {1: "int8", 2: "int16", 4: "int32", 8: "int64"}


def _as_tensor(x):
    """``x`` as a tensor holding the same bytes: a tensor as it is, a
    numpy array (any dtype, bfloat16 included) through a signed integer
    view of its bytes, a Python number as numpy makes it."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    arr = np.ascontiguousarray(np.asarray(x))
    if not arr.flags.writeable:     # torch.from_numpy wants a writable one
        arr = arr.copy()
    if arr.dtype == np.bool_:
        return torch.from_numpy(arr)
    if (arr.dtype.itemsize not in _SIGNED or arr.dtype.kind in "OUS"
            or arr.dtype.names is not None):
        raise TypeError(f"cannot fingerprint dtype {arr.dtype}")
    return torch.from_numpy(arr.view(_SIGNED[arr.dtype.itemsize]))


def _to_words(x):
    """The leaf's raw bits as a flat vector of 32-bit words, held in
    int64 (``trainguard.py:98``): sub-word dtypes widen from their
    unsigned view, bool becomes 0 or 1, and an 8-byte dtype splits into
    two words, low word first (``bitcast_convert_type``'s order)."""
    t = _as_tensor(x).reshape(-1)
    if t.dtype == torch.bool:
        return t.to(torch.int64)
    size = t.element_size()
    if size == 4:
        return t.view(torch.int32).to(torch.int64) & _M32
    if size == 2:
        return t.view(torch.int16).to(torch.int64) & 0xFFFF
    if size == 1:
        return t.view(torch.uint8).to(torch.int64)
    if size == 8:
        return t.view(torch.int32).to(torch.int64) & _M32
    raise TypeError(f"cannot fingerprint dtype {t.dtype}")


def _fold_words(words):
    """Fold a word vector to a (2,) int64 tensor of two uint32 lanes
    (``trainguard.py:120``): lane A sums ``w_i * (2i + 1)``, lane B
    ``w_i * ((i * 2654435761) | 1)``, both mod 2^32.  A single bit flip
    in word i moves lane A by ±2^k·(2i + 1), never 0 mod 2^32, so every
    single-bit flip is seen.

    JAX pads to its 2^15-word chunk and scans the chunks with positions
    ``base + j``; the padding words are 0 and add nothing, so folding
    slices of any length at the same positions gives its exact sums.
    Each product is masked to 32 bits before a sum (an int64 product of
    two 32-bit words may wrap; its low 32 bits survive the wrap), and a
    slice's sum of masked products stays below 2^63."""
    n = words.numel()
    a = torch.zeros((), dtype=torch.int64, device=words.device)
    b = torch.zeros((), dtype=torch.int64, device=words.device)
    for start in range(0, n, _SLICE):
        w = words[start:start + _SLICE]
        idx = torch.arange(start, start + w.numel(), dtype=torch.int64,
                           device=words.device)
        wa = ((idx << 1) | 1) & _M32
        wb = ((idx * 2654435761) | 1) & _M32
        a = (a + ((w * wa) & _M32).sum()) & _M32
        b = (b + ((w * wb) & _M32).sum()) & _M32
    return torch.stack([a, b])


def leaf_fingerprint(x):
    """(2,) int64 tensor (two uint32 values) fingerprinting one leaf's
    exact bits, on the leaf's device; JAX's ``(a, b)`` for the same
    bytes (``trainguard.py:163``)."""
    return _fold_words(_to_words(x))


def _mix32(h: int) -> int:
    """murmur3 fmix32: a bijective avalanche on 32-bit ints."""
    h &= 0xFFFFFFFF
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def _host_rows(fps: list) -> list:
    """The (2,) fingerprints as host pairs, one stacked transfer per
    device (``_stack_fn``, ``trainguard.py:169``)."""
    rows: list = [None] * len(fps)
    by_dev: dict = {}
    for i, f in enumerate(fps):
        by_dev.setdefault(f.device, []).append(i)
    for idx in by_dev.values():
        got = torch.stack([fps[i] for i in idx]).tolist()
        for i, r in zip(idx, got):
            rows[i] = r
    return rows


def tree_fingerprint(tree) -> tuple[int, int]:
    """Fold a whole tree to one ``(a, b)`` pair of 32-bit ints
    (``trainguard.py:203``): per-leaf fingerprints, in JAX's leaf order,
    mixed on the host with a per-position salt and :func:`_mix32` before
    the polynomial fold, so that any change to one leaf changes the fold
    and swapped identical-shape leaves do not cancel.  An optimizer
    folds as its state dict."""
    leaves = tree_leaves(tree)
    if not leaves:
        return 0, 0
    rows = _host_rows([leaf_fingerprint(leaf) for leaf in leaves])
    a = b = 0
    for i, (fa, fb) in enumerate(rows):
        sa = (0x9E3779B9 * (i + 1)) & 0xFFFFFFFF
        sb = (0x632BE5AB * (i + 1)) & 0xFFFFFFFF
        a = (a * 0x01000193 + _mix32(int(fa) ^ sa)) & 0xFFFFFFFF
        b = (b * 0x01000193 + _mix32(int(fb) ^ sb)) & 0xFFFFFFFF
    return a, b


# ----------------------------------------------------------------------
# majority vote

@dataclass(frozen=True)
class AuditVerdict:
    """Outcome of one replica-consistency audit.  ``majority_rank`` is
    the lowest rank holding the strict-majority fingerprint (the repair
    broadcast root), or None when no fingerprint holds a strict
    majority — a 2-rank split or an N-way tie, where naming a culprit
    is impossible and the only trustworthy state is the durable
    checkpoint."""
    ok: bool
    majority_rank: int | None
    minority: tuple[int, ...]


def vote(fps) -> AuditVerdict:
    """Majority verdict over per-rank fingerprints (rank = list index).
    Pure and deterministic: every rank feeds it the same gathered rows
    and reaches the same verdict, which keeps the repair collectives
    aligned."""
    fps = [tuple(int(v) for v in f) for f in fps]
    if not fps:
        raise ValueError("vote needs at least one fingerprint")
    counts: dict[tuple, int] = {}
    for f in fps:
        counts[f] = counts.get(f, 0) + 1
    if len(counts) == 1:
        return AuditVerdict(ok=True, majority_rank=None, minority=())
    world = len(fps)
    majority_fp = None
    for f, n in counts.items():
        if n > world // 2:
            majority_fp = f
            break
    if majority_fp is None:
        return AuditVerdict(ok=False, majority_rank=None,
                            minority=tuple(range(world)))
    ranks = [r for r, f in enumerate(fps) if f == majority_fp]
    minority = tuple(r for r, f in enumerate(fps) if f != majority_fp)
    return AuditVerdict(ok=False, majority_rank=min(ranks),
                        minority=minority)


# ----------------------------------------------------------------------
# loss-spike detection

class SpikeDetector:
    """Rolling median/MAD outlier detector with consecutive
    confirmation.  A loss above ``median + nmad·MAD`` is *suspect*;
    ``confirm`` consecutive suspects make it *confirmed* (one bad batch
    is a skip problem, a run of them is divergence).  Suspect losses
    never enter the history — a spike must not drag its own baseline
    up until it stops looking like one."""

    def __init__(self, *, window: int = 64, nmad: float = 8.0,
                 confirm: int = 2, min_history: int = 16):
        self._hist: deque[float] = deque(maxlen=max(4, int(window)))
        self.nmad = float(nmad)
        self.confirm = max(1, int(confirm))
        self.min_history = max(2, int(min_history))
        self._streak = 0
        # Median/MAD are recomputed every ``window // 8`` accepted
        # losses: with a 64-deep window the baseline cannot move
        # meaningfully in 8 steps, and the two sorts were the largest
        # per-step host cost of the guarded loop.
        self._refresh_every = max(1, self._hist.maxlen // 8)
        self._since_refresh: int | None = None  # None = stats stale
        self._med = 0.0
        self._mad = 0.0

    def _refresh_stats(self) -> None:
        hist = sorted(self._hist)
        self._med = hist[len(hist) // 2]
        self._mad = sorted(
            abs(h - self._med) for h in hist)[len(hist) // 2]
        self._since_refresh = 0

    def observe(self, loss: float) -> str:
        """Feed one resolved (finite) loss; returns ``"ok"``,
        ``"suspect"``, or ``"confirmed"``."""
        import math
        if not math.isfinite(loss):
            # Non-finite losses belong to the skip path, not the spike
            # baseline.
            return "suspect"
        if len(self._hist) < self.min_history:
            self._hist.append(loss)
            self._streak = 0
            self._since_refresh = None
            return "ok"
        if (self._since_refresh is None
                or self._since_refresh >= self._refresh_every):
            self._refresh_stats()
        med, mad = self._med, self._mad
        # MAD floor: a perfectly flat loss (mad = 0) must not turn float
        # jitter into spikes.
        floor = 1e-9 + 1e-3 * abs(med)
        if loss > med + self.nmad * max(mad, floor):
            self._streak += 1
            return ("confirmed" if self._streak >= self.confirm
                    else "suspect")
        self._hist.append(loss)
        self._since_refresh += 1
        self._streak = 0
        return "ok"

    def reset_streak(self) -> None:
        self._streak = 0


# ----------------------------------------------------------------------
# chaos: applying a CorruptSpec to a live tree

def apply_corrupt(tree, spec, seed: int = 0):
    """Damage one leaf of ``tree`` per ``spec``
    (:class:`.faults.CorruptSpec`), in place; returns ``(tree,
    leaf_name)``.  Leaves are named as ``jax.tree_util.keystr`` names
    them (``"['layers']['wq']"``): the name picks the leaf and seeds
    the rng, so the same spec and seed damage the same bytes as in the
    JAX package (``trainguard.py:351``).  The damage is done on a host
    copy and copied back into the live tensor."""
    import random as _random
    import zlib

    from ..messaging.codec import from_storage, wire_array

    flat = tree_leaves_with_path(tree)
    idx = next((i for i, (name, _) in enumerate(flat)
                if spec.name == "*" or spec.name in name), None)
    if idx is None:
        known = [name for name, _ in flat[:8]]
        raise ValueError(
            f"corrupt spec names {spec.name!r} but no param leaf path "
            f"matches (leaf paths: {known}{'...' if len(flat) > 8 else ''})")
    name, leaf = flat[idx]
    is_tensor = isinstance(leaf, torch.Tensor)
    if not is_tensor and not isinstance(leaf, np.ndarray):
        raise ValueError(f"cannot corrupt {name}: a {type(leaf).__name__} "
                         f"leaf has no bytes to damage in place")
    rng = _random.Random((int(seed) * 1_000_003)
                         ^ zlib.crc32(name.encode())
                         ^ (spec.rank * 65_537 + spec.step))
    if spec.mode == "bitflip":
        if is_tensor:
            arr, dname = wire_array(leaf)
            host = np.array(arr)
        else:
            host = np.array(leaf)
        view = host.view(np.uint8).reshape(-1)
        for _ in range(spec.bits):
            pos = rng.randrange(view.size * 8)
            view[pos // 8] ^= np.uint8(1 << (pos % 8))
        if is_tensor:
            host = torch.as_tensor(from_storage(host, dname))
    else:  # "scale"
        host = (leaf.detach().to("cpu", copy=True) if is_tensor
                else np.array(leaf))
        flatv = host.reshape(-1)
        n = flatv.numel() if is_tensor else flatv.size
        c = min(spec.count, n)
        start = rng.randrange(n - c + 1)
        flatv[start:start + c] = flatv[start:start + c] * spec.scale
    if is_tensor:
        with torch.no_grad():
            leaf.copy_(host.reshape(leaf.shape))
    else:
        leaf[...] = host
    return tree, name


# ----------------------------------------------------------------------
# the optimizer's state, as the guard snapshots, restores and repairs it

def _zero_state(optimizer):
    """The ZeRO state object when ``optimizer`` is one, else None."""
    from ..parallel.zero import _Zero
    return optimizer if isinstance(optimizer, _Zero) else None


def _inner(optimizer):
    """The ``torch.optim.Optimizer`` holding the state: ZeRO's optimizer
    over its slices, or the optimizer itself (None: no state)."""
    zero = _zero_state(optimizer)
    return zero.optimizer if zero is not None else optimizer


def _opt_params(opt) -> list:
    if opt is None:
        return []
    return [p for g in opt.param_groups for p in g["params"]]


def _clone_state(st: dict) -> dict:
    return {k: (v.detach().clone() if isinstance(v, torch.Tensor) else v)
            for k, v in st.items()}


def _load_state(opt, states: list) -> None:
    """Each parameter's optimizer state set to a snapshot's, tensors by
    ``copy_`` where the live one has the shape and dtype (an empty
    snapshot clears the state: the next step initializes it anew)."""
    for p, snap in zip(_opt_params(opt), states):
        if not snap:
            opt.state.pop(p, None)
            continue
        st = opt.state[p]
        for k in [k for k in st if k not in snap]:
            del st[k]
        for k, v in snap.items():
            live = st.get(k)
            if (isinstance(v, torch.Tensor) and isinstance(live, torch.Tensor)
                    and live.shape == v.shape and live.dtype == v.dtype):
                with torch.no_grad():
                    live.copy_(v)
            else:
                st[k] = v.clone() if isinstance(v, torch.Tensor) else v


# ----------------------------------------------------------------------
# the guard

class TrainGuard:
    """Host-side orchestrator around a guarded train step.

    ``step_fn(params, batch) -> (loss, aux)`` must be built with
    ``guard=True`` (``make_tp_train_step``, ``make_ddp_step`` or the
    ZeRO builders), or return ``aux = {"ok", "gnorm"}`` by hand; it
    updates ``params`` in place through ``optimizer`` (the optimizer
    holding ``params``' leaves, or ZeRO's state from ``init``)::

        g = TrainGuard(step, params, optimizer)
        for batch in batches:
            loss = g.step(batch)
        g.finish()

    ``.params`` is the live tree and ``.optimizer`` the live optimizer:
    snapshots, rollbacks, repairs and checkpoint restores write into
    them in place.  ``mesh``/``dp_axis``/``rules``: which ranks vote in
    an audit (module docstring).  Rollback semantics: the caller's
    batch stream keeps advancing; the poison batch is never retried.
    """

    def __init__(self, step_fn, params, optimizer, *, mesh=None,
                 dp_axis: str = "dp", rules=None,
                 skip_budget: int | None = None,
                 audit_every: int | None = None,
                 snapshot_every: int | None = None,
                 snapshot_keep: int | None = None,
                 checkpoint_every: int | None = None,
                 checkpoint_path: str | None = None,
                 spike_window: int | None = None,
                 spike_nmad: float | None = None,
                 spike_confirm: int | None = None,
                 quarantine_after: int | None = None,
                 rank: int | None = None, escalate=None,
                 clock=time.monotonic):
        self._fn = step_fn
        self._params = params
        self._optimizer = optimizer
        self._mesh, self._dp_axis = mesh, dp_axis
        self._clock = clock
        self._escalate = escalate
        self._skip_budget = (knobs.get_int("NBD_GUARD_SKIP_BUDGET", 3)
                             if skip_budget is None else int(skip_budget))
        self._audit_every = (knobs.get_int("NBD_GUARD_AUDIT_EVERY", 50)
                             if audit_every is None else int(audit_every))
        self._snapshot_every = (
            knobs.get_int("NBD_GUARD_SNAPSHOT_EVERY", 50)
            if snapshot_every is None else int(snapshot_every))
        keep = (knobs.get_int("NBD_GUARD_SNAPSHOT_KEEP", 2)
                if snapshot_keep is None else int(snapshot_keep))
        self._ckpt_every = (knobs.get_int("NBD_GUARD_CKPT_EVERY", 0)
                            if checkpoint_every is None
                            else int(checkpoint_every))
        self._ckpt_path = (checkpoint_path
                           if checkpoint_path is not None
                           else knobs.get_str("NBD_GUARD_CKPT_PATH"))
        self._quarantine_after = (
            knobs.get_int("NBD_GUARD_QUARANTINE_AFTER", 2)
            if quarantine_after is None else int(quarantine_after))
        self._spike = SpikeDetector(
            window=(knobs.get_int("NBD_GUARD_SPIKE_WINDOW", 64)
                    if spike_window is None else spike_window),
            nmad=(knobs.get_float("NBD_GUARD_SPIKE_NMAD", 8.0)
                  if spike_nmad is None else spike_nmad),
            confirm=(knobs.get_int("NBD_GUARD_SPIKE_CONFIRM", 2)
                     if spike_confirm is None else spike_confirm))
        if self._audit_every and mesh is not None and rules is not None \
                and mesh.size(dp_axis) > 1:
            split = _split_over(params, rules, dp_axis)
            if split:
                raise ValueError(
                    f"audit_every={self._audit_every}: the params are "
                    f"split over {dp_axis!r} ({', '.join(split[:3])}"
                    f"{', ...' if len(split) > 3 else ''}; FSDP), so no "
                    f"rank holds a replica of another's shard and there "
                    f"is nothing to vote among; pass audit_every=0")
        if rank is None:
            try:
                from ..parallel import collectives
                rank = collectives.rank()
            except Exception:
                rank = 0
        self._rank = int(rank)
        # The optimizer's own parameters that are not the tree's leaves
        # (ZeRO's slices): state the snapshots keep too.
        own = {id(t) for t in tree_leaves(params)}
        self._extra = [p for p in _opt_params(_inner(optimizer))
                       if id(p) not in own]
        # Verdicts resolve LAGGED and BATCHED: once 2×lag steps are
        # pending, the oldest are stacked and read back in one transfer.
        # Verdict latency is bounded at 2×lag steps; audits, snapshots
        # and finish() drain the queue anyway.
        self._lag = 25
        self._lock = threading.Lock()
        self._pending: deque[tuple] = deque()
        self._snapshots: deque[tuple] = deque(maxlen=max(1, keep))
        self._events: deque[dict] = deque(maxlen=256)
        self._diverge: dict[int, int] = {}
        self._suspects: tuple[int, ...] = ()
        self._escalated: set[int] = set()
        self._i = 0
        self._skips = 0
        self._skip_streak = 0
        self._audits = 0
        self._mismatches = 0
        self._repairs = 0
        self._rollbacks = 0
        self._spikes = 0
        self._last_audit_step: int | None = None
        self._last_verdict = "none"
        self._ckpt_async = None
        self._snap: dict = {}
        reg = obs_metrics.registry()
        self._m_skips = reg.counter(
            "nbd_guard_skips_total", "guarded steps skipped on "
            "non-finite gradients")
        self._m_audits = reg.counter(
            "nbd_guard_audits_total", "replica-consistency audits run")
        self._m_mismatches = reg.counter(
            "nbd_guard_mismatches_total", "audits that found replica "
            "fingerprint divergence")
        self._m_repairs = reg.counter(
            "nbd_guard_repairs_total", "divergent replicas repaired "
            "(majority re-broadcast or checkpoint restore)")
        self._m_rollbacks = reg.counter(
            "nbd_guard_rollbacks_total", "rollbacks to an in-memory "
            "snapshot (blown skip budget / confirmed loss spike)")
        with self._lock:
            self._publish_locked()
        # Step-0 baseline snapshot: rollback always has a target.
        if self._snapshot_every:
            self._take_snapshot(0)
        global _ACTIVE
        _ACTIVE = self
        flightrec.record("guard_start", rank=self._rank,
                         skip_budget=self._skip_budget,
                         audit_every=self._audit_every,
                         snapshot_every=self._snapshot_every)

    # -- public state --------------------------------------------------

    @property
    def params(self):
        return self._params

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def step_index(self) -> int:
        with self._lock:
            return self._i

    # -- the per-step path ---------------------------------------------

    def step(self, batch):
        """Run one guarded train step; returns the loss.  Chaos
        corruption fires first (so this step's snapshot and audit see
        it as they would see a real SDC), then snapshot / audit /
        durable checkpoint at their cadences, then the step, and only
        then older verdicts resolve, in batched groups.  A rollback in
        that resolution restores the snapshot in place and drops the
        pending entries it makes stale."""
        if not is_enabled():
            out = self._fn(self._params, batch)
            self._i += 1
            return out[0] if isinstance(out, tuple) else out
        # ``self._i`` has one writer (this thread): the cadence gates
        # read it unlocked.
        i = self._i
        if faults.process_plan() is not None:
            self._inject_corruption()
        if i:
            if self._snapshot_every and not i % self._snapshot_every:
                self._maybe_snapshot()
            if self._audit_every and not i % self._audit_every:
                self._maybe_audit()
            if self._ckpt_every and self._ckpt_path \
                    and not i % self._ckpt_every:
                self._maybe_checkpoint()
        out = self._fn(self._params, batch)
        if not (isinstance(out, tuple) and len(out) == 2
                and isinstance(out[1], dict)):
            raise TypeError(
                "TrainGuard needs a guarded step returning (loss, aux) — "
                "build it with guard=True (make_ddp_step / "
                "make_tp_train_step / the zero builders)")
        loss, aux = out
        self._pending.append((self._i, loss, aux))
        self._i += 1
        if len(self._pending) >= 2 * self._lag:
            self._resolve_pending(drain=False)
        return loss

    def finish(self) -> dict:
        """Drain every pending verdict (end of the training loop) and
        return :meth:`describe`."""
        self._resolve_pending(drain=True)
        return self.describe()

    # -- verdict resolution (lagged) ------------------------------------

    def _resolve_pending(self, *, drain: bool) -> None:
        with self._lock:
            n = len(self._pending)
            if not n or (not drain and n < 2 * self._lag):
                return
            take = n if drain else n - self._lag
            batch = [self._pending.popleft() for _ in range(take)]
            # One stack and one transfer for every pending "v" lane.
        packed = [aux["v"] for _, _, aux in batch
                  if aux.get("v") is not None]
        rows = torch.stack(packed).tolist() if packed else []
        ri = 0
        for idx, loss, aux in batch:
            if aux.get("v") is not None:
                okf, lossf, gnorm = rows[ri]
                ri += 1
                rolled = self._after_verdict(idx, bool(okf), float(lossf),
                                             float(gnorm))
            else:
                ok = bool(aux["ok"])
                # gnorm is only flight-recorded on a skip.
                gnorm = float("nan") if ok else float(aux["gnorm"])
                rolled = self._after_verdict(idx, ok, float(loss), gnorm)
            if rolled:
                # A rollback restored older state and cleared the shared
                # pending queue; the rest of this batch predates it.
                return

    def _after_verdict(self, idx: int, ok: bool, loss: float,
                       gnorm: float) -> bool:
        """Apply one resolved verdict; returns True when it triggered a
        rollback (the pending queue was cleared)."""
        if not ok:
            self._m_skips.inc()
            with self._lock:
                self._skips += 1
                self._skip_streak += 1
                streak = self._skip_streak
                # Invalidate speculative snapshots taken after this bad
                # step: the params they hold may carry what made its
                # gradients non-finite.
                dropped = 0
                while self._snapshots and self._snapshots[-1][0] > idx:
                    self._snapshots.pop()
                    dropped += 1
                self._publish_locked()
            if dropped:
                self._event("snapshot_dropped", after=idx, n=dropped)
            flightrec.record("guard_skip", step=idx, gnorm=gnorm,
                             streak=streak)
            self._event("skip", step=idx, streak=streak)
            if self._skip_budget and streak > self._skip_budget:
                self._rollback(f"skip budget blown: {streak} "
                               f"consecutive non-finite steps "
                               f"(budget {self._skip_budget})", step=idx)
                return True
            return False
        with self._lock:
            self._skip_streak = 0
        verdict = self._spike.observe(loss)
        if verdict == "confirmed":
            with self._lock:
                self._spikes += 1
            self._event("spike", step=idx, loss=loss)
            flightrec.record("guard_spike", step=idx, loss=loss)
            self._rollback(f"loss spike confirmed at step {idx} "
                           f"(loss {loss:g})", step=idx)
            return True
        elif verdict == "suspect":
            self._event("spike_suspect", step=idx, loss=loss)
        return False

    # -- snapshots / rollback -------------------------------------------

    def _maybe_snapshot(self) -> None:
        if not self._snapshot_every:
            return
        i = self._i
        if i == 0 or i % self._snapshot_every:
            return
        # Never snapshot mid-skip-streak.  This gate sees only resolved
        # verdicts: the snapshot is taken speculatively, and a pending
        # step that later resolves as a skip drops every snapshot taken
        # after it (:meth:`_after_verdict`).
        with self._lock:
            streak = self._skip_streak
        if streak:
            return
        self._take_snapshot(i)

    def _state(self) -> tuple:
        """Clones of the params, the optimizer's per-parameter state and
        its own parameters outside the tree (ZeRO's slices)."""
        opt = _inner(self._optimizer)
        return ([t.detach().clone() for t in tree_leaves(self._params)],
                [_clone_state(opt.state.get(p, {}))
                 for p in _opt_params(opt)],
                [p.detach().clone() for p in self._extra])

    def _write_state(self, state: tuple) -> None:
        """A :meth:`_state` copied back into the live tensors in place
        (the snapshot stays intact)."""
        params, opt_states, extra = state
        with torch.no_grad():
            for live, v in zip(tree_leaves(self._params), params):
                live.copy_(v)
            for live, v in zip(self._extra, extra):
                live.copy_(v)
        _load_state(_inner(self._optimizer), opt_states)

    def _take_snapshot(self, i: int) -> None:
        state = self._state()
        with self._lock:
            self._snapshots.append((i, state))
        self._event("snapshot", step=i)

    def _rollback(self, reason: str, *, step: int) -> None:
        with self._lock:
            snap = self._snapshots[-1] if self._snapshots else None
            self._pending.clear()
            self._skip_streak = 0
        self._spike.reset_streak()
        if snap is None:
            if self._restore_checkpoint(reason):
                return
            flightrec.record("guard_rollback_unavailable",
                             reason=reason, step=step)
            self._event("rollback_unavailable", step=step, reason=reason)
            return
        idx, state = snap
        self._write_state(state)
        self._m_rollbacks.inc()
        with self._lock:
            self._rollbacks += 1
            self._publish_locked()
        flightrec.record("guard_rollback", reason=reason, frm=step, to=idx)
        self._event("rollback", frm=step, to=idx, reason=reason)

    # -- durable checkpoints --------------------------------------------

    def _ckpt_names(self) -> dict:
        return {"params": self._params,
                "opt_state": _inner(self._optimizer)}

    def _maybe_checkpoint(self) -> None:
        if not self._ckpt_every or not self._ckpt_path:
            return
        with self._lock:
            i = self._i
        if i == 0 or i % self._ckpt_every:
            return
        from ..runtime import checkpoint

        prev = self._ckpt_async
        if prev is not None and not prev.done():
            return  # still draining; this cadence tick is skipped
        if prev is not None:
            self._ckpt_async = None
            try:
                prev.wait(0)
            except Exception as e:  # surfaced, never fatal
                flightrec.record("guard_ckpt_failed", error=str(e)[:200])
                self._event("ckpt_failed", error=str(e)[:200])
        from ..parallel import collectives
        ns = {k: v for k, v in self._ckpt_names().items() if v is not None}
        self._ckpt_async = checkpoint.save_async(
            self._ckpt_path, ns, sorted(ns), rank=self._rank,
            world_size=collectives.world_size())
        self._event("checkpoint", step=i)

    def _restore_checkpoint(self, reason: str) -> bool:
        """The durable checkpoint restored into the live params and
        optimizer in place; False when there is none or it fails."""
        if not self._ckpt_path:
            return False
        from ..runtime import checkpoint

        prev = self._ckpt_async
        if prev is not None:
            try:
                prev.wait()     # a save in flight lands before it is read
            except Exception:
                pass
        ns = {k: v for k, v in self._ckpt_names().items() if v is not None}
        try:
            checkpoint.restore(self._ckpt_path, ns, sorted(ns),
                               rank=self._rank)
            if ns["params"] is not self._params:
                raise ValueError("the checkpoint's params do not fit the "
                                 "live tree")
        except Exception as e:
            flightrec.record("guard_restore_failed", reason=reason,
                             error=str(e)[:200])
            self._event("restore_failed", reason=reason, error=str(e)[:200])
            return False
        self._resync_zero()
        self._m_repairs.inc()
        with self._lock:
            self._repairs += 1
            self._publish_locked()
        flightrec.record("guard_restore", reason=reason,
                         path=self._ckpt_path)
        self._event("restore", reason=reason)
        return True

    def _resync_zero(self) -> None:
        """ZeRO's slices set to this rank's slice of the params (the
        checkpoint holds the params, and the slices' optimizer state)."""
        zero = _zero_state(self._optimizer)
        if zero is None:
            return
        from ..models.transformer import param_leaves
        from ..parallel.mesh import local_slice

        n, me = zero.mesh.size(zero.dp_axis), zero.mesh.index(zero.dp_axis)
        with torch.no_grad():
            for p in param_leaves(self._params):
                d, sl = zero.dims[id(p)], zero.slices[id(p)]
                sl.copy_(p if d is None else local_slice(p, d, n, me))

    # -- replica-consistency audit --------------------------------------

    def _maybe_audit(self) -> None:
        if not self._audit_every:
            return
        with self._lock:
            i = self._i
        if i == 0 or i % self._audit_every:
            return
        self.audit()

    def _group_size(self) -> int:
        if self._mesh is None:
            from ..parallel import collectives
            return collectives.world_size()
        return self._mesh.size(self._dp_axis)

    def _device(self):
        """Where the params live: the device of the mesh collectives'
        small tensors (NCCL takes CUDA tensors only)."""
        return next((t.device for t in tree_leaves(self._params)
                     if isinstance(t, torch.Tensor)), torch.device("cpu"))

    def _gather_rows(self, vec):
        """The group's (n, 4) int32 rows of ``vec``."""
        if self._mesh is None:
            from ..parallel import collectives
            return collectives.all_gather(vec).cpu()
        n = self._mesh.size(self._dp_axis)
        return self._mesh.all_gather(vec.to(self._device()),
                                     self._dp_axis).view(n, 4).cpu()

    def _broadcast(self, t, root: int):
        if self._mesh is None:
            from ..parallel import collectives
            return collectives.broadcast(t, root=root)
        return self._mesh.broadcast(t, self._dp_axis, root)

    def _no_majority_elsewhere(self, verdict: AuditVerdict) -> bool:
        """True when some dp group of the mesh found no majority: the
        flag's pmax over every other axis of the mesh."""
        mesh = self._mesh
        flag = float(not verdict.ok and verdict.majority_rank is None)
        if mesh is None:
            return bool(flag)
        others = [a for a in mesh.axis_names
                  if a != self._dp_axis and mesh.size(a) > 1]
        if not others:
            return bool(flag)
        f = torch.tensor([flag], dtype=torch.float32, device=self._device())
        for a in others:
            f = mesh.pmax(f, a)
        return bool(f.item())

    def audit(self) -> AuditVerdict:
        """Run one replica-consistency audit now.  Collective-aligned
        by construction: every rank reaches it at the same step index
        (the cadence counts steps and rollbacks never rewind it),
        computes the verdict from identical gathered rows, and so issues
        identical repair collectives."""
        self._resolve_pending(drain=True)
        self._m_audits.inc()
        with self._lock:
            self._audits += 1
            i = self._i
        n = self._group_size()
        if n == 1:
            verdict = AuditVerdict(ok=True, majority_rank=None, minority=())
            self._record_audit(i, verdict)
            return verdict
        fa, fb = tree_fingerprint(self._params)
        # Each uint32 lane as two int32-safe half-words.
        vec = torch.tensor([fa >> 16, fa & 0xFFFF, fb >> 16, fb & 0xFFFF],
                           dtype=torch.int32)
        rows = self._gather_rows(vec).tolist()
        fps = [((r[0] << 16) | r[1], (r[2] << 16) | r[3]) for r in rows]
        verdict = vote(fps)
        self._record_audit(i, verdict)
        restore_all = self._no_majority_elsewhere(verdict)
        if verdict.ok and not restore_all:
            return verdict
        fresh: list = []
        if not verdict.ok:
            self._m_mismatches.inc()
            with self._lock:
                self._mismatches += 1
                for r in verdict.minority:
                    self._diverge[r] = self._diverge.get(r, 0) + 1
                suspects = tuple(sorted(
                    r for r, c in self._diverge.items()
                    if c >= self._quarantine_after > 0))
                self._suspects = suspects
                fresh = [r for r in suspects if r not in self._escalated]
                self._escalated.update(fresh)
                self._publish_locked()
            flightrec.record("guard_mismatch", step=i,
                             minority=list(verdict.minority),
                             majority_rank=verdict.majority_rank)
            self._event("mismatch", step=i,
                        minority=list(verdict.minority),
                        majority_rank=verdict.majority_rank)
            if verdict.majority_rank is not None:
                self._repair(verdict)
        if restore_all:
            self._restore_checkpoint(
                f"audit at step {i} found no majority fingerprint "
                f"({len(set(fps))} distinct across {n} ranks)"
                if verdict.majority_rank is None and not verdict.ok
                else f"audit at step {i}: another dp group of the mesh "
                     f"found no majority fingerprint")
        for r in fresh:
            flightrec.record("guard_quarantine_suspect", suspect=r,
                             diverges=self._diverge.get(r))
            self._event("quarantine_suspect", suspect=r)
            if self._escalate is not None:
                try:
                    self._escalate(r, f"rank {r} diverged in "
                                      f"{self._diverge.get(r)} audits")
                except Exception:
                    pass  # advisory: escalation never breaks training
        return verdict

    def _record_audit(self, i: int, verdict: AuditVerdict) -> None:
        if verdict.ok:
            v = "ok"
        elif verdict.majority_rank is not None:
            v = "repair:" + ",".join(str(r) for r in verdict.minority)
        else:
            v = "no-majority"
        with self._lock:
            self._last_audit_step = i
            self._last_verdict = v
            self._publish_locked()
        flightrec.record("guard_audit", step=i, ok=verdict.ok, verdict=v)
        self._event("audit", step=i, verdict=v)

    def _repair(self, verdict: AuditVerdict) -> None:
        """The params, and unless under ZeRO every optimizer tensor and
        step count, broadcast from the majority root into the live
        tensors: the minority's moments were built from gradients of
        its corrupted params.  (The broadcast canonicalizes nothing:
        every rank receives the root's bytes.)"""
        root = verdict.majority_rank
        with torch.no_grad():
            for live in tree_leaves(self._params):
                live.copy_(self._broadcast(live, root))
            if _zero_state(self._optimizer) is None:
                self._repair_optimizer(root)
        self._m_repairs.inc()
        with self._lock:
            self._repairs += 1
            self._skip_streak = 0
            self._publish_locked()
        flightrec.record("guard_repair", root=root,
                         minority=list(verdict.minority))
        self._event("repair", root=root, minority=list(verdict.minority))

    def _repair_optimizer(self, root: int) -> None:
        """Every state tensor broadcast in place, in parameter order and
        sorted keys; the Python numbers (AdamW's step) in one float64
        broadcast."""
        opt = _inner(self._optimizer)
        if opt is None:
            return
        numbers = []
        for p in _opt_params(opt):
            st = opt.state.get(p, {})
            for k in sorted(st):
                v = st[k]
                if isinstance(v, torch.Tensor):
                    v.copy_(self._broadcast(v, root))
                elif isinstance(v, (int, float)):
                    numbers.append((st, k, type(v)))
        if numbers:
            vals = torch.tensor([float(st[k]) for st, k, _ in numbers],
                                dtype=torch.float64, device=self._device())
            got = self._broadcast(vals, root).tolist()
            for (st, k, kind), v in zip(numbers, got):
                st[k] = kind(v)

    # -- chaos -----------------------------------------------------------

    def _inject_corruption(self) -> None:
        plan = faults.process_plan()
        if plan is None or not plan.has_corrupt():
            return
        with self._lock:
            i = self._i
        for spec in plan.corrupt_due(self._rank, i):
            _, leaf = apply_corrupt(self._params, spec, plan.seed)
            plan.note_corrupt(spec, step=i, leaf=leaf)
            self._event("corrupt", step=i, leaf=leaf, mode=spec.mode)

    # -- reporting -------------------------------------------------------

    def _event(self, kind: str, **kw) -> None:
        with self._lock:
            self._events.append({"ts": self._clock(), "kind": kind, **kw})

    def _publish_locked(self) -> None:
        # Atomically rebound snapshot for the heartbeat thread (the
        # `tg` ping field); it never touches the containers above.
        snap = {"sk": self._skips, "as": self._last_audit_step,
                "v": self._last_verdict, "rb": self._rollbacks,
                "rp": self._repairs}
        if self._suspects:
            snap["qr"] = list(self._suspects)
        self._snap = snap

    def describe(self) -> dict:
        with self._lock:
            return {"step": self._i, "skips": self._skips,
                    "skip_streak": self._skip_streak,
                    "skip_budget": self._skip_budget,
                    "audits": self._audits,
                    "mismatches": self._mismatches,
                    "repairs": self._repairs,
                    "rollbacks": self._rollbacks,
                    "spikes": self._spikes,
                    "last_audit_step": self._last_audit_step,
                    "last_verdict": self._last_verdict,
                    "suspects": list(self._suspects),
                    "snapshot_steps": [s[0] for s in self._snapshots],
                    "events": list(self._events)[-8:]}


def _split_over(params, rules, axis: str) -> list[str]:
    """Paths of the leaves whose rule splits a dimension over ``axis``."""
    from ..models.transformer import named_param_leaves
    from ..parallel.mesh import _spec_axes
    from ..parallel.tensor_parallel import _spec_of

    return [path for path, _ in named_param_leaves(params)
            if any(axis in _spec_axes(e)
                   for e in (_spec_of(rules, path) or ()))]


def guard_ddp(loss_fn, optimizer, mesh, params, *, dp_axis: str = "dp",
              **guard_kw) -> TrainGuard:
    """A guarded DDP step (``make_ddp_step(guard=True)``) wrapped in a
    :class:`TrainGuard` voting over ``mesh``'s ``dp_axis``
    (``trainguard.py:996``)."""
    from ..parallel import data_parallel

    step = data_parallel.make_ddp_step(loss_fn, optimizer, mesh,
                                       dp_axis=dp_axis, guard=True)
    return TrainGuard(step, params, optimizer, mesh=mesh, dp_axis=dp_axis,
                      **guard_kw)


# ----------------------------------------------------------------------
# process-level surface (worker heartbeat / the guard request)

_ACTIVE: TrainGuard | None = None
_ENABLED: bool | None = None


def is_enabled() -> bool:
    global _ENABLED
    if _ENABLED is None:
        _ENABLED = knobs.get_bool("NBD_GUARD", True)
    return _ENABLED


def set_enabled(on: bool) -> None:
    """The ``guard`` request's ``on``/``off``: toggles the host-side
    machinery (verdict resolution, audits, snapshots, rollback, chaos
    injection).  The step's finite check is the step's and stays."""
    global _ENABLED
    _ENABLED = bool(on)


def snapshot() -> dict | None:
    """Compact state for the heartbeat ``tg`` field, or None when no
    guard is live in this process.  Reads one atomically rebound dict:
    safe from any thread."""
    g = _ACTIVE
    return g._snap if g is not None else None


def status() -> dict:
    """Full status for the worker's ``guard`` request."""
    g = _ACTIVE
    out: dict = {"enabled": is_enabled(), "active": g is not None}
    if g is not None:
        out.update(g.describe())
    return out


def reset_for_tests() -> None:
    global _ACTIVE, _ENABLED
    _ACTIVE = None
    _ENABLED = None
