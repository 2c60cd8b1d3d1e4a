"""The port's training guard against the JAX package's, on the CPU
(``nbdistributed_tpu_torch/resilience/trainguard.py`` against
``nbdistributed_tpu/resilience/trainguard.py``).

Exact, in both packages on the same numpy inputs: ``leaf_fingerprint``
and ``tree_fingerprint`` (every dtype, sizes below, at and over the
fold's 2^15-word chunk, the ``tiny_config`` tree converted by
``params_from_jax``), ``vote``, ``SpikeDetector``, ``apply_corrupt``
(the same leaf name and the same damaged bytes), and the guard's state
machine driven by the same scripted fake steps
(``tests/unit/test_trainguard.py:182-340``): the same ``describe()``
without timestamps, the same events in order, the same params.  A real
guarded step at ``tiny_config`` skips a NaN step bitwise (params,
moments, step count), and a guarded run with one poisoned step ends
with JAX's counters and its params within 1e-4 relative L2 per leaf
(``tests/test_torch_mesh_train.py``'s AdamW tolerance).

Then the audit on four gloo ranks (``test_torch_mesh_train.py``'s
cluster): a bit flip on rank 1 named, repaired, and leaving every
rank's params and moments bit-identical to the fault-free run's —
independent replicas voting over the world, DDP and ZeRO on ``dp4``
(ZeRO's repair broadcasts the params only), Megatron ``dp2 x tp2``
voting within each dp group (its 2-rank split has no majority, so every
rank restores the durable checkpoint), and FSDP refused.
"""

import ast

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from nbdistributed_tpu.models import transformer as jtf
from nbdistributed_tpu.parallel import data_parallel as jdp
from nbdistributed_tpu.parallel import mesh as jmesh
from nbdistributed_tpu.resilience import faults as jfaults
from nbdistributed_tpu.resilience import trainguard as jtg
from nbdistributed_tpu_torch.models import (AdamW, loss_fn, param_leaves,
                                            params_from_jax, tiny_config)
from nbdistributed_tpu_torch.parallel import make_mesh
from nbdistributed_tpu_torch.parallel.data_parallel import make_ddp_step
from nbdistributed_tpu_torch.resilience import faults as tfaults
from nbdistributed_tpu_torch.resilience import trainguard as ttg
from nbdistributed_tpu_torch.utils.pytree import tree_leaves_with_path
from test_torch_mesh_train import cell, cluster  # noqa: F401

LEAF_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _fresh_guard_state():
    yield
    ttg.reset_for_tests()
    jtg.reset_for_tests()


def _jfp(x):
    return tuple(int(v) for v in np.asarray(jtg.leaf_fingerprint(x)))


def _tfp(x):
    return tuple(ttg.leaf_fingerprint(x).tolist())


def _array(dtype, n, seed=0):
    x = np.random.default_rng(seed).normal(size=n) * 100
    if dtype == "bool":
        return x > 0
    if dtype == "bfloat16":
        return x.astype(ml_dtypes.bfloat16)
    return x.astype(dtype)


def _torch_leaf(a):
    """The tensor holding numpy array ``a``'s values (bf16 by its bits)."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


# ----------------------------------------------------------------------
# fingerprints

@pytest.mark.parametrize("n", [1, 32768, 70001])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int8",
                                   "uint8", "bool", "int32"])
def test_leaf_fingerprint_matches_jax(dtype, n):
    a = _array(dtype, n)
    want = _jfp(jnp.asarray(a))
    assert _tfp(a) == want
    assert _tfp(_torch_leaf(a)) == want


@pytest.mark.parametrize("n", [1, 32768, 70001])
@pytest.mark.parametrize("dtype", ["int64", "float64"])
def test_eight_byte_leaf_fingerprint_matches_jax(dtype, n):
    """JAX holds 8-byte leaves only with x64 on, where its fold's
    ``jnp.sum`` promotes the uint32 lanes to uint64 and the scan
    refuses them: the JAX words come from ``_to_words`` under x64 and
    are folded with x64 off.  The port splits each word low half first,
    as ``bitcast_convert_type`` does."""
    a = _array(dtype, n, seed=1) * 1e6
    with jax.enable_x64(True):
        words = np.asarray(jtg._to_words(jnp.asarray(a)))
    np.testing.assert_array_equal(ttg._to_words(a).numpy(), words)
    want = tuple(int(v) for v in
                 np.asarray(jtg._fold_words(jnp.asarray(words))))
    assert _tfp(a) == want
    assert _tfp(torch.from_numpy(a)) == want


def _flip_bit(arr, bitpos):
    out = arr.copy()
    view = out.view(np.uint8).reshape(-1)
    view[bitpos // 8] ^= np.uint8(1 << (bitpos % 8))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16",
                                   "int32", "uint8", "bool"])
def test_leaf_fingerprint_changes_on_any_single_bit(dtype):
    """``test_trainguard.py:34``: one probed bit in every byte."""
    host = np.asarray(jnp.asarray(np.arange(96) % 7, jnp.dtype(dtype)))
    base = _tfp(host)
    for bitpos in range(0, host.size * host.dtype.itemsize * 8, 8):
        flipped = _flip_bit(host, bitpos)
        assert _tfp(flipped) != base, f"bit {bitpos} ({dtype})"
        assert _tfp(flipped) == _jfp(jnp.asarray(flipped))


def test_tree_fingerprint_matches_jax_on_the_tiny_tree():
    """The ``tiny_config`` tree (fp32 and bf16) converted to the port:
    the same fold; a swapped pair of leaves and the empty tree as JAX
    (``test_trainguard.py:56-70``)."""
    for dtype, tdtype in ((jnp.float32, torch.float32),
                          (jnp.bfloat16, torch.bfloat16)):
        jcfg = jtf.tiny_config(dtype=dtype)
        jtree = jtf.init_params(jax.random.PRNGKey(0), jcfg)
        tree = params_from_jax(jax.tree.map(np.asarray, jtree),
                               tiny_config(dtype=tdtype), device="cpu")
        assert ttg.tree_fingerprint(tree) == jtg.tree_fingerprint(jtree)
        assert (ttg.tree_fingerprint(tree)
                == ttg.tree_fingerprint(jax.tree.map(np.asarray, jtree)))
    a, b = torch.ones(4, 4), torch.zeros(4, 4)
    assert (ttg.tree_fingerprint({"p": a, "q": b})
            != ttg.tree_fingerprint({"p": b, "q": a}))
    assert (ttg.tree_fingerprint({"p": a, "q": b})
            == jtg.tree_fingerprint({"p": jnp.ones((4, 4)),
                                     "q": jnp.zeros((4, 4))}))
    assert ttg.tree_fingerprint({}) == jtg.tree_fingerprint({}) == (0, 0)
    t = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
         "b": torch.ones(8, dtype=torch.bfloat16)}
    assert ttg.tree_fingerprint(t) == ttg.tree_fingerprint(t)


# ----------------------------------------------------------------------
# vote, spikes, corruption

@pytest.mark.parametrize("fps", [
    [(1, 2)] * 4, [(1, 2), (9, 9), (1, 2)], [(1, 2), (9, 9)],
    [(1, 1), (2, 2), (3, 3)], [(5, 5), (1, 2), (1, 2), (1, 2), (7, 7)],
    [(3, 3), (3, 3), (4, 4), (4, 4)]])
def test_vote_matches_jax(fps):
    assert ttg.vote(fps) == ttg.AuditVerdict(**vars(jtg.vote(fps)))


def test_vote_names_the_lowest_majority_rank():
    v = ttg.vote([(9, 9), (1, 2), (1, 2)])
    assert not v.ok and v.majority_rank == 1 and v.minority == (0,)
    with pytest.raises(ValueError):
        ttg.vote([])


def test_spike_detector_matches_jax():
    rng = np.random.default_rng(3)
    losses = list(1 + 0.05 * rng.normal(size=60))
    for i in (20, 21, 35, 50, 51, 52):
        losses[i] = 40.0
    losses[40] = float("nan")
    for kw in ({}, dict(window=8, nmad=3.0, confirm=2, min_history=8),
               dict(window=16, nmad=3.0, confirm=3, min_history=8)):
        a, b = jtg.SpikeDetector(**kw), ttg.SpikeDetector(**kw)
        assert ([a.observe(x) for x in losses]
                == [b.observe(x) for x in losses])


def test_spike_detector_confirms_after_streak():
    """``test_trainguard.py:289``."""
    sd = ttg.SpikeDetector(window=8, nmad=3.0, confirm=2, min_history=8)
    for x in [1.0, 1.1, 0.9, 1.0, 1.05, 0.95, 1.0, 1.0]:
        assert sd.observe(x) == "ok"
    assert sd.observe(50.0) == "suspect"
    assert sd.observe(50.0) == "confirmed"


def _corrupt_trees(dtype):
    rng = np.random.default_rng(2)
    a = rng.normal(size=(8, 8)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    jtree = {"layers": {"w1": jnp.asarray(a, dtype), "w2": jnp.asarray(b)},
             "embed": jnp.asarray(b[:4], dtype)}
    ttree = {"layers": {"w1": _torch_leaf(np.asarray(jtree["layers"]["w1"])),
                        "w2": torch.from_numpy(b.copy())},
             "embed": _torch_leaf(np.asarray(jtree["embed"]))}
    return jtree, ttree


def _bytes(x):
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous()
        return t.view(torch.uint8).numpy().tobytes() if t.ndim else \
            t.reshape(1).view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("spec", [
    dict(name="w1"), dict(name="w1", bits=5), dict(name="*"),
    dict(name="w2", mode="scale", scale=4.0, count=3),
    dict(name="w1", mode="scale", scale=-0.5, count=100)])
def test_apply_corrupt_matches_jax(dtype, spec):
    """The same spec and seed pick the same leaf (named by ``keystr``)
    and give the same damaged bytes; the port writes them into the live
    tensor and leaves every other leaf alone."""
    for seed in (0, 11):
        jtree, ttree = _corrupt_trees(dtype)
        live = ttree["layers"]["w1"]
        before = {k: _bytes(v) for k, v in
                  tree_leaves_with_path(ttree)}
        js = jfaults.CorruptSpec(rank=1, step=3, **spec)
        ts = tfaults.CorruptSpec(rank=1, step=3, **spec)
        jout, jname = jtg.apply_corrupt(jtree, js, seed=seed)
        tout, tname = ttg.apply_corrupt(ttree, ts, seed=seed)
        assert tname == jname and tout is ttree
        assert ttree["layers"]["w1"] is live
        for (jp, jl), (tp, tl) in zip(
                jax.tree_util.tree_flatten_with_path(jout)[0],
                tree_leaves_with_path(tout)):
            assert jax.tree_util.keystr(jp) == tp
            assert _bytes(tl) == _bytes(jl), tp
            if tp != tname:
                assert _bytes(tl) == before[tp]
        assert _bytes(dict(tree_leaves_with_path(tout))[tname]) \
            != before[tname]


def test_apply_corrupt_unknown_leaf_raises():
    with pytest.raises(ValueError, match="no param leaf"):
        ttg.apply_corrupt({"w": torch.zeros(3)},
                          tfaults.CorruptSpec(rank=0, step=1, name="nope"))


# ----------------------------------------------------------------------
# the guard's state machine, one scripted fake step through both

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


class _FakeOpt(torch.optim.Optimizer):
    """An optimizer whose state is one tensor ``m`` a parameter, one
    more each step (``_fake_guard``'s ``{"m": ...}``)."""

    def __init__(self, params):
        super().__init__(params, {})

    @torch.no_grad()
    def step(self):
        for g in self.param_groups:
            for p in g["params"]:
                st = self.state[p]
                if not st:
                    st["m"] = torch.zeros_like(p)
                st["m"] += 1


def _guards(script, lag=0, **kw):
    """The JAX guard over ``test_trainguard.py:182``'s fake step and the
    port's over its in-place counterpart, with the same script."""
    kw.setdefault("audit_every", 0)
    kw.setdefault("snapshot_every", 4)
    kw.setdefault("skip_budget", 2)
    calls = {"j": 0, "t": 0}

    def verdict(who):
        ok, loss = script[min(calls[who], len(script) - 1)]
        calls[who] += 1
        return ok, loss

    def jfn(p, o, batch):
        ok, loss = verdict("j")
        if ok:
            return ({"w": p["w"] + 1.0}, {"m": o["m"] + 1.0},
                    jnp.float32(loss),
                    {"ok": jnp.asarray(True), "gnorm": jnp.float32(1.0)})
        return p, o, jnp.float32(loss), \
            {"ok": jnp.asarray(False), "gnorm": jnp.float32(np.inf)}

    params = {"w": torch.arange(4.0)}
    opt = _FakeOpt([params["w"]])

    def tfn(p, batch):
        ok, loss = verdict("t")
        if ok:
            with torch.no_grad():
                p["w"] += 1.0
            opt.step()
            return torch.tensor(loss), \
                {"ok": torch.tensor(True), "gnorm": torch.tensor(1.0)}
        return torch.tensor(loss), \
            {"ok": torch.tensor(False), "gnorm": torch.tensor(np.inf)}

    j = jtg.TrainGuard(jfn, {"w": jnp.arange(4.0)}, {"m": jnp.zeros(4)},
                       rank=0, clock=_Clock(), **kw)
    t = ttg.TrainGuard(tfn, params, opt, rank=0, clock=_Clock(), **kw)
    j._lag = t._lag = lag
    return j, t


def _same(j, t):
    def plain(d):
        return {**d, "events": [{k: v for k, v in e.items() if k != "ts"}
                                for e in d["events"]]}

    assert plain(t.describe()) == plain(j.describe())
    assert ([{k: v for k, v in e.items() if k != "ts"} for e in t._events]
            == [{k: v for k, v in e.items() if k != "ts"}
                for e in j._events])
    w = t.params["w"]
    np.testing.assert_array_equal(w.numpy(), np.asarray(j.params["w"]))
    m = t.optimizer.state[w]["m"].numpy() if t.optimizer.state.get(w) \
        else np.zeros(4)
    np.testing.assert_array_equal(m, np.asarray(j.opt_state["m"]))


SCRIPTS = {
    # test_trainguard.py:219: a skip keeps the state; a good step ends
    # the streak.
    "skip_preserves_state": ([(True, 1.0)] * 3 + [(False, 1.0)]
                             + [(True, 1.0)], 5, {}, 0),
    # :233: budget 2 blows on the third skip: back to the step-4 snapshot.
    "blown_budget_rolls_back": ([(True, 1.0)] * 5 + [(False, 1.0)], 8, {},
                                0),
    # :249: the step-4 snapshot, taken while step 2's skip is pending,
    # is dropped when it resolves.
    "speculative_snapshot_dropped": ([(True, 1.0), (True, 1.0),
                                      (False, 1.0), (True, 1.0)], 6,
                                     dict(skip_budget=10), 50),
    # :276: finish() drains what the deep lag left pending.
    "finish_drains_pending": ([(False, 1.0)], 4, dict(skip_budget=0), 50),
    # :327: 17 healthy losses fill the baseline, two spikes confirm.
    "spike_rolls_back": ([(True, 1.0)] * 17 + [(True, 99.0)] * 2, 19,
                         dict(skip_budget=0, spike_window=16,
                              spike_nmad=3.0, spike_confirm=2), 0),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_guard_state_machine_matches_jax(name):
    script, steps, kw, lag = SCRIPTS[name]
    j, t = _guards(script, lag=lag, **kw)
    for _ in range(steps):
        j.step(None)
        t.step(None)
    j.finish()
    t.finish()
    _same(j, t)
    d = t.describe()
    if name == "blown_budget_rolls_back":
        assert d["rollbacks"] == 1 and d["skips"] == 3
        assert t.params["w"].tolist() == [4.0, 5.0, 6.0, 7.0]
    if name == "speculative_snapshot_dropped":
        assert [s[0] for s in t._snapshots] == [0]
    if name == "finish_drains_pending":
        assert d["skips"] == 4
    if name == "spike_rolls_back":
        assert d["spikes"] >= 1 and d["rollbacks"] == 1


def test_guard_disabled_passthrough_matches_jax():
    """``test_trainguard.py:263``: with the guard off, nothing resolves."""
    j, t = _guards([(False, 1.0)])
    ttg.set_enabled(False)
    jtg.set_enabled(False)
    try:
        for _ in range(3):
            j.step(None)
            t.step(None)
        assert t.describe()["skips"] == 0 and t.step_index == 3
        _same(j, t)
        assert ttg.status()["enabled"] is False
    finally:
        ttg.set_enabled(True)
        jtg.set_enabled(True)


def test_trainguard_rejects_unguarded_step():
    g = ttg.TrainGuard(lambda p, b: torch.tensor(0.0), {"w": torch.zeros(2)},
                       None, rank=0, audit_every=0, snapshot_every=0)
    with pytest.raises(TypeError, match="guard=True"):
        g.step(None)


def test_snapshot_and_status_surface():
    assert ttg.snapshot() is None and ttg.status() == {"enabled": True,
                                                       "active": False}
    j, t = _guards([(False, 1.0)])
    t.step(None)
    assert ttg.snapshot() == {"sk": 1, "as": None, "v": "none", "rb": 0,
                              "rp": 0}
    st = ttg.status()
    assert st["active"] and st["skips"] == 1 and st["step"] == 1


# ----------------------------------------------------------------------
# a real guarded step

def _real(tree, cfg, jcfg):
    """Both packages' guarded DDP steps on one-device meshes, AdamW, and
    the loss times the batch's ``scale`` (NaN poisons a step)."""
    jm = jmesh.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    opt = optax.adamw(1e-3)
    jp = jax.tree.map(jnp.asarray, tree)
    js = opt.init(jp)
    jstep = jdp.make_ddp_step(
        lambda p, b: jtf.loss_fn(p, b, jcfg) * b["scale"][0], opt, jm,
        guard=True)
    params = params_from_jax(tree, cfg, device="cpu")
    topt = AdamW(param_leaves(params), lr=1e-3)
    tstep = make_ddp_step(
        lambda p, b: loss_fn(p, b, cfg) * b["scale"][0], topt,
        make_mesh({"dp": 1}), guard=True)
    return (jstep, jp, js), (tstep, params, topt)


def _batches(n, poison=None):
    rng = np.random.default_rng(4)
    out = []
    for i in range(n):
        out.append({"tokens": rng.integers(0, 512, (2, 24)).astype(np.int32),
                    "scale": np.full((2,), np.nan if i == poison else 1.0,
                                     np.float32)})
    return out


def _t(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, jtf.init_params(
        jax.random.PRNGKey(0), jtf.tiny_config(dtype=jnp.float32)))


def _live_bytes(params, opt):
    """Every byte of the params and of AdamW's moments, and its step
    counts."""
    return ([_bytes(p) for p in param_leaves(params)],
            [(st["step"], _bytes(st["mu"]), _bytes(st["nu"]))
             for st in (opt.state[p] for p in param_leaves(params))])


def test_real_guarded_step_skips_bitwise(tree):
    """A NaN step leaves the params, AdamW's moments and its step count
    bitwise as they were (``test_trainguard.py:342``)."""
    cfg = tiny_config(dtype=torch.float32)
    _, (step, params, opt) = _real(tree, cfg, jtf.tiny_config(
        dtype=jnp.float32))
    good, bad = (_t(b) for b in _batches(2, poison=1))
    loss, aux = step(params, good)
    assert aux["v"].shape == (3,) and float(aux["v"][0]) == 1.0
    assert float(aux["v"][1]) == pytest.approx(float(loss))
    before = _live_bytes(params, opt)
    assert all(n == 1 for n, _, _ in before[1])
    _, aux = step(params, bad)
    assert float(aux["v"][0]) == 0.0
    assert _live_bytes(params, opt) == before


def test_real_guarded_run_matches_jax(tree):
    """Five guarded steps, the third poisoned: JAX's counters, JAX's
    losses (1e-5) and its params within 1e-4 relative L2 per leaf."""
    jcfg = jtf.tiny_config(dtype=jnp.float32)
    cfg = tiny_config(dtype=torch.float32)
    (jstep, jp, js), (tstep, params, topt) = _real(tree, cfg, jcfg)
    jg = jtg.TrainGuard(jstep, jp, js, rank=0, audit_every=0,
                        snapshot_every=2, skip_budget=2, clock=_Clock())
    tg = ttg.TrainGuard(tstep, params, topt, rank=0, audit_every=0,
                        snapshot_every=2, skip_budget=2, clock=_Clock())
    jl, tl = [], []
    for b in _batches(5, poison=2):
        jl.append(float(jg.step({k: jnp.asarray(v) for k, v in b.items()})))
        tl.append(float(tg.step(_t(b))))
    jd, td = jg.finish(), tg.finish()
    for k in ("step", "skips", "skip_streak", "rollbacks", "repairs",
              "snapshot_steps", "last_verdict"):
        assert td[k] == jd[k], k
    assert td["skips"] == 1
    assert [e["kind"] for e in td["events"]] == \
        [e["kind"] for e in jd["events"]]
    np.testing.assert_allclose([x for i, x in enumerate(tl) if i != 2],
                               [x for i, x in enumerate(jl) if i != 2],
                               rtol=1e-5)
    assert np.isnan(tl[2]) and np.isnan(jl[2])
    for a, b in zip(param_leaves(tg.params),
                    jax.tree.leaves(jg.params)):
        a, b = a.detach().numpy(), np.asarray(b)
        assert np.linalg.norm(a - b) <= LEAF_RTOL * np.linalg.norm(b)


@pytest.mark.parametrize("target", ["snapshot", "checkpoint"])
def test_zero_rollback_restores_the_slices(tree, tmp_path, target):
    """ZeRO keeps the optimizer's own copy of each leaf (its slices).
    Steps 4 and 5 poisoned blow a skip budget of 1 and roll back to the
    step-3 snapshot, or with no snapshot to the step-3 checkpoint: the
    slices must come back with the params, or the next step would update
    the slices of step 3's good update.  The step after the rollback
    gives the params of steps 0-2 and then that step's batch, bitwise."""
    from nbdistributed_tpu_torch.parallel.zero import make_zero1_train_step

    cfg = tiny_config(dtype=torch.float32)
    batches = _batches(7, poison=None)
    for b in batches[4:6]:
        b["scale"] = np.full_like(b["scale"], np.nan)

    def zero_run():
        params = params_from_jax(tree, cfg, device="cpu")
        step, init = make_zero1_train_step(
            lambda p, b: loss_fn(p, b, cfg) * b["scale"][0],
            AdamW(param_leaves(params), lr=1e-3), make_mesh({"dp": 1}),
            None, params, guard=True)
        return params, step, init(params)

    params, step, z = zero_run()
    for i in (0, 1, 2, 6):
        step(params, _t(batches[i]))
    want = [_bytes(p) for p in param_leaves(params)]

    params, step, z = zero_run()
    kw = (dict(snapshot_every=3) if target == "snapshot" else
          dict(snapshot_every=0, checkpoint_every=3,
               checkpoint_path=str(tmp_path / "ck")))
    g = ttg.TrainGuard(step, params, z, rank=0, audit_every=1,
                       skip_budget=1, **kw)
    for b in batches:
        g.step(_t(b))
    d = g.finish()
    assert d["skips"] == 2
    assert (d["rollbacks"], d["repairs"]) == ((1, 0) if target == "snapshot"
                                              else (0, 1))
    assert [_bytes(p) for p in param_leaves(params)] == want
    assert all(_bytes(z.slices[id(p)]) == _bytes(p)
               for p in param_leaves(params))


# ----------------------------------------------------------------------
# the audit on four gloo ranks

# Every rank: ``guard_run(kind, steps, corrupt)`` trains ``tiny_config``
# from seed 0 under a TrainGuard (audit and snapshot every 2 steps) on
# the same global batches, with ``corrupt`` on the process fault plan,
# and reports the params' and the optimizer's fingerprints, the counters,
# the first mismatch and the broadcasts the run made.
GUARD_CELL = """
import torch.distributed as _dist
from nbdistributed_tpu_torch.resilience import faults as _faults
from nbdistributed_tpu_torch.resilience import trainguard as _tg

def guard_run(kind, steps, corrupt=None, ckpt=None):
    cfg = tiny_config(dtype=torch.float32)
    params = init_params(cfg, 0, device="cpu")
    kw = dict(audit_every=2, snapshot_every=2, skip_budget=10)
    if kind == "replicas":
        m = make_mesh({"dp": 1}, ranks=[rank])
        opt = AdamW(param_leaves(params), lr=1e-3)
        step = make_ddp_step(lambda p, b: loss_fn(p, b, cfg), opt, m,
                             guard=True)
        g = _tg.TrainGuard(step, params, opt, **kw)
        state = opt
    elif kind == "ddp":
        m = make_mesh({"dp": 4})
        opt = AdamW(param_leaves(params), lr=1e-3)
        g = _tg.guard_ddp(lambda p, b: loss_fn(p, b, cfg, mesh=m), opt, m,
                          params, **kw)
        state = opt
    elif kind == "zero":
        m = make_mesh({"dp": 4})
        step, init = make_zero1_train_step(
            lambda p, b: loss_fn(p, b, cfg, mesh=m),
            AdamW(param_leaves(params), lr=1e-3), m, None, params,
            guard=True)
        z = init(params)
        g = _tg.TrainGuard(step, params, z, mesh=m, **kw)
        state = z.optimizer
    else:
        m = make_mesh({"dp": 2, "tp": 2})
        rules = param_shardings(cfg)
        params = apply_shardings(params, m, rules)
        opt = AdamW(param_leaves(params), lr=1e-3)
        step = make_tp_train_step(
            lambda p, b: loss_fn(p, b, cfg, mesh=m, rules=rules), opt, m,
            rules, guard=True)
        g = _tg.TrainGuard(step, params, opt, mesh=m, rules=rules,
                           checkpoint_every=2, checkpoint_path=ckpt, **kw)
        state = opt
    _faults.set_process_plan(None if corrupt is None else
                             _faults.FaultPlan(seed=7, corrupt=[corrupt]))
    casts = [0]
    real = _dist.broadcast
    def counted(*a, **k):
        casts[0] += 1
        return real(*a, **k)
    _dist.broadcast = counted
    try:
        rng = np.random.default_rng(9)
        for _ in range(steps):
            b = {"tokens": torch.from_numpy(
                rng.integers(0, cfg.vocab_size, (4, 24)).astype(np.int64))}
            g.step(b if kind == "replicas" else shard_batch(b, m))
        d = g.finish()
    finally:
        _dist.broadcast = real
        _faults.set_process_plan(None)
    mm = [e for e in g._events if e["kind"] == "mismatch"]
    return {"fp": list(_tg.tree_fingerprint(g.params)),
            "opt_fp": list(_tg.tree_fingerprint(state)),
            "mismatches": d["mismatches"], "repairs": d["repairs"],
            "audits": d["audits"], "last_verdict": d["last_verdict"],
            "minority": mm[0]["minority"] if mm else None,
            "majority_rank": mm[0]["majority_rank"] if mm else None,
            "kinds": sorted({e["kind"] for e in g._events}),
            "broadcasts": casts[0], "leaves": len(param_leaves(params))}
"""


def _guard_runs(comm, kind, corrupt, steps=6, ckpt=None):
    cell(comm, GUARD_CELL)
    out = {}
    for name, spec in (("ref", None), ("faulted", corrupt)):
        got = cell(comm, f"guard_run({kind!r}, {steps}, {spec!r}, "
                         f"{ckpt!r})")
        out[name] = {r: ast.literal_eval(v) for r, v in got.items()}
    return out["ref"], out["faulted"]


@pytest.mark.parametrize("kind,corrupt", [
    ("replicas", {"rank": 1, "step": 3, "name": "wq"}),
    ("ddp", {"rank": 1, "step": 4, "name": "w_up"}),
    ("zero", {"rank": 1, "step": 4, "name": "w_up"})])
def test_audit_names_repairs_and_leaves_no_trace(cluster, kind, corrupt):
    """The fault-free run's audits are all ``ok`` and every rank ends
    equal; with the flip, every rank's audit names minority (1,) and
    root 0, one repair, and every rank's params and optimizer state end
    bit-identical to the fault-free run's.  ZeRO's repair broadcasts the
    params only (one broadcast a leaf); the others also broadcast every
    moment and the step counts."""
    ref, got = _guard_runs(cluster, kind, corrupt)
    fp = ref[0]["fp"]
    for r in range(4):
        # ZeRO's moments are each rank's slice: equal to its own only.
        opt_fp = ref[r]["opt_fp"]
        assert ref[r]["fp"] == fp
        assert kind == "zero" or opt_fp == ref[0]["opt_fp"]
        assert ref[r]["mismatches"] == 0 and ref[r]["repairs"] == 0
        assert ref[r]["last_verdict"] == "ok" and ref[r]["audits"] == 2
        assert ref[r]["broadcasts"] == 0
        res = got[r]
        assert res["mismatches"] == 1 and res["repairs"] == 1, (r, res)
        assert res["minority"] == [1] and res["majority_rank"] == 0
        assert res["last_verdict"] == "repair:1"
        assert {"audit", "mismatch", "repair"} <= set(res["kinds"])
        assert res["fp"] == fp, f"rank {r} params differ after the repair"
        assert res["opt_fp"] == opt_fp, f"rank {r} optimizer state differs"
        n = res["leaves"]
        assert res["broadcasts"] == (n if kind == "zero" else 3 * n + 1)
    assert "corrupt" in got[1]["kinds"]
    assert all("corrupt" not in got[r]["kinds"] for r in (0, 2, 3))


def test_megatron_audit_votes_within_each_dp_group(cluster, tmp_path):
    """dp2 x tp2, the flip on rank 1 (tp coordinate 1): ranks 1 and 3
    (its dp group) find no majority in their 2-rank split, ranks 0 and 2
    agree; so every rank of the mesh restores the step-2 checkpoint and
    each dp group ends bit-identical across its ranks."""
    ref, got = _guard_runs(cluster, "mega", {"rank": 1, "step": 3,
                                              "name": "wq"},
                           ckpt=str(tmp_path / "ck"))
    for r in range(4):
        assert ref[r]["last_verdict"] == "ok" and ref[r]["repairs"] == 0
        res = got[r]
        assert "restore" in res["kinds"] and res["repairs"] == 1, (r, res)
        if r in (1, 3):
            assert res["last_verdict"] == "no-majority"
            assert res["minority"] == [0, 1] and res["majority_rank"] is None
        else:
            assert res["last_verdict"] == "ok" and res["mismatches"] == 0
    for a, b in ((0, 2), (1, 3)):
        assert got[a]["fp"] == got[b]["fp"]
        assert got[a]["opt_fp"] == got[b]["opt_fp"]
    assert got[0]["fp"] != ref[0]["fp"]     # the restore went back a step


def test_fsdp_refuses_an_audit(cluster):
    """Params split over dp have no replica to vote against."""
    out = cell(cluster, """
cfg = tiny_config(dtype=torch.float32)
m = make_mesh({"dp": 4})
rules = fsdp_param_shardings(cfg)
p = apply_shardings(init_params(cfg, 0, device="cpu"), m, rules)
opt = AdamW(param_leaves(p), lr=1e-3)
step = make_tp_train_step(lambda pp, b: loss_fn(pp, b, cfg, mesh=m,
                          rules=rules), opt, m, rules, guard=True)
try:
    _tg.TrainGuard(step, p, opt, mesh=m, rules=rules, audit_every=2)
    err = ""
except ValueError as e:
    err = str(e)
_tg.TrainGuard(step, p, opt, mesh=m, rules=rules, audit_every=0,
               snapshot_every=2)
"split over 'dp'" in err and "nothing to vote among" in err""")
    assert set(out.values()) == {"True"}


def test_mesh_of_one_rank_inside_a_world(cluster):
    """``make_mesh(ranks=[rank])`` is JAX's ``make_mesh(devices=...)``
    subset: a one-rank mesh on each rank of the 4-rank world."""
    out = cell(cluster, """
m1 = make_mesh({"dp": 1}, ranks=[rank])
try:
    make_mesh({"dp": 1})
    e1 = ""
except ValueError as e:
    e1 = str(e)
(m1.shape, m1.index("dp"), "needs 1 ranks but 4" in e1)""")
    assert set(out.values()) == {"({'dp': 1}, 0, True)"}
