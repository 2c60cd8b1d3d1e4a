"""The port's training on a mesh against the JAX package's, on the CPU:
a module-scoped 4-rank gloo world of the port's workers, every rank
running the same train step on its rows and its shard, held to the JAX
package's step on 4 of its 8 virtual CPU devices with the same numpy
parameters, batch and mesh, and ``optax.adamw`` against the port's
``AdamW``.

Mirrors ``tests/unit/test_model.py:72,114,143,183,334,340`` (DDP, the
tp step, gradient accumulation and its indivisible raise, FSDP and
HSDP) and ``tests/unit/test_zero.py:24-201`` (ZeRO-1 with and without
rules and with tp, its state layout, ZeRO-2 against plain accumulation,
zero2(1) = zero1), plus a packed-document batch whose dp ranks keep
different target counts and the guarded step's bitwise skip
(``tests/unit/test_trainguard.py:342``).

Tolerances: losses within 1e-5 relative, every leaf after the steps
and every gradient of the first step within 1e-4 relative L2
(gathered from the shards; AdamW's update is blind to a gradient
scaled by a constant, so the gradients are held themselves), as
``tests/test_torch_train.py`` states for AdamW; every rank's losses
equal.
"""

import ast
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from nbdistributed_tpu.models import transformer as jtf
from nbdistributed_tpu.parallel import data_parallel as jdp
from nbdistributed_tpu.parallel import mesh as jmesh
from nbdistributed_tpu.parallel import tensor_parallel as jtp
from nbdistributed_tpu.parallel import zero as jzero
from nbdistributed_tpu_torch.manager import ProcessManager, wait_until_ready
from nbdistributed_tpu_torch.messaging.codec import (flatten_pytree_wire,
                                                     unflatten_pytree_wire)
from nbdistributed_tpu_torch.messaging.coordinator import \
    CommunicationManager
from nbdistributed_tpu_torch.parallel import P
from nbdistributed_tpu_torch.parallel.zero import _add_dp

pytestmark = [pytest.mark.integration]

WORLD = 4
DEVS = jax.devices()[:WORLD]
LR = 1e-3
STEPS = 2
LOSS_RTOL = 1e-5
LEAF_RTOL = 1e-4
JCFG = jtf.tiny_config(dtype=jnp.float32, use_flash=False)


@pytest.fixture(scope="module")
def cluster():
    comm = CommunicationManager(num_workers=WORLD, timeout=120)
    pm = ProcessManager()
    pm.add_death_callback(lambda rank, rc: comm.mark_worker_dead(rank))
    try:
        pm.start_workers(WORLD, comm.port, backend="cpu")
        wait_until_ready(comm, pm, 120, poll_s=0.5)
        cell(comm, SETUP_CELL)
    except Exception:
        pm.shutdown()
        comm.shutdown()
        raise
    yield comm
    comm.post(list(range(WORLD)), "shutdown")
    pm.shutdown()
    comm.shutdown()


# Every rank: the port's names, and each leaf of a tree gathered whole
# from its shards by its rules.
SETUP_CELL = """
torch.set_num_threads(1)
from nbdistributed_tpu_torch.models import *
from nbdistributed_tpu_torch.parallel import *
from nbdistributed_tpu_torch.parallel.mesh import _spec_axes

def spec_at(rules, path):
    node = rules
    for k in path.split("/"):
        if not isinstance(node, dict):
            return None
        node = node.get(k)
    return node

def gather_leaf(x, m, spec):
    for dim, e in enumerate(spec or ()):
        for a in reversed(_spec_axes(e)):
            x = m.all_gather(x.contiguous(), a, dim)
    return x

def gather_tree(tree, m, rules):
    return {path: gather_leaf(t.detach(), m, spec_at(rules, path)).numpy()
            for path, t in named_param_leaves(tree)}

# AdamW keeping the gradients it is given on its first step, by id of
# their leaf.
class Grab(AdamW):
    def step(self):
        if not hasattr(self, "grads"):
            self.grads = {id(p): p.grad.detach().clone()
                          for g in self.param_groups for p in g["params"]}
        return super().step()

# The gradients the first step gave the optimizer, gathered whole from
# the shards (ZeRO's dp slices first, then the rules' split).
def first_grads(tree, opt, m, rules, z=None):
    out = {}
    for path, t in named_param_leaves(tree):
        if z is None:
            g = opt.grads[id(t)]
        else:
            g = z.optimizer.grads[id(z.slices[id(t)])]
            if z.dims[id(t)] is not None:
                g = m.all_gather(g.contiguous(), z.dp_axis, z.dims[id(t)])
        out[path] = gather_leaf(g, m, spec_at(rules, path)).float().numpy()
    return out

def as_batch(b):
    return {k: torch.tensor(np.array(v)) for k, v in b.items()}
"""


def cell(comm, code):
    """Run ``code`` on every rank; {rank: echoed output} (errors fail)."""
    r = comm.send_to_all("execute", code, timeout=120)
    errs = {k: (m.data["error"], m.data.get("traceback"))
            for k, m in r.items() if "error" in m.data}
    assert not errs, errs
    return {k: m.data.get("output") for k, m in r.items()}


def every_rank(comm, code):
    """The value of ``code``'s last expression, equal on every rank."""
    out = {r: ast.literal_eval(o) for r, o in cell(comm, code).items()}
    assert all(v == out[0] for v in out.values()), out
    return out[0]


def push(comm, name, tree):
    meta, bufs = flatten_pytree_wire(tree)
    r = comm.send_to_all("set_var", {"name": name, "pytree": meta},
                         bufs=bufs)
    assert all(m.data.get("status") == "set" for m in r.values())


def pull0(comm, name):
    """``name`` from rank 0, its leaves as numpy arrays."""
    m = comm.send_to_ranks([0], "get_var", name)[0]
    return jax.tree.map(np.asarray, unflatten_pytree_wire(
        m.data["pytree"], m.bufs))


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def flat(tree, prefix=""):
    """{path: numpy leaf} in sorted-key order (the port's
    ``named_param_leaves``)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {f"{prefix}{k}": np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def tree(cluster):
    t = jax.tree.map(np.asarray, jtf.init_params(jax.random.PRNGKey(0),
                                                 JCFG))
    push(cluster, "tree", t)
    cell(cluster, "cfg = tiny_config(dtype=torch.float32)")
    return t


def _tokens(seed=1, shape=(8, 17)):
    return np.asarray(np.random.default_rng(seed).integers(
        0, JCFG.vocab_size, shape), np.int32)


def packed_batch(B=8, S=17, seed=5):
    """Packed documents, row r holding r + 1 of them at random
    boundaries: each dp rank's rows keep a different number of
    targets."""
    rng = np.random.default_rng(seed)
    segs = np.stack([np.sort(rng.integers(0, r + 1, S)) for r in range(B)])
    return {"tokens": _tokens(seed, (B, S)),
            "segments": np.asarray(segs, np.int32)}


# Port side: the step built on the mesh, STEPS steps on this rank's rows,
# the losses, the tree and the first step's gradients gathered whole.
PORT_RUN = """
m = make_mesh({sizes!r})
dp = {dp!r}
rules = {rules}
p = params_from_jax(tree, cfg, device="cpu")
p = apply_shardings(p, m, rules) if rules is not None else p
opt = Grab(param_leaves(p), {lr})
loss = lambda pp, b: loss_fn(pp, b, cfg, mesh=m, rules=rules, dp_axis=dp)
z = None
{make}
b = as_batch(batch)
b = shard_batch(b, m, dp) if dp in m.shape else b
losses = [float(step(p, b)) for _ in range({steps})]
final = gather_tree(p, m, rules)
grads = first_grads(p, opt, m, rules, z)
losses"""

RULES = {None: "None", "mega": "param_shardings(cfg)",
         "fsdp": "fsdp_param_shardings(cfg)",
         "hsdp": "fsdp_param_shardings(cfg, tp_axis='tp')"}
JRULES = {None: lambda c: None, "mega": jtf.param_shardings,
          "fsdp": jtf.fsdp_param_shardings,
          "hsdp": lambda c: jtf.fsdp_param_shardings(c, tp_axis="tp")}


def port_run(cluster, batch, sizes, rules=None, make="step = "
             "make_tp_train_step(loss, opt, m, rules, dp_axis=dp)",
             dp="dp"):
    push(cluster, "batch", batch)
    losses = every_rank(cluster, PORT_RUN.format(
        sizes=sizes, dp=dp, rules=RULES[rules], lr=LR, make=make,
        steps=STEPS))
    return losses, pull0(cluster, "final"), pull0(cluster, "grads")


def jax_run(jtree, batch, sizes, rules=None, accum=1, zero=False,
            loss=None):
    """The JAX package's step on the same mesh of its virtual devices:
    STEPS steps, the losses, the final tree and the first step's
    gradients."""
    jm = jmesh.make_mesh(sizes, devices=DEVS[:math.prod(sizes.values())])
    opt = optax.chain(grab(), optax.adamw(LR))
    loss = loss or (lambda p, b: jtf.loss_fn(p, b, JCFG))
    r = JRULES[rules](JCFG)
    params = jax.tree.map(jnp.asarray, jtree)
    p = (jtp.apply_shardings(params, jm, r) if r is not None
         else jax.device_put(params, NamedSharding(jm, JP())))
    if zero:
        step, init = jzero.make_zero2_train_step(
            loss, opt, jm, r, params, accum_steps=accum, donate=False)
        s = init(p)
    else:
        step = jtp.make_tp_train_step(loss, opt, jm, r, donate=False,
                                      accum_steps=accum)
        s = opt.init(p)
    b = jmesh.shard_batch(jax.tree.map(jnp.asarray, batch), jm)
    losses = []
    for i in range(STEPS):
        p, s, lval = step(p, s, b)
        losses.append(float(lval))
        grads = flat(s[0]) if i == 0 else grads
    return losses, flat(p), grads


def grab():
    """An optax stage passing the gradients on and keeping them as its
    state: in ``optax.chain(grab(), opt)`` the state's first entry holds
    the last step's gradients, sharded as the params are."""
    return optax.GradientTransformation(
        optax.tree_utils.tree_zeros_like, lambda g, s, p=None: (g, g))


def check(got, want):
    """Losses, every leaf after the steps and every gradient of the
    first step: ``(losses, leaves, grads)`` against the same."""
    (gl, gp, gg), (wl, wp, wg) = got, want
    np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL)
    for g, w in ((gp, wp), (gg, wg)):
        assert sorted(g) == sorted(w)
        worst = {k: rel_l2(g[k], w[k]) for k in w}
        assert max(worst.values()) <= LEAF_RTOL, worst


def test_ddp_matches_jax(cluster, tree):
    """``test_model.py:72``: DDP over dp=4, the gradient the mean over
    dp: the JAX DDP step's losses and tree."""
    batch = {"tokens": _tokens()}
    got = port_run(cluster, batch, {"dp": 4},
                   make="step = make_ddp_step(loss, opt, m)")
    check(got, jax_run(tree, batch, {"dp": 4}))


@pytest.mark.parametrize("sizes", [{"dp": 2, "tp": 2}, {"dp": 1, "tp": 4}],
                         ids=str)
def test_tp_train_step_matches_jax(cluster, tree, sizes):
    """``test_model.py:114``: Megatron rules on dp2 x tp2 (two heads of
    four and one KV head of two per rank, straight to the kernel) and
    on tp4, where ``tiny_config``'s 2 KV heads do not divide: q, k and
    v gathered over tp, attention on every head on every rank."""
    batch = {"tokens": _tokens()}
    check(port_run(cluster, batch, sizes, "mega"),
          jax_run(tree, batch, sizes, "mega"))


def test_gradient_accumulation_matches_jax(cluster, tree):
    """``test_model.py:143``: accum_steps=2 on dp2 x tp2, microbatch i
    the i-th chunk of each dp rank's rows: JAX's accumulated step."""
    batch = {"tokens": _tokens()}
    got = port_run(cluster, batch, {"dp": 2, "tp": 2}, "mega",
                   make="step = make_tp_train_step(loss, opt, m, rules, "
                        "accum_steps=2)")
    check(got, jax_run(tree, batch, {"dp": 2, "tp": 2}, "mega", accum=2))


def test_gradient_accumulation_rejects_indivisible(cluster, tree):
    """``test_model.py:183``: 8 rows on dp2 do not split into 3
    microbatches per rank; the port raises JAX's message."""
    push(cluster, "batch", {"tokens": _tokens(shape=(8, 17))})
    msg = every_rank(cluster, """
m = make_mesh({"dp": 2, "tp": 2})
p = params_from_jax(tree, cfg, device="cpu")
step = make_tp_train_step(lambda pp, b: loss_fn(pp, b, cfg, mesh=m), AdamW(
    param_leaves(p), 1e-3), m, None, accum_steps=3)
try:
    step(p, shard_batch(as_batch(batch), m))
    msg = ""
except ValueError as e:
    msg = str(e)
msg""")
    assert msg == "batch leading dim 8 not divisible by dp(2) * " \
                  "accum_steps(3)"
    jm = jmesh.make_mesh({"dp": 2}, devices=DEVS[:2])
    jstep = jtp.make_tp_train_step(lambda p, b: jtf.loss_fn(p, b, JCFG),
                                   optax.sgd(1e-3), jm, None, donate=False,
                                   accum_steps=3)
    p = jax.device_put(jax.tree.map(jnp.asarray, tree),
                       NamedSharding(jm, JP()))
    with pytest.raises(ValueError, match="not divisible") as e:
        jstep(p, optax.sgd(1e-3).init(p), jmesh.shard_batch(
            {"tokens": jnp.zeros((8, 17), jnp.int32)}, jm))
    assert str(e.value) == msg


@pytest.mark.parametrize("rules,sizes", [("fsdp", {"dp": 4}),
                                         ("hsdp", {"dp": 2, "tp": 2})],
                         ids=["fsdp_dp4", "hsdp_dp2_tp2"])
def test_fsdp_and_hsdp_match_jax(cluster, tree, rules, sizes):
    """``test_model.py:334,340``: the weights split over dp (each layer
    gathered before use, the gradients reduce-scattered), and with tp on
    the other axis: JAX's step on the same rules."""
    batch = {"tokens": _tokens(seed=3, shape=(4, 16))}
    check(port_run(cluster, batch, sizes, rules),
          jax_run(tree, batch, sizes, rules))


@pytest.mark.parametrize("dp", ["dp", "data"])
def test_packed_documents_on_dp_match_jax(cluster, tree, dp):
    """A packed batch whose dp ranks keep different target counts: the
    loss is the mean over every kept target of the batch, not the mean
    of the ranks' means; the same with the data axis named ``data``
    (the loss and the step given ``dp_axis``)."""
    batch = packed_batch()
    seg = batch["segments"]
    kept = (seg[:, :-1] == seg[:, 1:]).reshape(4, -1).sum(axis=1)
    assert len(set(kept.tolist())) > 1, kept
    check(port_run(cluster, batch, {dp: 4}, dp=dp),
          jax_run(tree, batch, {"dp": 4}))


@pytest.mark.parametrize("rules,sizes", [(None, {"dp": 4}),
                                         ("mega", {"dp": 2, "tp": 2})],
                         ids=["rules_none_dp4", "mega_dp2_tp2"])
def test_zero1_matches_jax(cluster, tree, rules, sizes):
    """``test_zero.py:44,87,102``: ZeRO-1 on dp4 with ``rules=None`` and
    composed with tp: JAX's ZeRO-1 losses and tree; each moment shard is
    the leaf's ``_add_dp`` slice (a quarter of every leaf on dp4; on
    dp2 x tp2 a tp-split leaf's moments split over both axes)."""
    batch = {"tokens": _tokens()}
    got = port_run(cluster, batch, sizes, rules, make=(
        "step, init = make_zero1_train_step(loss, opt, m, rules, p)\n"
        "z = init(p)"))
    check(got, jax_run(tree, batch, sizes, rules, zero=True))
    moments = every_rank(cluster, """
{path: [list(t.shape), list(z.moments(t)["mu"].shape),
        list(z.moments(t)["nu"].shape)]
 for path, t in named_param_leaves(p)}""")
    n_dp = sizes["dp"]
    jrules = JRULES[rules](JCFG)
    for path, (local, mu, nu) in moments.items():
        assert mu == nu
        spec = flat_rules(jrules).get(path) if jrules else None
        want = _add_dp(P(*(spec or ())), local, "dp", n_dp)
        d = [i for i, e in enumerate(want) if e == "dp"]
        assert mu == [n // n_dp if i in d else n
                      for i, n in enumerate(local)], (path, want)
        if rules is None:
            assert math.prod(mu) * n_dp == math.prod(local), path


def flat_rules(rules, prefix=""):
    out = {}
    for k in sorted(rules):
        v = rules[k]
        out.update(flat_rules(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {f"{prefix}{k}": tuple(v)})
    return out


def test_zero2_matches_plain_accumulation_and_jax(cluster, tree):
    """``test_zero.py:131,180``: ZeRO-2 (accum_steps=2, the fp32
    accumulator's dp slices reduce-scattered every microbatch) equals the
    plain accumulated step, JAX's ZeRO-2, and the plain step given the
    same ``accum_rules``; zero2(accum_steps=1) is zero1 exactly."""
    batch = {"tokens": _tokens()}
    z2 = port_run(cluster, batch, {"dp": 4}, make=(
        "step, init = make_zero2_train_step(loss, opt, m, rules, p, "
        "accum_steps=2)\nz = init(p)"))
    plain = port_run(cluster, batch, {"dp": 4}, make=(
        "step = make_tp_train_step(loss, opt, m, rules, accum_steps=2)"))
    check(z2, plain)
    check(z2, jax_run(tree, batch, {"dp": 4}, accum=2, zero=True))
    # The sharded accumulator without ZeRO's state: gathered back whole
    # for the optimizer, the same step.
    check(port_run(cluster, batch, {"dp": 4}, make=(
        "step = make_tp_train_step(loss, opt, m, rules, accum_steps=2, "
        "accum_rules=zero2_accum_rules(p, rules, m))")), plain)
    one = port_run(cluster, batch, {"dp": 4}, make=(
        "step, init = make_zero2_train_step(loss, opt, m, rules, p, "
        "accum_steps=1)\nz = init(p)"))
    z1 = port_run(cluster, batch, {"dp": 4}, make=(
        "step, init = make_zero1_train_step(loss, opt, m, rules, p)\n"
        "z = init(p)"))
    assert one[0] == z1[0]
    assert all(np.array_equal(one[1][k], z1[1][k]) for k in z1[1])
    assert all(np.array_equal(one[2][k], z1[2][k]) for k in z1[2])
    msg = every_rank(cluster, """
try:
    make_zero2_train_step(loss, opt, m, None, p, accum_steps=0)
    msg = ""
except ValueError as e:
    msg = str(e)
msg""")
    assert "accum_steps" in msg


def test_guarded_step_skips_bitwise_and_v_matches_jax(cluster):
    """``test_trainguard.py:342``: a guarded DDP step on dp4 — a good
    batch updates and packs ``v = [ok, loss, gnorm]`` as JAX does; a
    batch with a NaN on one rank's rows leaves the params, the moments
    and the step count bitwise as they were, ``v[0] = 0``."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(8, 4)).astype(np.float32)
    x = rng.normal(size=(8, 8)).astype(np.float32)
    y = rng.normal(size=(8, 4)).astype(np.float32)
    bad = x.copy()
    bad[5, 3] = np.nan
    push(cluster, "gin", {"w": w, "x": x, "y": y, "bad": bad})
    out = every_rank(cluster, """
m = make_mesh({"dp": 4})
params = {"w": torch.tensor(np.array(gin["w"]))}
opt = AdamW(param_leaves(params), 1e-2)
step = make_ddp_step(lambda p, b: ((b["x"] @ p["w"] - b["y"]) ** 2).mean(),
                     opt, m, guard=True)
good = shard_batch({"x": torch.tensor(np.array(gin["x"])),
                    "y": torch.tensor(np.array(gin["y"]))}, m)
badb = shard_batch({"x": torch.tensor(np.array(gin["bad"])),
                    "y": torch.tensor(np.array(gin["y"]))}, m)
l1, a1 = step(params, good)
st = opt.state[params["w"]]
before = [params["w"].clone(), st["mu"].clone(), st["nu"].clone(),
          st["step"]]
l2, a2 = step(params, badb)
after = [params["w"], st["mu"], st["nu"], st["step"]]
same = all(torch.equal(a, b) for a, b in zip(before[:3], after[:3])) \\
    and before[3] == after[3] == 1
(a1["v"].tolist(), float(a2["v"][0]), same)""")
    v_good, ok_bad, same = out
    assert ok_bad == 0.0 and same
    jm = jmesh.make_mesh({"dp": 4}, devices=DEVS)
    opt = optax.adamw(1e-2)
    jstep = jdp.make_ddp_step(
        lambda p, b: jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2), opt, jm,
        donate=False, guard=True)
    p = jax.device_put({"w": jnp.asarray(w)}, NamedSharding(jm, JP()))
    _, _, _, aux = jstep(p, opt.init(p), jmesh.shard_batch(
        {"x": jnp.asarray(x), "y": jnp.asarray(y)}, jm))
    want = np.asarray(aux["v"])
    assert v_good[0] == want[0] == 1.0
    np.testing.assert_allclose(v_good[1:], want[1:], rtol=1e-5)


def test_fsdp_rules_and_add_dp_match_jax():
    """``fsdp_param_shardings`` (dp alone and HSDP) and ``_add_dp``
    (``test_zero.py:24``) give the JAX package's specs."""
    from nbdistributed_tpu_torch.models import fsdp_param_shardings, \
        tiny_config
    cfg = tiny_config()
    for kw in ({}, {"tp_axis": "tp"}):
        assert flat_rules(fsdp_param_shardings(cfg, **kw)) == \
            flat_rules(jtf.fsdp_param_shardings(JCFG, **kw))
    for spec, shape in ((P(), (8, 6)), (P(), (6, 8)), (P(None, "tp"), (8, 16)),
                        (P("tp"), (8, 16)), (P(), (3, 5)), (P(), ())):
        assert tuple(_add_dp(spec, shape, "dp", 4)) == tuple(
            jzero._add_dp(JP(*spec), shape, "dp", 4))
