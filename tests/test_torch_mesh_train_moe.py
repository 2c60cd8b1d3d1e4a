"""The port's MoE and LoRA training on a mesh against the JAX package's,
on the CPU: a module-scoped 4-rank gloo world of the port's workers held
to the JAX package on 4 of its 8 virtual CPU devices, with the same
numpy parameters, batch and mesh and ``optax.adamw`` against the port's
``AdamW``.

Mirrors ``tests/unit/test_expert.py:280`` (the MoE model training on
dp2 x ep2, in each of the three dispatch modes, and Mixtral-style
attention over tp2 beside ep2) and ``tests/unit/test_lora.py:100,201``
(LoRA on tp4, MoE LoRA on dp x ep), and the ``lora_shardings`` rules.

Tolerances: losses within 1e-5 relative, every leaf after the steps
and every gradient of the first step within 1e-4 relative L2
(gathered from the shards; AdamW's update is blind to a gradient
scaled by a constant, so the gradients are held themselves); every
rank's losses equal.
"""

import ast
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from nbdistributed_tpu.models import lora as jlora
from nbdistributed_tpu.models import moe as jmoe
from nbdistributed_tpu.models import transformer as jtf
from nbdistributed_tpu.parallel import mesh as jmesh
from nbdistributed_tpu.parallel.tensor_parallel import apply_shardings as jput
from nbdistributed_tpu_torch.manager import ProcessManager, wait_until_ready
from nbdistributed_tpu_torch.messaging.codec import (flatten_pytree_wire,
                                                     unflatten_pytree_wire)
from nbdistributed_tpu_torch.messaging.coordinator import \
    CommunicationManager

pytestmark = [pytest.mark.integration]

WORLD = 4
DEVS = jax.devices()[:WORLD]
LR = 1e-3
STEPS = 2
LOSS_RTOL = 1e-5
LEAF_RTOL = 1e-4
# Capacity factor 1: the dense and sparse modes drop tokens and the
# dropless mode's shard capacity binds, so the routing is exercised.
JMCFG = jmoe.tiny_moe_config(dtype=jnp.float32, use_flash=False,
                             capacity_factor=1.0)
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


SETUP_CELL = """
torch.set_num_threads(1)
import dataclasses
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

mcfg = tiny_moe_config(dtype=torch.float32, capacity_factor=1.0)
cfg = tiny_config(dtype=torch.float32)
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
    m = comm.send_to_ranks([0], "get_var", name)[0]
    return jax.tree.map(np.asarray, unflatten_pytree_wire(
        m.data["pytree"], m.bufs))


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {f"{prefix}{k}": np.asarray(v)})
    return out


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


def _tokens(shape, seed=1):
    return np.asarray(np.random.default_rng(seed).integers(0, 512, shape),
                      np.int32)


@pytest.fixture(scope="module")
def moe_tree(cluster):
    t = jax.tree.map(np.asarray,
                     jmoe.init_moe_model(jax.random.PRNGKey(0), JMCFG))
    push(cluster, "mtree", t)
    return t


def jax_moe_run(jtree, cfg, sizes, tokens, tp_axis):
    """``test_expert.py:280``'s step: ``moe_loss_fn`` on the mesh under
    jit, optax.adamw; STEPS steps, the losses, the final tree and the
    first step's gradients."""
    jm = jmesh.make_mesh(sizes, devices=DEVS)
    p = jput(jax.tree.map(jnp.asarray, jtree), jm,
             jmoe.moe_model_shardings(cfg, tp_axis=tp_axis))
    opt = optax.chain(grab(), optax.adamw(LR))
    s = opt.init(p)
    batch = {"tokens": jnp.asarray(tokens)}
    if "dp" in sizes:
        batch = jmesh.shard_batch(batch, jm)

    @jax.jit
    def step(p, s, b):
        lval, g = jax.value_and_grad(
            lambda q: jmoe.moe_loss_fn(q, b, cfg, mesh=jm))(p)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, lval

    losses = []
    for i in range(STEPS):
        p, s, lval = step(p, s, batch)
        losses.append(float(lval))
        grads = flat(s[0]) if i == 0 else grads
    return losses, flat(p), grads


MOE_RUN = """
m = make_mesh({sizes!r})
c = dataclasses.replace(mcfg, moe_dispatch={mode!r})
rules = moe_model_shardings(c, ep_axis={ep!r}, tp_axis={tp!r})
p = apply_shardings(params_from_jax(mtree, c, device="cpu"), m, rules)
opt = Grab(param_leaves(p), {lr})
step = make_tp_train_step(lambda pp, b: moe_loss_fn(
    pp, b, c, mesh=m, rules=rules, ep_axis={ep!r}), opt, m, rules)
b = {{"tokens": torch.tensor(np.array(tokens))}}
b = shard_batch(b, m) if "dp" in m.shape else b
losses = [float(step(p, b)) for _ in range({steps})]
final = gather_tree(p, m, rules)
grads = first_grads(p, opt, m, rules)
losses"""


@pytest.mark.parametrize("mode", ["dense", "sparse", "dropless"])
def test_moe_training_on_dp_ep_matches_jax(cluster, moe_tree, mode):
    """``test_expert.py:280``: the MoE model on dp2 x ep2 at capacity
    factor 1 — the experts split over ep (``f`` on the gates and the
    expert inputs, ``g`` on the combine), the aux loss over every dp
    block, dense and sparse routing the whole batch, dropless each dp
    block at its shard capacity: JAX's losses and tree."""
    tokens = _tokens((4, 16))
    push(cluster, "tokens", tokens)
    sizes = {"dp": 2, "ep": 2}
    losses = every_rank(cluster, MOE_RUN.format(
        sizes=sizes, mode=mode, tp=None, ep="ep", lr=LR, steps=STEPS))
    cfg = dataclasses.replace(JMCFG, moe_dispatch=mode)
    check((losses, pull0(cluster, "final"), pull0(cluster, "grads")),
          jax_moe_run(moe_tree, cfg, sizes, tokens, None))


@pytest.mark.parametrize("ep", ["ep", "expert"])
def test_moe_attention_on_tp_ep_matches_jax(cluster, moe_tree, ep):
    """Mixtral-style attention over tp2 (Megatron rules: two heads of
    four and one KV head of two per rank) beside the experts over ep2:
    JAX's losses and tree; the same with the expert axis named
    ``expert`` (the rules and the loss given ``ep_axis``)."""
    tokens = _tokens((2, 16), seed=2)
    push(cluster, "tokens", tokens)
    losses = every_rank(cluster, MOE_RUN.format(
        sizes={"tp": 2, ep: 2}, mode="dense", tp="tp", ep=ep, lr=LR,
        steps=STEPS))
    sizes = {"tp": 2, "ep": 2}
    check((losses, pull0(cluster, "final"), pull0(cluster, "grads")),
          jax_moe_run(moe_tree, JMCFG, sizes, tokens, "tp"))


LORA_RUN = """
m = make_mesh({sizes!r})
c = {cfg}
rules = {rules}
lrules = {lrules}
base = params_from_jax({tree}, c, device="cpu")
base = apply_shardings(base, m, rules) if rules is not None else base
ad = lora_from_jax(lora, device="cpu")
ad = apply_shardings(ad, m, lrules) if lrules is not None else ad
opt = Grab(param_leaves(ad), {lr})
step = make_lora_train_step(c, opt, mesh=m)
b = {{"tokens": torch.tensor(np.array(tokens))}}
b = shard_batch(b, m) if "dp" in m.shape else b
losses = [float(step(base, ad, b)) for _ in range({steps})]
final = gather_tree(ad, m, lrules)
grads = first_grads(ad, opt, m, lrules)
losses"""


def _jax_lora(cfg, params, lora, tokens, jm, pshard, lshard):
    opt = optax.chain(grab(), optax.adamw(LR))
    if pshard is not None:
        params = jput(params, jm, pshard)
    if lshard is not None:
        lora = jput(lora, jm, lshard)
    batch = {"tokens": jnp.asarray(tokens)}
    if "dp" in jm.shape and jm.shape["dp"] > 1:
        batch = jmesh.shard_batch(batch, jm)
    step = jax.jit(jlora.make_lora_train_step(
        cfg, opt, mesh=jm if isinstance(cfg, jmoe.MoEConfig) else None))
    s, losses = opt.init(lora), []
    for i in range(STEPS):
        lora, s, lval = step(params, lora, s, batch)
        losses.append(float(lval))
        grads = flat(s[0]) if i == 0 else grads
    return losses, flat(lora), grads


def test_lora_on_tp4_matches_jax(cluster):
    """``test_lora.py:100``: every linear adapted (rank 4, b drawn
    nonzero so the step moves both factors) on tp4 by
    ``lora_shardings``: a column-split target's ``b`` split with it and
    its ``a`` through ``f``, a row-split target's ``a`` split and its
    ``b`` through ``f``: JAX's losses and adapters."""
    params = jtf.init_params(jax.random.PRNGKey(0), JCFG)
    lora = jlora.lora_init(jax.random.PRNGKey(7), JCFG, rank=4,
                           targets=jlora.ALL_TARGETS)
    lora = jax.tree.map(lambda x: x + 0.05 * jax.random.normal(
        jax.random.PRNGKey(8), x.shape), lora)
    tokens = _tokens((2, 16), seed=3)
    push(cluster, "dtree", jax.tree.map(np.asarray, params))
    push(cluster, "lora", jax.tree.map(np.asarray, lora))
    push(cluster, "tokens", tokens)
    sizes = {"dp": 1, "tp": 4}
    losses = every_rank(cluster, LORA_RUN.format(
        sizes=sizes, cfg="cfg", rules="param_shardings(c)",
        lrules="lora_shardings(c, lora)", tree="dtree", lr=LR,
        steps=STEPS))
    jm = jmesh.make_mesh(sizes, devices=DEVS)
    want = _jax_lora(JCFG, params, lora, tokens, jm,
                     jtf.param_shardings(JCFG),
                     jlora.lora_shardings(JCFG, lora))
    check((losses, pull0(cluster, "final"), pull0(cluster, "grads")),
          want)


def test_moe_lora_on_dp_ep_matches_jax(cluster, moe_tree):
    """``test_lora.py:201``: attention adapters on the MoE model over
    dp2 x ep2 (experts split over ep, adapters whole, their gradients
    averaged over dp): JAX's losses and adapters."""
    lora = jlora.lora_init(jax.random.PRNGKey(2), JMCFG, rank=4)
    tokens = _tokens((4, 16), seed=4)
    push(cluster, "lora", jax.tree.map(np.asarray, lora))
    push(cluster, "tokens", tokens)
    sizes = {"dp": 2, "ep": 2}
    losses = every_rank(cluster, LORA_RUN.format(
        sizes=sizes, cfg="mcfg", rules="moe_model_shardings(c, tp_axis=None)",
        lrules="None", tree="mtree", lr=LR, steps=STEPS))
    jm = jmesh.make_mesh(sizes, devices=DEVS)
    want = _jax_lora(JMCFG, jax.tree.map(jnp.asarray, moe_tree), lora,
                     tokens, jm, jmoe.moe_model_shardings(JMCFG, tp_axis=None),
                     None)
    check((losses, pull0(cluster, "final"), pull0(cluster, "grads")),
          want)


def test_lora_shardings_match_jax():
    """``lora_shardings`` gives the JAX package's rules for every target,
    and refuses an unknown one as it does."""
    from nbdistributed_tpu_torch.models import lora_shardings, tiny_config
    got = lora_shardings(tiny_config(), jlora.ALL_TARGETS)
    want = jlora.lora_shardings(JCFG, jlora.ALL_TARGETS)
    assert {k: {n: tuple(s) for n, s in v.items()}
            for k, v in got["layers"].items()} == \
        {k: {n: tuple(s) for n, s in v.items()}
         for k, v in want["layers"].items()}
    with pytest.raises(ValueError, match="unknown LoRA targets"):
        lora_shardings(tiny_config(), ("nope",))
