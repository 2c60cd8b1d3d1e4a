"""The port's sequence-parallel MoE loss and LoRA step against the JAX
package's, on the CPU: as ``test_torch_mesh_train_sp.py`` (whose
helpers these are), for ``moe_loss_fn(sp=)`` on sp2 x ep2 in the three
dispatch modes and ``make_lora_train_step(sp=)`` on sp2 x tp2 — the
losses within 1e-5 relative, every first-step gradient and every leaf
after 2 steps within 1e-4 relative L2."""

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
from test_torch_mesh_train import (JCFG, LR, STEPS, check,  # noqa: F401
                                   cluster, every_rank, flat, grab, pull0,
                                   push, tree)
from test_torch_mesh_train_sp import (DEVS, jax_batch, jax_steps, port_run,
                                      sp_batch)

pytestmark = [pytest.mark.integration]

JMCFG = jmoe.tiny_moe_config(dtype=jnp.float32, use_flash=False,
                             capacity_factor=1.0)


@pytest.fixture(scope="module")
def moe_tree(cluster):  # noqa: F811
    t = jax.tree.map(np.asarray,
                     jmoe.init_moe_model(jax.random.PRNGKey(0), JMCFG))
    push(cluster, "mtree", t)
    every_rank(cluster, "mcfg = tiny_moe_config(dtype=torch.float32, "
                        "capacity_factor=1.0); 0")
    return t


@pytest.mark.parametrize("mode", ["dense", "sparse", "dropless"])
def test_moe_loss_sp_ep_matches_jax(cluster, moe_tree, mode):
    """``moe_loss_fn(sp=)`` on sp2 x ep2 at capacity factor 1.0, where
    tokens drop: dense and sparse route all B*S tokens together (global
    capacity, slots in the flattened b*S + s order), dropless each
    (dp, sp) block of that order at its shard capacity (two rows, so the
    blocks are not the ranks' chunks); the aux loss over every token."""
    batch = sp_batch(2, seed=21)
    sizes = {"sp": 2, "ep": 2}
    got = port_run(
        cluster, batch, sizes, cfg=f"dataclasses.replace(mcfg, "
        f"moe_dispatch={mode!r})", tree="mtree",
        rules="moe_model_shardings(c, tp_axis=None)",
        make="make_tp_train_step(lambda pp, bb: moe_loss_fn(pp, bb, c, "
             "rules=rules, sp=sp), opt, m, rules, sp_axis='sp')")
    cfg = dataclasses.replace(JMCFG, moe_dispatch=mode)
    jm = jmesh.make_mesh(sizes, devices=DEVS)
    sp = jtf.SeqParallel(mesh=jm, use_flash=False)
    p = jput(jax.tree.map(jnp.asarray, moe_tree), jm,
             jmoe.moe_model_shardings(cfg, tp_axis=None))
    opt = optax.chain(grab(), optax.adamw(LR))

    @jax.jit
    def step(p, s, b):
        lval, g = jax.value_and_grad(
            lambda q: jmoe.moe_loss_fn(q, b, cfg, mesh=jm, sp=sp))(p)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, lval

    check(got, jax_steps(step, p, opt.init(p), jax_batch(batch, jm)))


def test_lora_sp_tp_matches_jax(cluster, tree):
    """``make_lora_train_step(sp=)`` (``lora.py:138-163``) on sp2 x tp2:
    every linear adapted (rank 4, ``b`` drawn nonzero so both factors
    move) by ``lora_shardings``, the base by Megatron rules; the
    adapters' gradients averaged over sp: JAX's losses, adapters and
    first gradients."""
    lora = jlora.lora_init(jax.random.PRNGKey(7), JCFG, rank=4,
                           targets=jlora.ALL_TARGETS)
    lora = jax.tree.map(lambda x: x + 0.05 * jax.random.normal(
        jax.random.PRNGKey(8), x.shape), lora)
    push(cluster, "lora", jax.tree.map(np.asarray, lora))
    batch = sp_batch(2, seed=31)
    sizes = {"sp": 2, "tp": 2}
    push(cluster, "batch", batch)
    losses = every_rank(cluster, f"""
m = make_mesh({sizes!r})
sp = SeqParallel(m)
base = apply_shardings(params_from_jax(tree, cfg, device="cpu"), m,
                       param_shardings(cfg))
lrules = lora_shardings(cfg, lora)
ad = apply_shardings(lora_from_jax(lora, device="cpu"), m, lrules)
opt = Grab(param_leaves(ad), {LR})
step = make_lora_train_step(cfg, opt, sp=sp)
losses = [float(step(base, ad, as_batch(batch))) for _ in range({STEPS})]
final = gather_tree(ad, m, lrules)
grads = first_grads(ad, opt, m, lrules)
losses""")
    jm = jmesh.make_mesh(sizes, devices=DEVS)
    opt = optax.chain(grab(), optax.adamw(LR))
    step = jax.jit(jlora.make_lora_train_step(
        JCFG, opt, sp=jtf.SeqParallel(mesh=jm, use_flash=False)))
    params = jput(jax.tree.map(jnp.asarray, tree), jm,
                  jtf.param_shardings(JCFG))
    lo = jput(lora, jm, jlora.lora_shardings(JCFG, lora))
    b = jax_batch(batch, jm)
    s, jl = opt.init(lo), []
    for i in range(STEPS):
        lo, s, lval = step(params, lo, s, b)
        jl.append(float(lval))
        grads = flat(s[0]) if i == 0 else grads
    check((losses, pull0(cluster, "final"), pull0(cluster, "grads")),
          (jl, flat(lo), grads))
