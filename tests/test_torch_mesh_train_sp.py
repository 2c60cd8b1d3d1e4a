"""The port's sequence-parallel training against the JAX package's, on
the CPU: a 4-rank gloo world of the port's workers
(``test_torch_mesh_train.py``'s cluster), every rank holding its chunk
of the sequence of its dp rows, against the JAX package's step with a
``SeqParallel`` on 4 virtual CPU devices, the same numpy parameters and
batch (packed documents crossing the chunk boundaries, so RoPE restarts
and next-token targets come from other ranks' chunks), and
``optax.adamw`` against the port's ``AdamW``.

Each case holds the losses, every gradient leaf of the first step and
every leaf after 2 steps (gathered from the shards) to JAX's: losses
within 1e-5 relative, leaves and gradients within 1e-4 relative L2
(AdamW's update is blind to a gradient off by a constant factor, so the
gradients are held themselves; ``test_torch_mesh_train.py`` states
why).  The port's dense model attends through its flash ring (the
kernels' plain versions on the CPU), JAX's through its grouped-einsum
ring.  The MoE loss and the LoRA step under sp are in
``test_torch_mesh_train_sp_moe.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import optax
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from nbdistributed_tpu.models import transformer as jtf
from nbdistributed_tpu.parallel import mesh as jmesh
from nbdistributed_tpu.parallel.tensor_parallel import apply_shardings as jput
from test_torch_mesh_train import (JCFG, LR, STEPS, check,  # noqa: F401
                                   cluster, every_rank, flat, grab,
                                   packed_batch, pull0, push, tree)

pytestmark = [pytest.mark.integration]

DEVS = jax.devices()[:4]
S = 32

PORT_RUN = """
import dataclasses
m = make_mesh({sizes!r})
c = dataclasses.replace({cfg}, ce_chunk={chunk!r})
sp = SeqParallel(m, method={method!r})
rules = {rules}
p = params_from_jax({tree}, c, device="cpu")
p = apply_shardings(p, m, rules) if rules is not None else p
opt = Grab(param_leaves(p), {lr})
step = {make}
b = as_batch(batch)
b = shard_batch(b, m) if "dp" in m.shape else b
losses = [float(step(p, b)) for _ in range({steps})]
final = gather_tree(p, m, rules)
grads = first_grads(p, opt, m, rules)
losses"""


def port_run(comm, batch, sizes, *, method="ring", chunk=None, cfg="cfg",
             tree="tree", rules=None,
             make="make_train_step(c, opt, sp, rules=rules)"):
    push(comm, "batch", batch)
    losses = every_rank(comm, PORT_RUN.format(
        sizes=sizes, cfg=cfg, chunk=chunk, method=method, tree=tree,
        rules=rules or "None", lr=LR, make=make, steps=STEPS))
    return losses, pull0(comm, "final"), pull0(comm, "grads")


def jax_batch(batch, jm):
    """The global batch laid out over (dp, sp) as the JAX tests put it."""
    spec = JP("dp" if "dp" in jm.shape else None, "sp")
    return {k: jax.device_put(jnp.asarray(v), NamedSharding(jm, spec))
            for k, v in batch.items()}


def jax_steps(step, p, s, batch):
    losses = []
    for i in range(STEPS):
        p, s, lval = step(p, s, batch)
        losses.append(float(lval))
        grads = flat(s[0]) if i == 0 else grads
    return losses, flat(p), grads


def jax_run(jtree, batch, sizes, *, method="ring", chunk=None):
    """``make_train_step(cfg, opt, sp=SeqParallel(...))`` on the mesh of
    4 virtual devices, Megatron rules where it has a tp axis."""
    cfg = dataclasses.replace(JCFG, ce_chunk=chunk)
    jm = jmesh.make_mesh(sizes, devices=DEVS)
    sp = jtf.SeqParallel(mesh=jm, method=method, use_flash=False)
    p = jax.tree.map(jnp.asarray, jtree)
    if "tp" in sizes:
        p = jput(p, jm, jtf.param_shardings(cfg))
    opt = optax.chain(grab(), optax.adamw(LR))
    step = jax.jit(jtf.make_train_step(cfg, opt, sp=sp))
    return jax_steps(step, p, opt.init(p), jax_batch(batch, jm))


def sp_batch(B, seed):
    """Packed documents (row r holds r + 1 of them, boundaries anywhere),
    at least one crossing a chunk boundary on every sp layout here."""
    batch = packed_batch(B=B, S=S, seed=seed)
    seg = batch["segments"]
    assert (seg[:, 7] == seg[:, 8]).any() and (seg[:, 15] == seg[:, 16]).any()
    return batch


@pytest.mark.parametrize("sizes,method,chunk", [
    ({"sp": 4}, "ring", None),
    ({"sp": 4}, "ring", 128),
    ({"dp": 2, "sp": 2}, "ring", None),
    ({"dp": 2, "sp": 2}, "ring", 128),
    ({"dp": 2, "sp": 2}, "ulysses", None),
    ({"sp": 2, "tp": 2}, "ring", None),
    ({"sp": 2, "tp": 2}, "ring", 128),
], ids=["sp4", "sp4_ce_chunk", "dp2_sp2", "dp2_sp2_ce_chunk",
        "dp2_sp2_ulysses", "sp2_tp2_megatron", "sp2_tp2_ce_chunk"])
def test_train_step_sp_matches_jax(cluster, tree, sizes, method, chunk):
    """``make_train_step(sp=)``: the chunk's loss share times the ranks
    splitting the batch, the gradients averaged over dp and sp; with a
    tp axis the Megatron rules split the heads, and ``ce_chunk`` keeps
    the standard tail there as JAX's rule does."""
    batch = sp_batch(4, seed=11 + len(sizes))
    rules = "param_shardings(c)" if "tp" in sizes else None
    check(port_run(cluster, batch, sizes, method=method, chunk=chunk,
                   rules=rules),
          jax_run(tree, batch, sizes, method=method, chunk=chunk))
