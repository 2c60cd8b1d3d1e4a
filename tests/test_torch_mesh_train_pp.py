"""The port's pipeline-parallel training (``models/pp.py``) against the
JAX package's, on the CPU: a 4-rank gloo world of the port's workers
(``test_torch_mesh_train.py``'s cluster), every rank holding its stage
slice of the layer stack, against ``nbdistributed_tpu.models.pp`` on 4
of the virtual CPU devices with the same numpy parameters (4 layers of
``tiny_config``, float32, plain attention on the JAX side) and batches,
``optax.adamw`` against the port's ``AdamW``.

Mirrors ``tests/unit/test_model_pp.py``: the stage round trip,
``pp_loss_fn`` at pp4 and at pp2 with four microbatches,
``make_pp_train_step`` (GPipe) and ``make_pp_1f1b_train_step`` (pp4,
pp2 with four microbatches, dp2 x pp2 with ``batch_axis``), and the
refusals (indivisible layers and batches, packed documents) word for
word.

Tolerances: losses within 1e-5 relative, every gradient of the first
step and every leaf after two steps within 1e-4 relative L2 (the stage
slices gathered whole), as ``tests/test_torch_mesh_train.py`` states
them: AdamW's update is blind to a gradient scaled by a constant, so
the gradients are held themselves; every rank's losses equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nbdistributed_tpu.models import pp as jpp
from nbdistributed_tpu.models import transformer as jtf
from nbdistributed_tpu.parallel import mesh as jmesh
from nbdistributed_tpu_torch.models import pp as ppp
from nbdistributed_tpu_torch.models import init_params, tiny_config
from nbdistributed_tpu_torch.parallel.mesh import Mesh
from test_torch_mesh_train import (  # noqa: F401
    cell, cluster, every_rank, flat, grab, pull0, push, rel_l2)

LR = 1e-3
STEPS = 2
LOSS_RTOL = 1e-5
LEAF_RTOL = 1e-4
JCFG = dataclasses.replace(jtf.tiny_config(dtype=jnp.float32,
                                           use_flash=False), n_layers=4)


@pytest.fixture(scope="module")
def tree(cluster):
    t = jax.tree.map(np.asarray, jtf.init_params(jax.random.PRNGKey(0),
                                                 JCFG))
    push(cluster, "tree", t)
    cell(cluster, "import dataclasses\ncfg = dataclasses.replace("
                  "tiny_config(dtype=torch.float32), n_layers=4)")
    return t


def _tokens(seed=1, shape=(8, 16)):
    return np.asarray(np.random.default_rng(seed).integers(
        0, JCFG.vocab_size, shape), np.int32)


def _jmesh(sizes):
    n = int(np.prod(list(sizes.values())))
    return jmesh.make_mesh(sizes, devices=jax.devices()[:n])


def test_stage_roundtrip_matches_jax():
    """``test_model_pp.py:35``: ``pp_stage_params`` re-chunks the layer
    stack as JAX's does, ``pp_unstage_params`` undoes it exactly, and 3
    stages of 4 layers raise JAX's message."""
    cfg = dataclasses.replace(tiny_config(dtype=torch.float32), n_layers=4)
    params = init_params(cfg, 0, device="cpu")
    pp = ppp.pp_stage_params(params, 2)
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    jstaged = jpp.pp_stage_params(jparams, 2)
    assert sorted(pp) == sorted(jstaged)
    for k, v in pp["layers_pp"].items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(jstaged["layers_pp"][k]))
    back = ppp.pp_unstage_params(pp)
    for k, v in params["layers"].items():
        assert torch.equal(back["layers"][k], v)
    with pytest.raises(ValueError) as want:
        jpp.pp_stage_params(jparams, 3)
    with pytest.raises(ValueError) as got:
        ppp.pp_stage_params(params, 3)
    assert str(got.value) == str(want.value)


def test_refusals_match_jax():
    """``test_model_pp.py:155,166``: a batch the microbatches do not
    divide, and packed documents (the pipelined losses would let
    attention cross them), in GPipe's loss and in the 1F1B step: JAX's
    messages word for word, before any hop (a rank's view of the mesh
    without a process group)."""
    cfg = dataclasses.replace(tiny_config(dtype=torch.float32), n_layers=4)
    params = init_params(cfg, 0, device="cpu")
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    jm = _jmesh({"pp": 4})
    pm = Mesh({"pp": 4}, {"pp": 0}, {}, {})
    pp = ppp.pp_apply_shardings(ppp.pp_stage_params(params, 4), pm)
    jp = jpp.pp_apply_shardings(jpp.pp_stage_params(jparams, 4), jm)
    tok = np.zeros((3, 16), np.int32)
    seg = {"tokens": np.zeros((4, 16), np.int32),
           "segments": np.zeros((4, 16), np.int32)}
    from nbdistributed_tpu_torch.models import AdamW, param_leaves
    pstep = ppp.make_pp_1f1b_train_step(
        cfg, AdamW(param_leaves(pp), LR), pm)
    jopt = optax.sgd(1e-2)
    jstep = jpp.make_pp_1f1b_train_step(JCFG, jopt, jm)
    for jcall, pcall in (
            (lambda: jpp.pp_loss_fn(jp, {"tokens": jnp.asarray(tok)}, JCFG,
                                    jm),
             lambda: ppp.pp_loss_fn(pp, {"tokens": torch.tensor(tok)}, cfg,
                                    pm)),
            (lambda: jpp.pp_loss_fn(jp, seg, JCFG, jm),
             lambda: ppp.pp_loss_fn(pp, seg, cfg, pm)),
            (lambda: jstep(jp, jopt.init(jp), seg),
             lambda: pstep(pp, seg))):
        with pytest.raises(ValueError) as want:
            jcall()
        with pytest.raises(ValueError) as got:
            pcall()
        assert str(got.value) == str(want.value)


@pytest.mark.integration
@pytest.mark.parametrize("n_stages,n_micro", [(4, None), (2, 4)],
                         ids=["pp4", "pp2_m4"])
def test_pp_loss_matches_jax(cluster, tree, n_stages, n_micro):
    """``test_model_pp.py:51,143``: ``pp_loss_fn`` (GPipe) on pp4, and on
    pp2 with four microbatches (a ``dp`` axis of two replicas beside
    it): the loss on every rank against JAX's."""
    tokens = _tokens()
    jm = _jmesh({"pp": n_stages})
    jp = jpp.pp_apply_shardings(jpp.pp_stage_params(
        jax.tree.map(jnp.asarray, tree), n_stages), jm)
    want = float(jax.jit(lambda p, b: jpp.pp_loss_fn(
        p, b, JCFG, jm, n_microbatches=n_micro))(
        jp, {"tokens": jnp.asarray(tokens)}))
    push(cluster, "batch", {"tokens": tokens})
    sizes = {"pp": 4} if n_stages == 4 else {"dp": 2, "pp": 2}
    got = every_rank(cluster, f"""
m = make_mesh({sizes!r})
p = pp_apply_shardings(pp_stage_params(params_from_jax(tree, cfg,
                       device="cpu"), {n_stages}), m)
float(pp_loss_fn(p, {{"tokens": torch.tensor(np.array(batch["tokens"]))}},
                 cfg, m, n_microbatches={n_micro!r}))""")
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


# Every rank: the pipelined step on its stage slice, STEPS steps on the
# whole batch, the losses; the tree and the first step's gradients with
# the stage slices gathered over pp.
PORT_RUN = """
m = make_mesh({sizes!r})
p = pp_apply_shardings(pp_stage_params(params_from_jax(tree, cfg,
                       device="cpu"), {n_stages}), m)
opt = Grab(param_leaves(p), {lr})
step = {make}(cfg, opt, m, n_microbatches={n_micro!r}{extra})
b = as_batch(batch)
losses = [float(step(p, b)) for _ in range({steps})]

def gathered(t):
    return {{path: (m.all_gather(v.detach().contiguous(), "pp", 0)
                   if path.startswith("layers_pp/") else v.detach()).numpy()
            for path, v in named_param_leaves(t)}}

final = gathered(p)
grads = gathered(_unflat(p, opt))
losses"""

# The first step's gradients as a tree shaped like the params.
UNFLAT = """
def _unflat(tree, opt):
    return {k: (_unflat(v, opt) if isinstance(v, dict)
                else opt.grads[id(v)]) for k, v in tree.items()}
"""

STEP_CASES = {
    "gpipe_pp4": ("make_pp_train_step", {"pp": 4}, 4, None, None),
    "gpipe_pp2_m4": ("make_pp_train_step", {"dp": 2, "pp": 2}, 2, 4, None),
    "1f1b_pp4": ("make_pp_1f1b_train_step", {"pp": 4}, 4, None, None),
    "1f1b_pp2_m4": ("make_pp_1f1b_train_step", {"dp": 2, "pp": 2}, 2, 4,
                    None),
    "1f1b_dp2_pp2": ("make_pp_1f1b_train_step", {"dp": 2, "pp": 2}, 2, None,
                     "dp"),
}


@pytest.mark.integration
@pytest.mark.parametrize("case", list(STEP_CASES))
def test_pp_train_steps_match_jax(cluster, tree, case):
    """``test_model_pp.py:64,82,104,124,...``: the GPipe and 1F1B steps
    on pp4, on pp2 with four microbatches, and 1F1B on dp2 x pp2 (each
    dp group its rows of every microbatch): two AdamW steps against the
    JAX step on the same mesh with ``optax.adamw`` — losses equal on
    every rank, the first step's gradients and the final leaves."""
    make, sizes, n_stages, n_micro, batch_axis = STEP_CASES[case]
    tokens = _tokens()
    jm = _jmesh(sizes if batch_axis else {"pp": n_stages})
    opt = optax.chain(grab(), optax.adamw(LR))
    kw = {"batch_axis": batch_axis} if batch_axis else {}
    jstep = getattr(jpp, make)(JCFG, opt, jm, n_microbatches=n_micro, **kw)
    # JAX's 1F1B step jits its schedule itself and caches it by shape; a
    # jit around the step would leak its cached positions' tracer into
    # the second step.
    jstep = jstep if "1f1b" in case else jax.jit(jstep)
    p = jpp.pp_apply_shardings(jpp.pp_stage_params(
        jax.tree.map(jnp.asarray, tree), n_stages), jm)
    s = opt.init(p)
    want_losses = []
    for i in range(STEPS):
        p, s, lval = jstep(p, s, {"tokens": jnp.asarray(tokens)})
        want_losses.append(float(lval))
        want_grads = flat(s[0]) if i == 0 else want_grads
    want_final = flat(p)
    push(cluster, "batch", {"tokens": tokens})
    cell(cluster, UNFLAT)
    extra = f", batch_axis={batch_axis!r}" if batch_axis else ""
    losses = every_rank(cluster, PORT_RUN.format(
        sizes=sizes, n_stages=n_stages, lr=LR, make=make, n_micro=n_micro,
        extra=extra, steps=STEPS))
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    for got, want in ((pull0(cluster, "grads"), want_grads),
                      (pull0(cluster, "final"), want_final)):
        assert sorted(got) == sorted(want)
        worst = {k: rel_l2(got[k], want[k]) for k in want}
        assert max(worst.values()) <= LEAF_RTOL, worst
