"""The port's pipeline schedules (``parallel/pipeline.py``) against the
JAX package's, on the CPU: a 4-rank gloo world of the port's workers
(``test_torch_mesh_train.py``'s cluster), every rank holding its stage
slice, against ``nbdistributed_tpu.parallel.pipeline`` on 4 of the
virtual CPU devices with the same numpy parameters and batches.

Mirrors ``tests/unit/test_pipeline.py``: ``pipeline_forward`` at M = S
and M = 8, GPipe gradients through ``make_pipeline_loss`` with and
without remat, 1F1B's loss and gradients, the full 1F1B with a tail and
an input-gradient sink, dp x pp with ``batch_axis``, a single stage,
and the refusals word for word; plus the partial permutation of
``Mesh.ppermute`` against ``jax.lax.ppermute`` (zeros where no pair
sends, the inverted pairs in the backward), ``shard_map`` and the
worker's seeded names.

Tolerances: outputs and losses within 1e-5 relative (the schedules
move microbatches, they do not reorder a sum, and float32 stage
products taken by XLA and PyTorch differ by a few ulps); every gradient
leaf within 1e-4 relative L2, as ``tests/test_torch_mesh_train.py``
holds them (microbatch gradients summed in the schedule's order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from nbdistributed_tpu.parallel import mesh as jmesh
from nbdistributed_tpu.parallel import pipeline as jpipe
from nbdistributed_tpu.utils.compat import shard_map as jshard_map
from nbdistributed_tpu_torch.parallel import pipeline as ppipe
from nbdistributed_tpu_torch.parallel.mesh import Mesh
from test_torch_mesh_train import (cell, cluster, every_rank,  # noqa: F401
                                   pull0, push, rel_l2)

S = 4
D = 16
RTOL = 1e-5
GRAD_RTOL = 1e-4


def _stage_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _mse_tail(out, tgt):
    return jnp.mean((out - tgt) ** 2)


def _arrays(seed, B, stages=S):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((stages, D, D)) * 0.3).astype(
                np.float32),
            "b": (rng.standard_normal((stages, D)) * 0.1).astype(np.float32),
            "x": rng.standard_normal((B, D)).astype(np.float32),
            "y": rng.standard_normal((B, D)).astype(np.float32)}


def _jparams(A):
    return {"w": jnp.asarray(A["w"]), "b": jnp.asarray(A["b"])}


def _jmesh(sizes):
    n = int(np.prod(list(sizes.values())))
    return jmesh.make_mesh(sizes, devices=jax.devices()[:n])


def _grads_close(got, want):
    for k in want:
        err = rel_l2(got[k], np.asarray(want[k]))
        assert err <= GRAD_RTOL, (k, err)


# Every rank: the stage function, the pushed arrays as tensors, and this
# rank's stage slice; ``whole`` gathers a stage-sliced leaf over pp.
SETUP = """
f = lambda p, h: torch.tanh(h @ p["w"] + p["b"])
mse = lambda o, t: ((o - t) ** 2).mean()
T = {k: torch.tensor(np.array(v)) for k, v in A.items()}
m = make_mesh(SIZES)
sp = shard_stage_params({"w": T["w"], "b": T["b"]}, m)
whole = lambda g: m.all_gather(g.detach().contiguous(), "pp", 0).numpy()
"""


def _setup(comm, A, sizes):
    push(comm, "A", A)
    cell(comm, f"SIZES = {sizes!r}\n" + SETUP)


@pytest.mark.integration
@pytest.mark.parametrize("B,n_micro", [(8, None), (16, 8)],
                         ids=["m_eq_s", "m8"])
def test_pipeline_forward_matches_jax(cluster, B, n_micro):
    """``test_pipeline.py:44,53``: the output on every rank equals JAX's
    pipelined forward (and so the sequential stage loop)."""
    A = _arrays(B, B)
    jm = _jmesh({"pp": S})
    want = jpipe.pipeline_forward(
        _stage_fn, jpipe.shard_stage_params(_jparams(A), jm),
        jnp.asarray(A["x"]), jm, n_microbatches=n_micro)
    _setup(cluster, A, {"pp": S})
    got = every_rank(cluster, f"pipeline_forward(f, sp, T['x'], m, "
                              f"n_microbatches={n_micro!r}).tolist()")
    np.testing.assert_allclose(np.array(got), np.asarray(want), rtol=RTOL,
                               atol=1e-6)


@pytest.mark.integration
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_gpipe_loss_and_grads_match_jax(cluster, remat):
    """``test_pipeline.py:70,87,206``: ``make_pipeline_loss`` (GPipe by
    autograd through the schedule's reverse tick loop), with and
    without a checkpointed stage: the loss on every rank, the stage
    gradients gathered whole and the input's gradient against
    ``jax.value_and_grad`` of JAX's, the input replicated on every
    rank."""
    A = _arrays(30 + remat, 8)
    jm = _jmesh({"pp": S})
    jloss = jpipe.make_pipeline_loss(_stage_fn, _mse_tail, jm, remat=remat)
    want_l, (want_g, want_dx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jpipe.shard_stage_params(_jparams(A), jm), jnp.asarray(A["x"]),
        jnp.asarray(A["y"]))
    _setup(cluster, A, {"pp": S})
    loss = every_rank(cluster, f"""
spg = {{k: v.clone().requires_grad_() for k, v in sp.items()}}
x = T["x"].clone().requires_grad_()
l = make_pipeline_loss(f, mse, m, remat={remat})(spg, x, T["y"])
l.backward()
res = {{"w": whole(spg["w"].grad), "b": whole(spg["b"].grad),
        "x": x.grad.numpy()}}
float(l)""")
    np.testing.assert_allclose(loss, float(want_l), rtol=RTOL)
    got = pull0(cluster, "res")
    _grads_close(got, {"w": want_g["w"], "b": want_g["b"], "x": want_dx})


@pytest.mark.integration
@pytest.mark.parametrize("B,n_micro", [(16, 8), (8, None)],
                         ids=["m8", "m_eq_s"])
def test_1f1b_loss_and_grads_match_jax(cluster, B, n_micro):
    """``test_pipeline.py:96,123``: ``make_pipeline_1f1b`` — the loss
    equal on every rank, the stage gradients gathered whole — against
    JAX's 1F1B schedule."""
    A = _arrays(40 + B, B)
    jm = _jmesh({"pp": S})
    want_l, want_g = jpipe.make_pipeline_1f1b(
        _stage_fn, _mse_tail, jm, n_microbatches=n_micro)(
        jpipe.shard_stage_params(_jparams(A), jm), jnp.asarray(A["x"]),
        jnp.asarray(A["y"]))
    _setup(cluster, A, {"pp": S})
    loss = every_rank(cluster, f"""
l, g = make_pipeline_1f1b(f, mse, m, n_microbatches={n_micro!r})(
    sp, T["x"], T["y"])
res = {{k: whole(v) for k, v in g.items()}}
float(l)""")
    np.testing.assert_allclose(loss, float(want_l), rtol=RTOL)
    _grads_close(pull0(cluster, "res"), want_g)


@pytest.mark.integration
def test_1f1b_full_tail_and_dx_sink_match_jax(cluster):
    """``make_pipeline_1f1b_full`` with a tail that has parameters and a
    sink folding stage 0's input cotangents: the loss, the stage, tail
    and input gradients, each equal on every rank where replicated."""
    A = _arrays(50, 16)
    A["head"] = np.random.default_rng(51).standard_normal(
        (D, D)).astype(np.float32)
    jm = _jmesh({"pp": S})

    def jtail(tp, y, t):
        return jnp.mean((y @ tp["head"] - t) ** 2)

    fn = jpipe.make_pipeline_1f1b_full(
        _stage_fn, jtail, jm, n_microbatches=8,
        dx_sink=lambda acc, dx, b: acc + jnp.sum(dx, axis=0),
        dx_init=lambda: jnp.zeros((D,), jnp.float32))
    want = fn({"head": jnp.asarray(A["head"])},
              jpipe.shard_stage_params(_jparams(A), jm),
              jnp.asarray(A["x"]), jnp.asarray(A["y"]))
    _setup(cluster, A, {"pp": S})
    loss = every_rank(cluster, """
fn = make_pipeline_1f1b_full(
    f, lambda tp, y, t: ((y @ tp["head"] - t) ** 2).mean(), m,
    n_microbatches=8, dx_sink=lambda acc, dx, b: acc + dx.sum(0),
    dx_init=lambda: torch.zeros(16))
l, g, tg, dxa = fn({"head": T["head"]}, sp, T["x"], T["y"])
res = {"w": whole(g["w"]), "b": whole(g["b"]), "head": tg["head"].numpy(),
       "dx": dxa.numpy()}
float(l)""")
    np.testing.assert_allclose(loss, float(want[0]), rtol=RTOL)
    every_rank(cluster, '(tg["head"].sum().item(), dxa.sum().item())')
    _grads_close(pull0(cluster, "res"),
                 {"w": want[1]["w"], "b": want[1]["b"],
                  "head": want[2]["head"], "dx": want[3]})


@pytest.mark.integration
def test_1f1b_dp_pp_matches_jax(cluster):
    """``test_pipeline.py:225``: dp2 x pp2, each dp group pipelining its
    rows of every microbatch, a stage of two applications; loss and
    gradients means over dp, against JAX's ``batch_axis="dp"`` run."""
    A = _arrays(60, 8)
    p2 = {k: jnp.asarray(A[k]).reshape(2, 2, *A[k].shape[1:])
          for k in ("w", "b")}

    def stage2(pr, h):
        return _stage_fn(jax.tree.map(lambda a: a[1], pr),
                         _stage_fn(jax.tree.map(lambda a: a[0], pr), h))

    jm = _jmesh({"dp": 2, "pp": 2})
    want_l, want_g = jpipe.make_pipeline_1f1b(
        stage2, _mse_tail, jm, n_microbatches=4, batch_axis="dp")(
        jpipe.shard_stage_params(p2, jm), jnp.asarray(A["x"]),
        jnp.asarray(A["y"]))
    push(cluster, "A", A)
    loss = every_rank(cluster, """
f = lambda p, h: torch.tanh(h @ p["w"] + p["b"])
f2 = lambda p, h: f({k: v[1] for k, v in p.items()},
                    f({k: v[0] for k, v in p.items()}, h))
T = {k: torch.tensor(np.array(v)) for k, v in A.items()}
m = make_mesh({"dp": 2, "pp": 2})
sp = shard_stage_params({k: T[k].reshape(2, 2, *T[k].shape[1:])
                         for k in ("w", "b")}, m)
l, g = make_pipeline_1f1b(f2, lambda o, t: ((o - t) ** 2).mean(), m,
                          n_microbatches=4, batch_axis="dp")(
    sp, T["x"], T["y"])
res = {k: m.all_gather(v.contiguous(), "pp", 0).numpy() for k, v in g.items()}
float(l)""")
    np.testing.assert_allclose(loss, float(want_l), rtol=RTOL)
    _grads_close(pull0(cluster, "res"), want_g)


def _one_stage():
    return Mesh({"pp": 1}, {"pp": 0}, {}, {})


def test_single_stage_matches_jax():
    """``test_pipeline.py:277,300``: a one-stage axis (no process group)
    degenerates to the stage itself: ``pipeline_forward`` and 1F1B's
    loss and gradients against JAX's one-device pipeline."""
    A = _arrays(70, 4)
    jm = _jmesh({"pp": 1})
    one = {k: jnp.asarray(A[k][:1]) for k in ("w", "b")}
    x, y = jnp.asarray(A["x"]), jnp.asarray(A["y"])
    want_out = jpipe.pipeline_forward(_stage_fn, one, x, jm)
    want_l, want_g = jpipe.make_pipeline_1f1b(
        _stage_fn, _mse_tail, jm, n_microbatches=2)(one, x, y)
    m = _one_stage()
    f = lambda p, h: torch.tanh(h @ p["w"] + p["b"])  # noqa: E731
    tone = {k: torch.tensor(A[k][:1]) for k in ("w", "b")}
    tx, ty = torch.tensor(A["x"]), torch.tensor(A["y"])
    out = ppipe.pipeline_forward(f, tone, tx, m)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=RTOL,
                               atol=1e-6)
    loss, grads = ppipe.make_pipeline_1f1b(
        f, lambda o, t: ((o - t) ** 2).mean(), m, n_microbatches=2)(
        tone, tx, ty)
    np.testing.assert_allclose(float(loss), float(want_l), rtol=RTOL)
    _grads_close({k: v.numpy() for k, v in grads.items()}, want_g)


def _raises_same(jfn, pfn):
    with pytest.raises(ValueError) as want:
        jfn()
    with pytest.raises(ValueError) as got:
        pfn()
    assert str(got.value) == str(want.value)
    return str(got.value)


def test_refusals_match_jax():
    """JAX's messages, word for word (``pipeline.py:61,188,200-206``):
    a batch the microbatches do not divide (GPipe and 1F1B), ``dx_sink``
    without ``dx_init``, and dp rows a microbatch cannot split."""
    A = _arrays(80, 6)
    f = lambda p, h: h  # noqa: E731
    jm4, pm4 = _jmesh({"pp": S}), Mesh({"pp": S}, {"pp": 0}, {}, {})
    jp = jpipe.shard_stage_params(_jparams(A), jm4)
    tp = {k: torch.tensor(A[k][:1]) for k in ("w", "b")}
    tx = torch.tensor(A["x"])
    msgs = [
        _raises_same(lambda: jpipe.pipeline_forward(
            _stage_fn, jp, jnp.asarray(A["x"]), jm4),
            lambda: ppipe.pipeline_forward(f, tp, tx, pm4)),
        _raises_same(lambda: jpipe.make_pipeline_1f1b(
            _stage_fn, _mse_tail, jm4)(jp, jnp.asarray(A["x"]),
                                       jnp.asarray(A["y"])),
            lambda: ppipe.make_pipeline_1f1b(f, None, pm4)(tp, tx, tx)),
        _raises_same(lambda: jpipe.make_pipeline_1f1b_full(
            _stage_fn, None, jm4, dx_sink=lambda *a: a[0]),
            lambda: ppipe.make_pipeline_1f1b_full(
                f, None, pm4, dx_sink=lambda *a: a[0]))]
    jdp = _jmesh({"dp": 4, "pp": 1})
    pdp = Mesh({"dp": 4, "pp": 1}, {"dp": 0, "pp": 0}, {}, {})
    x8 = np.zeros((8, D), np.float32)
    msgs.append(_raises_same(
        lambda: jpipe.make_pipeline_1f1b(
            _stage_fn, _mse_tail, jdp, n_microbatches=4,
            batch_axis="dp")(jpipe.shard_stage_params(
                {k: v[:1] for k, v in _jparams(A).items()}, jdp),
            jnp.asarray(x8), jnp.asarray(x8)),
        lambda: ppipe.make_pipeline_1f1b(
            f, None, pdp, n_microbatches=4, batch_axis="dp")(
            tp, torch.tensor(x8), torch.tensor(x8))))
    assert "not divisible by 4 microbatches" in msgs[0]
    assert "dp=4" in msgs[3]


# ----------------------------------------------------------------------
# the partial permutation, shard_map, and the worker's names

PPERMUTE = """
from nbdistributed_tpu_torch.parallel.mesh import local_slice
m = make_mesh({"pp": 4})
x = local_slice(torch.tensor(np.array(A["x"])), 0, 4, m.index("pp"))
x = x.contiguous().requires_grad_()
out = m.ppermute(x, "pp", pairs=PAIRS)
(out * local_slice(torch.tensor(np.array(A["cot"])), 0, 4,
                   m.index("pp"))).sum().backward()
res = {"out": m.all_gather(out.detach().contiguous(), "pp", 0).numpy(),
       "dx": m.all_gather(x.grad.contiguous(), "pp", 0).numpy()}
"""


@pytest.mark.integration
@pytest.mark.parametrize("pairs", [[(i, i + 1) for i in range(S - 1)],
                                   [(3, 0), (1, 2)]],
                         ids=["stages_forward", "two_pairs"])
def test_partial_ppermute_matches_jax(cluster, pairs):
    """``Mesh.ppermute(pairs=)`` and its backward against
    ``jax.lax.ppermute`` with the same pairs inside ``shard_map``: the
    ranks no pair sends to get zeros (stage 0 of the pipeline's
    ``[(i, i + 1)]``), and the cotangent goes back along the inverted
    pairs — exactly, since they only move data."""
    rng = np.random.default_rng(len(pairs))
    x = rng.standard_normal((8, 3, 5)).astype(np.float32)
    jm = _jmesh({"pp": S})
    f = jshard_map(lambda t: jax.lax.ppermute(t, "pp", pairs), mesh=jm,
                   in_specs=JP("pp"), out_specs=JP("pp"))
    want, vjp = jax.vjp(jax.jit(f), jnp.asarray(x))
    cot = rng.standard_normal(want.shape).astype(np.float32)
    (dx,) = vjp(jnp.asarray(cot))
    push(cluster, "A", {"x": x, "cot": cot})
    cell(cluster, f"PAIRS = {pairs!r}\n" + PPERMUTE)
    got = pull0(cluster, "res")
    np.testing.assert_array_equal(got["out"], np.asarray(want))
    np.testing.assert_array_equal(got["dx"], np.asarray(dx))
    if pairs[0] == (0, 1):
        assert not got["out"][:2].any()


@pytest.mark.integration
def test_shard_map_matches_jax(cluster):
    """The port's ``shard_map`` takes whole inputs, hands the function
    this rank's blocks and gathers its outputs by their specs, as
    ``jax.shard_map`` on four devices: a row-split product with a
    replicated weight, a psum-replicated output and a two-axis split."""
    rng = np.random.default_rng(90)
    a = rng.standard_normal((8, 6)).astype(np.float32)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    jm = _jmesh({"dp": 2, "tp": 2})
    jf = jshard_map(
        lambda a_, w_: (a_ @ w_, jax.lax.psum(a_.sum(0), ("dp", "tp"))),
        mesh=jm, in_specs=(JP(("dp", "tp")), JP()),
        out_specs=(JP(("dp", "tp")), JP()))
    want = jf(jnp.asarray(a), jnp.asarray(w))
    push(cluster, "A", {"a": a, "w": w})
    cell(cluster, """
m = make_mesh({"dp": 2, "tp": 2})
sm = shard_map(lambda a_, w_: (a_ @ w_, m.psum(m.psum(a_.sum(0), "dp"),
                                                "tp")),
               m, (P(("dp", "tp")), P()), (P(("dp", "tp")), P()))
res = [t.numpy() for t in sm(torch.tensor(np.array(A["a"])),
                             torch.tensor(np.array(A["w"])))]
""")
    got = pull0(cluster, "res")
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w_), rtol=RTOL, atol=1e-6)


def test_worker_seeds_the_pipeline_names():
    """The worker's namespace carries ``pipeline_forward``,
    ``shard_stage_params`` and ``shard_map``, as the JAX worker's does
    (``runtime/worker.py:373,387-388``)."""
    from nbdistributed_tpu_torch.parallel import mesh as pmesh
    from nbdistributed_tpu_torch.runtime import worker as pworker
    w = pworker.DistributedWorker.__new__(pworker.DistributedWorker)
    w.rank, w.world_size, w.backend, w.gpu_id = 0, 1, "cpu", None
    w.device, w.namespace = torch.device("cpu"), {}
    w._seed_namespace()
    assert w.namespace["pipeline_forward"] is ppipe.pipeline_forward
    assert w.namespace["shard_stage_params"] is ppipe.shard_stage_params
    assert w.namespace["shard_map"] is pmesh.shard_map
