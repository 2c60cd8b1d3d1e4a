"""The port's mixture-of-experts layer (``nbdistributed_tpu_torch/
parallel/expert.py``) against the JAX package's
(``nbdistributed_tpu/parallel/expert.py``) on the CPU.

Both sides get the same numpy inputs (seeded) and the same parameters
(JAX init, handed over as numpy).  Routing decisions are compared
exactly (capacities, expert indices, the dispatch 0/1 tensors, the
sparse slots: drops identical); gates and the load-balance loss to 1e-6;
layer outputs and gradients to 1e-5 (fp32 products summed in other
orders by XLA and PyTorch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbdistributed_tpu.models import quant as jquant
from nbdistributed_tpu.parallel import expert as je
from nbdistributed_tpu_torch.models import quant as tquant
from nbdistributed_tpu_torch.parallel import expert as te

D, F, E, K = 16, 32, 4, 2
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """(numpy tree, the port's tensors) of one JAX init."""
    tree = jax.tree.map(np.asarray, je.init_moe_params(
        jax.random.PRNGKey(7), D, F, E, dtype=jnp.float32))
    return tree, _torch_tree(tree)


def _torch_tree(tree):
    """A nested dict of numpy arrays as tensors (copies: JAX hands out
    read-only arrays)."""
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _x(T, seed=0):
    return np.random.default_rng(seed).standard_normal((T, D)).astype(
        np.float32)


def _mask(T, seed=1, p=0.6):
    return np.random.default_rng(seed).random(T) < p


def _routing(T, seed=2, k=K, ties=False):
    """Router logits (T, E); with ``ties`` some rows tie: all zero, all
    equal, and two experts tied for the lead."""
    logits = np.random.default_rng(seed).standard_normal((T, E)).astype(
        np.float32)
    if ties:
        logits[0] = 0.0
        logits[1] = 1.5
        logits[2, [1, 3]] = 4.0
        logits[3, [0, 2]] = logits[3].max() + 1.0
    return logits


@pytest.mark.parametrize("T,n_exp,k,cf", [(64, 4, 2, 1.0), (64, 4, 2, 1.25),
                                          (4, 8, 1, 1.0), (100, 4, 2, 1.0),
                                          (512, 8, 2, 4.0), (8, 8, 2, 1.25),
                                          (2048, 8, 2, 1.25), (1, 8, 2, 0.5)])
def test_compute_capacity_matches_jax(T, n_exp, k, cf):
    assert te.compute_capacity(T, n_exp, k, cf) == je.compute_capacity(
        T, n_exp, k, cf)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_routing_matches_jax(ties, k):
    """Gates to 1e-6, indices exact, tied probabilities included (the
    lower expert index first, as ``jax.lax.top_k`` orders them)."""
    logits = _routing(24, k=k, ties=ties)
    jg, ji, jp = je.top_k_routing(jnp.asarray(logits), k)
    tg, ti, tp = te.top_k_routing(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6,
                               rtol=1e-6)
    if ties:
        assert ti[0].tolist() == list(range(k))
        assert ti[2, :2].tolist() == [1, 3][:k]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("capacity", [2, 3, 8, 24])
def test_make_dispatch_matches_jax(capacity, masked):
    """The dispatch 0/1 tensor exactly, combine to 1e-6, at tight and
    lossless capacity, with and without a token mask."""
    T = 24
    logits = _routing(T, ties=True)
    gates, idx, _ = je.top_k_routing(jnp.asarray(logits), K)
    mask = _mask(T) if masked else None
    jd, jc = je.make_dispatch(gates, idx, E, capacity,
                              None if mask is None else jnp.asarray(mask))
    td, tc = te.make_dispatch(torch.from_numpy(np.array(gates)),
                              torch.from_numpy(np.array(idx)).long(), E,
                              capacity,
                              None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    if masked:
        assert float(td[~torch.from_numpy(mask)].abs().sum()) == 0.0


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("capacity", [2, 5, 24])
def test_sparse_slots_match_jax(capacity, masked):
    """Slots, source tokens, keep flags and the sort order, exactly."""
    T = 24
    _, idx, _ = je.top_k_routing(jnp.asarray(_routing(T, seed=3)), K)
    mask = _mask(T, seed=4) if masked else None
    want = je.sparse_slots(idx, E, capacity,
                           None if mask is None else jnp.asarray(mask))
    got = te.sparse_slots(torch.from_numpy(np.array(idx)).long(), E,
                          capacity,
                          None if mask is None else torch.from_numpy(mask))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("masked", [False, True])
def test_load_balance_loss_matches_jax(masked):
    T = 40
    logits = _routing(T, seed=5)
    _, idx, probs = je.top_k_routing(jnp.asarray(logits), K)
    mask = _mask(T, seed=6) if masked else None
    want = je.load_balance_loss(probs, idx, E,
                                None if mask is None else jnp.asarray(mask))
    got = te.load_balance_loss(
        torch.from_numpy(np.array(probs)),
        torch.from_numpy(np.array(idx)).long(), E,
        None if mask is None else torch.from_numpy(mask))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    uniform = te.load_balance_loss(torch.full((8, E), 1.0 / E),
                                   torch.arange(8)[:, None] % E, E)
    assert float(uniform) == pytest.approx(1.0)


def _both_ffn(params, x, mode, mask=None, **kw):
    tree, tp = params
    jy, ja = je.moe_ffn(jnp.asarray(x), tree, top_k=K, dispatch_mode=mode,
                        token_mask=None if mask is None else jnp.asarray(mask),
                        **kw)
    ty, ta = te.moe_ffn(torch.from_numpy(x), tp, top_k=K, dispatch_mode=mode,
                        token_mask=None if mask is None
                        else torch.from_numpy(mask), **kw)
    return (np.asarray(jy), float(ja)), (ty.numpy(), float(ta))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cf", [0.5, 1.0, 4.0], ids=["tight", "cf1",
                                                      "lossless"])
@pytest.mark.parametrize("mode", ["dense", "sparse", "dropless"])
def test_moe_ffn_matches_jax(params, mode, cf, masked):
    """Outputs to 1e-5 and aux to 1e-6 in every mode, at tight capacity
    (where tokens drop: the dense and sparse outputs equal JAX's only if
    the same tokens drop) and at lossless capacity."""
    T = 40
    x = _x(T, seed=8)
    (jy, ja), (ty, ta) = _both_ffn(params, x, mode,
                                   _mask(T) if masked else None,
                                   capacity_factor=cf)
    np.testing.assert_allclose(ty, jy, **TOL)
    assert ta == pytest.approx(ja, rel=1e-6)
    if cf == 0.5 and mode != "dropless":
        # Tight capacity drops tokens: the output differs from dropless.
        lossless, _ = te.moe_ffn(torch.from_numpy(x), params[1], top_k=K,
                                 dispatch_mode="dropless")
        assert not np.allclose(ty, lossless.numpy(), atol=1e-3)


@pytest.mark.parametrize("mode", ["dense", "sparse", "dropless"])
def test_moe_ffn_gradients_match_jax(params, mode):
    """Gradients of sum(y²) + aux in the input and every parameter (the
    router's through the gates and the probabilities), at tight capacity
    for the capacity modes."""
    tree, tp = params
    x = _x(32, seed=9)
    mask = _mask(32, seed=10)

    def jloss(p, x_):
        y, aux = je.moe_ffn(x_, p, top_k=K, capacity_factor=0.75,
                            dispatch_mode=mode, token_mask=jnp.asarray(mask))
        return jnp.sum(y ** 2) + aux

    want = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = te.moe_ffn(tx, leaves, top_k=K, capacity_factor=0.75,
                        dispatch_mode=mode, token_mask=torch.from_numpy(mask))
    got = torch.autograd.grad((y ** 2).sum() + aux,
                              [leaves[k] for k in sorted(leaves)] + [tx])
    for g, name in zip(got, sorted(leaves)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[0][name]),
                                   atol=1e-5, rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(got[-1].numpy(), np.asarray(want[1]),
                               atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("mode", ["dense", "sparse", "dropless"])
def test_token_mask_leaves_no_capacity_footprint(params, mode):
    """At a pinned tight capacity the active tokens' outputs equal a run
    without the masked tokens at all; masked rows are exactly zero and
    the aux loss ignores them (JAX ``test_expert.py:192``)."""
    _, tp = params
    T, C = 16, 2
    x = torch.from_numpy(_x(T, seed=11))
    mask = torch.arange(T) < T // 2
    y, aux = te.moe_ffn(x, tp, top_k=K, capacity=C, dispatch_mode=mode,
                        token_mask=mask)
    solo, aux_solo = te.moe_ffn(x[:T // 2], tp, top_k=K, capacity=C,
                                dispatch_mode=mode)
    np.testing.assert_allclose(y[:T // 2].numpy(), solo.numpy(), **TOL)
    assert torch.equal(y[T // 2:], torch.zeros(T // 2, D))
    assert float(aux) == pytest.approx(float(aux_solo), rel=1e-6)


@pytest.mark.parametrize("mode", ["dense", "sparse", "dropless"])
def test_int8_expert_leaves_match_jax(params, mode):
    """Experts quantized to int8 ``{"q8", "s"}`` leaves (the router
    stays fp32): each quantizer's leaves bit for bit, and the layer's
    outputs against JAX's on its own quantized leaves."""
    tree, tp = params
    jq = dict(tree, **{n: jax.tree.map(np.asarray, jquant.quantize_weight(
        jnp.asarray(tree[n]))) for n in ("w_gate", "w_up", "w_down")})
    tq = dict(tp, **{n: tquant.quantize_weight(tp[n])
                     for n in ("w_gate", "w_up", "w_down")})
    for n in ("w_gate", "w_up", "w_down"):
        assert np.array_equal(tq[n]["q8"].numpy(), jq[n]["q8"])
    qtree = (jq, _torch_tree(jq))
    x = _x(24, seed=12)
    mask = _mask(24, seed=13)
    (jy, ja), (ty, ta) = _both_ffn(qtree, x, mode, mask, capacity_factor=1.0)
    np.testing.assert_allclose(ty, jy, **TOL)
    assert ta == pytest.approx(ja, rel=1e-6)
    plain, _ = te.moe_ffn(torch.from_numpy(x), tp, top_k=K,
                          dispatch_mode=mode, capacity_factor=1.0,
                          token_mask=torch.from_numpy(mask))
    assert 0 < np.abs(ty - plain.numpy()).max() < 0.05 * np.abs(ty).max()


@pytest.mark.parametrize("mode,reads", [("dense", []), ("sparse", []),
                                        ("dropless", ["tolist"])])
def test_host_reads_per_layer_call(params, mode, reads, monkeypatch):
    """Dense and sparse dispatch read nothing on the host; dropless reads
    its expert segment sizes once per call, and counts it."""
    _, tp = params
    x = torch.from_numpy(_x(24, seed=14))
    mask = torch.from_numpy(_mask(24, seed=15))
    seen = []

    def counted(name, orig):
        return lambda *a, **k: seen.append(name) or orig(*a, **k)

    for name in ("item", "tolist", "numpy", "__int__", "__index__",
                 "__bool__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name,
                            counted(name, getattr(torch.Tensor, name)))
    before = te._dropless_ffn.host_reads
    te.moe_ffn(x, tp, top_k=K, dispatch_mode=mode, token_mask=mask)
    monkeypatch.undo()
    assert seen == reads
    assert te._dropless_ffn.host_reads - before == len(reads)


def test_init_moe_params_layout_and_refusals(params):
    tree, _ = params
    g = torch.Generator().manual_seed(3)
    p = te.init_moe_params(g, D, F, E, dtype=torch.bfloat16)
    for name, want in tree.items():
        assert tuple(p[name].shape) == want.shape, name
    assert p["router"].dtype == torch.float32
    assert p["w_down"].dtype == torch.bfloat16
    assert abs(float(p["router"].std()) - 0.02) < 0.005
    q = te.init_moe_params(torch.Generator().manual_seed(3), D, F, E,
                           dtype=torch.bfloat16)
    assert all(torch.equal(p[n], q[n]) for n in p)
    x = torch.zeros(4, D)
    with pytest.raises(ValueError, match="dispatch_mode"):
        te.moe_ffn(x, p, dispatch_mode="scatter")
    # The three mesh calls raised before expert parallelism was ported;
    # on a one-rank ep mesh each now gives what JAX gives on one device
    # (the 4-rank ep meshes are in test_torch_mesh.py).
    from nbdistributed_tpu.parallel.mesh import make_mesh as jax_mesh
    from nbdistributed_tpu_torch.parallel import make_mesh
    jm = jax_mesh({"ep": 1}, devices=jax.devices()[:1])
    tm = make_mesh({"ep": 1})
    xs = _x(16)
    jp = jax.tree.map(jnp.asarray, tree)
    _, tp = params
    for mode in ("dense", "sparse", "dropless"):
        got, aux = te.moe_ffn(torch.from_numpy(xs), tp, top_k=K, mesh=tm,
                              dispatch_mode=mode)
        want, jaux = je.moe_ffn(jnp.asarray(xs), jp, top_k=K, mesh=jm,
                                dispatch_mode=mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
        assert float(aux) == pytest.approx(float(jaux), rel=1e-6)
    assert ({k: tuple(v) for k, v in te.moe_param_shardings().items()}
            == {k: tuple(v) for k, v in je.moe_param_shardings().items()})
    logits = xs @ tree["router"]
    got = te._dropless_ffn_ep(torch.from_numpy(xs), tp,
                              torch.from_numpy(logits), K, E, tm, "ep",
                              1.25)
    want = je._dropless_ffn_ep(jnp.asarray(xs), jp, jnp.asarray(logits), K,
                               E, jm, "ep", 1.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
