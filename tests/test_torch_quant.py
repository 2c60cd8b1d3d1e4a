"""The port's int8 / int4 weight quantization against the JAX package's
on the CPU: nibble packing, the quantizers' leaves (integers bit for
bit, scales to 1 ulp), ``qlinear``, ``forward`` and greedy ``generate``
on quantized trees, ``quantization_error``, and the quantized tree's
round trip through ``convert.py``; ``quantize_moe_params`` and the
nested ``quantization_error`` of the MoE family.

Both packages quantize the same parameters (JAX init at ``tiny_config``
float32, converted with ``params_from_jax``).  Products of quantized
weights agree to rtol 1e-5 (fp32 sums in different orders; atol 1e-5 of
the output's largest magnitude for the elements near zero).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbdistributed_tpu.models import quant as jquant
from nbdistributed_tpu.models import transformer as jtf
from nbdistributed_tpu.models.generate import generate as jgenerate
from nbdistributed_tpu.models import moe as jmoe
from nbdistributed_tpu_torch.models import (DecodeServer, forward, generate,
                                            moe_forward, params_from_jax,
                                            params_to_numpy, qlinear, quant,
                                            tiny_config, tiny_moe_config)
from nbdistributed_tpu_torch.models.transformer import (_pack_nibbles,
                                                        _unpack_nibbles,
                                                        layer_params)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = jtf.tiny_config(dtype=jnp.float32, use_flash=False)
    tree = jax.tree.map(np.asarray,
                        jtf.init_params(jax.random.PRNGKey(0), jcfg))
    cfg = tiny_config(dtype=torch.float32)
    return (jcfg, jax.tree.map(jnp.asarray, tree), cfg,
            params_from_jax(tree, cfg, device="cpu"))


QUANTIZERS = {"int8": (jquant.quantize_params, quant.quantize_params),
              "int4": (jquant.quantize_params4, quant.quantize_params4)}


def _leaves(tree):
    """(path, array) of a nested dict of arrays, in sorted-key order."""
    out = []
    for key in sorted(tree):
        v = tree[key]
        out += ([(f"{key}/{p}", a) for p, a in _leaves(v)]
                if isinstance(v, dict) else [(key, np.asarray(v))])
    return out


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    atol = 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _same_scales(got, want):
    """fp32 scales within one ulp."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.all(np.abs(got - want) <= np.spacing(np.abs(want))), \
        np.abs(got - want).max()


@pytest.mark.parametrize("shape", [(6, 10), (3, 8, 5)])
def test_nibble_pack_unpack_match_jax(shape):
    q = np.random.default_rng(len(shape)).integers(-7, 8, shape,
                                                   dtype=np.int32)
    got = _pack_nibbles(torch.from_numpy(q))
    want = np.asarray(jtf._pack_nibbles(jnp.asarray(q)))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    back = _unpack_nibbles(got, torch.float32)
    assert np.array_equal(back.numpy(), q.astype(np.float32))
    assert np.array_equal(back.numpy(), np.asarray(
        jtf._unpack_nibbles(jnp.asarray(want), jnp.float32)))


@pytest.mark.parametrize("group", [2, 32, 64])
def test_quantize_weight4_matches_jax(group):
    w = np.random.default_rng(group).standard_normal(
        (2, 128, 24)).astype(np.float32)
    got = quant.quantize_weight4(torch.from_numpy(w), group=group)
    want = jquant.quantize_weight4(jnp.asarray(w), group=group)
    assert np.array_equal(got["q4"].numpy(), np.asarray(want["q4"]))
    assert got["s"].shape == (2, 128 // group, 1, 24)
    _same_scales(got["s"].numpy(), want["s"])
    deq = quant.dequantize_weight4(got)
    assert np.array_equal(deq.numpy(), np.asarray(
        jquant.dequantize_weight4(want)))
    with pytest.raises(ValueError, match="divide"):
        quant.quantize_weight4(torch.from_numpy(w), group=48)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantize_params_leaves_match_jax(setup, kind):
    """Every leaf of the quantized tree: integers bit for bit, scales to
    one ulp, unquantized leaves passed through by reference."""
    _, jparams, _, params = setup
    jq, tq = QUANTIZERS[kind]
    got, want = _leaves(params_to_numpy(tq(params))), _leaves(jq(jparams))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if path.endswith("/s"):
            _same_scales(a, b)
        else:
            assert np.array_equal(a, b), path
    q = tq(params)
    assert q["embed"] is params["embed"]
    assert q["layers"]["attn_norm"] is params["layers"]["attn_norm"]


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_qlinear_matches_jax(setup, kind):
    _, jparams, _, params = setup
    jq, tq = QUANTIZERS[kind]
    jw, tw = jq(jparams)["layers"]["w_up"], tq(params)["layers"]["w_up"]
    x = np.random.default_rng(1).standard_normal((2, 3, 128)).astype(
        np.float32)
    for i in range(2):
        got = qlinear(torch.from_numpy(x), {k: v[i] for k, v in tw.items()})
        want = jtf.qlinear(jnp.asarray(x), {k: v[i] for k, v in jw.items()})
        _close(got.numpy(), want)


def test_stacked_int4_leaf_refused():
    w = quant.quantize_weight4(torch.ones(2, 64, 8), group=64)
    with pytest.raises(ValueError, match="stacked int4"):
        qlinear(torch.ones(1, 64), w)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_forward_on_quantized_params_matches_jax(setup, kind):
    jcfg, jparams, cfg, params = setup
    jq, tq = QUANTIZERS[kind]
    tokens = np.random.default_rng(2).integers(0, 512, (2, 24),
                                               dtype=np.int32)
    got = forward(tq(params), torch.from_numpy(tokens), cfg)
    want = jtf.forward(jq(jparams), jnp.asarray(tokens), jcfg)
    _close(got.numpy(), want)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantized_generate_and_serving_match_jax(setup, kind):
    """Greedy tokens on a quantized tree: the port's ``generate``, the
    JAX package's, and the port's server all agree."""
    jcfg, jparams, cfg, params = setup
    jq, tq = QUANTIZERS[kind]
    qp = tq(params)
    prompt = [5, 9, 2, 7, 1]
    got = generate(qp, [prompt], cfg, 8)[0, 5:].tolist()
    want = np.asarray(jgenerate(jq(jparams), jnp.asarray([prompt]), jcfg,
                                8))[0, 5:].tolist()
    assert got == want
    srv = DecodeServer(qp, cfg, max_batch=2, max_len=32, pad_to=4)
    rid = srv.submit(prompt, 8)
    srv.run_until_done(max_steps=20)
    assert srv.outputs[rid] == want


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantization_error_matches_jax(setup, kind):
    _, jparams, _, params = setup
    jq, tq = QUANTIZERS[kind]
    got = quant.quantization_error(params, tq(params))
    want = jquant.quantization_error(jparams, jq(jparams))
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == pytest.approx(want[name], rel=1e-5), name
    hi = 0.01 if kind == "int8" else 0.2
    assert all(0 < v < hi for v in got.values())


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantized_tree_crosses_convert_both_ways(setup, kind):
    """The JAX package's quantized tree -> the port -> numpy: every
    member bit for bit in its own dtype; the port's forward on it equals
    the port's own quantization."""
    _, jparams, cfg, params = setup
    jq, tq = QUANTIZERS[kind]
    jtree = jax.tree.map(np.asarray, jq(jparams))
    ported = params_from_jax(jtree, cfg, device="cpu")
    head = ported["lm_head"]
    assert head["q8" if kind == "int8" else "q4"].dtype == (
        torch.int8 if kind == "int8" else torch.uint8)
    back = _leaves(params_to_numpy(ported))
    for (path, a), (_, b) in zip(back, _leaves(jtree)):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    tokens = torch.tensor([[3, 1, 4, 1, 5]])
    assert torch.equal(forward(ported, tokens, cfg),
                       forward(params_from_jax(
                           params_to_numpy(tq(params)), cfg, device="cpu"),
                           tokens, cfg))
    bad = dict(jtree, lm_head={k: v[:-2] for k, v in jtree["lm_head"].items()})
    with pytest.raises(ValueError, match="lm_head"):
        params_from_jax(bad, cfg, device="cpu")


def test_layer_params_slices_quantized_leaves(setup):
    _, _, _, params = setup
    q4 = quant.quantize_params4(params)
    layer = layer_params(q4, 1)
    assert torch.equal(layer["wq"]["q4"], q4["layers"]["wq"]["q4"][1])
    assert torch.equal(layer["wq"]["s"], q4["layers"]["wq"]["s"][1])
    assert torch.equal(layer["attn_norm"], params["layers"]["attn_norm"][1])
    with pytest.raises(ValueError, match="unknown quantization target"):
        quant.quantize_params(params, targets=("wq", "w_nope"))


@pytest.fixture(scope="module")
def moe_setup():
    jcfg = jmoe.tiny_moe_config(dtype=jnp.float32, use_flash=False)
    tree = jax.tree.map(np.asarray,
                        jmoe.init_moe_model(jax.random.PRNGKey(0), jcfg))
    cfg = tiny_moe_config(dtype=torch.float32)
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, params_from_jax(
        tree, cfg, device="cpu")


@pytest.mark.parametrize("quantize_lm_head", [True, False])
def test_quantize_moe_params_matches_jax(moe_setup, quantize_lm_head):
    """The attention projections and the experts int8, bit for bit
    (scales to one ulp); the router, norms and embedding untouched and
    passed through by reference."""
    _, jparams, _, params = moe_setup
    got_tree = quant.quantize_moe_params(params, quantize_lm_head)
    got = _leaves(params_to_numpy(got_tree))
    want = _leaves(jquant.quantize_moe_params(jparams, quantize_lm_head))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if path.endswith("/s"):
            _same_scales(a, b)
        else:
            assert np.array_equal(a, b), path
    moe = got_tree["layers"]["moe"]
    assert moe["router"] is params["layers"]["moe"]["router"]
    assert moe["w_down"]["q8"].dtype == torch.int8
    assert (got_tree["lm_head"] is params["lm_head"]) != quantize_lm_head
    assert quant.EXPERT_TARGETS == jquant.EXPERT_TARGETS


def test_moe_quantization_error_matches_jax(moe_setup):
    """The nested walk: the same keys (``"moe.w_gate"``, ...) and
    values."""
    _, jparams, _, params = moe_setup
    got = quant.quantization_error(params, quant.quantize_moe_params(params))
    want = jquant.quantization_error(jparams,
                                     jquant.quantize_moe_params(jparams))
    assert sorted(got) == sorted(want)
    assert {"moe.w_gate", "moe.w_up", "moe.w_down", "wq", "lm_head"} <= \
        set(got)
    for name in want:
        assert got[name] == pytest.approx(want[name], rel=1e-5), name


def test_moe_forward_on_quantized_params_matches_jax(moe_setup):
    jcfg, jparams, cfg, params = moe_setup
    tokens = np.random.default_rng(3).integers(0, 512, (2, 16),
                                               dtype=np.int32)
    got, aux = moe_forward(quant.quantize_moe_params(params),
                           torch.from_numpy(tokens), cfg)
    want, jaux = jmoe.moe_forward(jquant.quantize_moe_params(jparams),
                                  jnp.asarray(tokens), jcfg)
    _close(got.numpy(), want)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)
