"""The port's model stack against the JAX package on the CPU:
parameter conversion, ``forward``, ``forward_with_cache`` (including
the clamped cache write) and ``generate``.

Both packages get the same parameters (JAX init, converted with
``params_from_jax``) at ``tiny_config`` in float32.  Logits agree to
1e-4 absolute: two layers of fp32 matmuls summed in different orders
by XLA and by PyTorch, on logits of order 1-10.  Greedy tokens must be
equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbdistributed_tpu.models.generate import forward_with_cache as jfwc
from nbdistributed_tpu.models.generate import generate as jgenerate
from nbdistributed_tpu.models.generate import init_kv_cache as jinit_cache
from nbdistributed_tpu.models import transformer as jtf
from nbdistributed_tpu_torch.models import (forward, forward_with_cache,
                                            generate, init_kv_cache,
                                            init_params, params_from_jax,
                                            params_to_numpy, tiny_config)
from nbdistributed_tpu_torch.models.generate import _write_kv
from nbdistributed_tpu_torch.ops import (flash_attention,
                                         flash_decode_attention)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast, and leaves the
    cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def _jax_params(dtype, seed=0, **kw):
    cfg = jtf.tiny_config(dtype=dtype, use_flash=False, **kw)
    return cfg, jax.tree.map(np.asarray,
                             jtf.init_params(jax.random.PRNGKey(seed), cfg))


@pytest.fixture(scope="module")
def fp32():
    jcfg, tree = _jax_params(jnp.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_jax(tree, tiny_config(dtype=torch.float32),
                             device="cpu")
    return jcfg, jparams, params


def _tokens(seed, B, S, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trip_is_bit_exact(dtype):
    """JAX -> port -> numpy returns every leaf bit for bit (bf16 leaves
    compared through float32, which holds them exactly)."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    _, tree = _jax_params(jdt, seed=3)
    cfg = tiny_config(dtype=getattr(torch, dtype))
    params = params_from_jax(tree, cfg, device="cpu")
    assert params["layers"]["wq"].dtype == getattr(torch, dtype)
    assert params["layers"]["attn_norm"].dtype == torch.float32
    back = params_to_numpy(params)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(want)):
        assert a.dtype == np.float32 and a.shape == b.shape, path
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), path


def test_params_from_jax_checks_shapes_and_device():
    _, tree = _jax_params(jnp.float32)
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tree, tiny_config(d_ff=256), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            params_from_jax(tree, tiny_config(dtype=torch.float32))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_params(tiny_config(), 0)


def test_init_params_layout_and_seed():
    cfg = tiny_config(dtype=torch.float32)
    a = init_params(cfg, 5, device="cpu")
    b = init_params(cfg, 5, device="cpu")
    _, tree = _jax_params(jnp.float32)
    for (pa, x), (_, y) in zip(
            jax.tree_util.tree_leaves_with_path(params_to_numpy(a)),
            jax.tree_util.tree_leaves_with_path(tree)):
        assert x.shape == y.shape, pa
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert abs(float(a["embed"].std()) - 1.0) < 0.05


@pytest.mark.parametrize("use_flash", [True, False])
def test_forward_matches_jax(fp32, use_flash):
    jcfg, jparams, params = fp32
    cfg = tiny_config(dtype=torch.float32, use_flash=use_flash)
    toks = _tokens(0, 2, 24)
    want = np.asarray(jtf.forward(jparams, jnp.asarray(toks), jcfg))
    got = forward(params, toks, cfg).numpy()
    assert got.shape == (2, 24, 512) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    assert flash_attention.launches == 0


def test_forward_window_and_segments_match_jax():
    jcfg, tree = _jax_params(jnp.float32, sliding_window=5)
    jparams = jax.tree.map(jnp.asarray, tree)
    cfg = tiny_config(dtype=torch.float32, sliding_window=5)
    params = params_from_jax(tree, cfg, device="cpu")
    toks = _tokens(1, 2, 20)
    seg = np.repeat(np.array([[0, 1], [0, 0]], np.int32), 10, axis=1)
    want = np.asarray(jtf.forward(jparams, jnp.asarray(toks), jcfg,
                                  segment_ids=jnp.asarray(seg)))
    got = forward(params, toks, cfg, segment_ids=seg).numpy()
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


@pytest.mark.parametrize("quantized", [False, True])
def test_forward_with_cache_prefill_then_decode_matches_jax(fp32,
                                                            quantized):
    """Prefill at a scalar pointer, then a decode step at per-row
    pointers with ``last_index`` / ``last_only`` — logits and the cache
    itself against JAX."""
    jcfg, jparams, params = fp32
    cfg = tiny_config(dtype=torch.float32)
    toks = _tokens(2, 2, 6)
    jc = jinit_cache(jcfg, 2, 16, quantized=quantized)
    tc = init_kv_cache(cfg, 2, 16, quantized=quantized, device="cpu")
    jl, jc = jfwc(jparams, jnp.asarray(toks), jc, 0, jcfg,
                  last_index=jnp.asarray([5, 3]))
    tl, tc = forward_with_cache(params, toks, tc, 0, cfg,
                                last_index=[5, 3])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    lens = np.array([6, 4], np.int32)
    step = np.array([[7], [9]], np.int32)
    jl, jc = jfwc(
        jparams, jnp.asarray(step), jc, jnp.asarray(lens),
        dataclasses.replace(jcfg, use_flash=True))
    tl, tc = forward_with_cache(params, step, tc, torch.from_numpy(lens),
                                cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for name in tc:
        want = np.asarray(jc[name]).astype(np.float32)
        got = tc[name].float().numpy()
        if name in ("k", "v") and quantized:
            # int8 codes: a rounding tie may land one code apart.
            assert np.max(np.abs(got - want)) <= 1, name
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5,
                                       err_msg=name)
    assert flash_decode_attention.launches == 0


@pytest.mark.parametrize("start", [0, 5, 14, -2, -20, [0, 14], [3, 9],
                                   [16, -2], [-20, 3]])
def test_cache_write_clamps_like_dynamic_update_slice(start):
    """The write start is clamped to [0, T - S] like
    ``jax.lax.dynamic_update_slice``, for a scalar pointer and for
    per-row pointers (the JAX package vmaps it per row)."""
    rng = np.random.default_rng(4)
    buf = rng.standard_normal((2, 3, 16, 4), dtype=np.float32)
    new = rng.standard_normal((2, 3, 5, 4), dtype=np.float32)
    if isinstance(start, list):
        want = jax.vmap(lambda c, u, s: jax.lax.dynamic_update_slice(
            c, u, (0, s, 0)))(jnp.asarray(buf), jnp.asarray(new),
                              jnp.asarray(start, jnp.int32))
        tstart = torch.tensor(start)
    else:
        want = jax.lax.dynamic_update_slice(jnp.asarray(buf),
                                            jnp.asarray(new),
                                            (0, 0, start, 0))
        tstart = start
    got = torch.from_numpy(buf.copy())
    _write_kv(got, torch.from_numpy(new), tstart)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kv_quantized", [False, True])
def test_generate_greedy_matches_jax(fp32, kv_quantized):
    jcfg, jparams, params = fp32
    prompt = _tokens(5, 2, 5)
    want = np.asarray(jgenerate(jparams, jnp.asarray(prompt), jcfg,
                                        8, kv_quantized=kv_quantized))
    got = generate(params, prompt, tiny_config(dtype=torch.float32), 8,
                   kv_quantized=kv_quantized).numpy()
    np.testing.assert_array_equal(got, want)


def test_generate_sampling_contract(fp32):
    _, _, params = fp32
    cfg = tiny_config(dtype=torch.float32)
    with pytest.raises(ValueError, match="Generator"):
        generate(params, [[1, 2]], cfg, 3, temperature=1.0)
    gen = torch.Generator().manual_seed(0)
    out = generate(params, [[1, 2]], cfg, 4, temperature=0.8, top_k=5,
                   top_p=0.9, generator=gen)
    assert out.shape == (1, 6) and int(out.max()) < cfg.vocab_size
    assert torch.equal(generate(params, [[1, 2]], cfg, 0),
                       torch.tensor([[1, 2]]))
