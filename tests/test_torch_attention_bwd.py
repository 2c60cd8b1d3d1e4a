"""The port's flash-attention backward against the JAX package's Pallas
backward (dQ and dK/dV kernels), which runs in interpret mode on the
CPU.

Inputs come from a numpy seed and go through both packages.  On CPU
tensors the port's wrapper takes its plain version, so these tests hold
``_flash_backward_plain`` — the function the CUDA kernels K2/K3 are
compared with on the card — and the autograd path through it to the
TPU kernels.  Tolerance for fp32: 2e-5 absolute and relative, since the
Pallas kernels sum blockwise and the plain version in one pass.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbdistributed_tpu.ops import attention as jattn
from nbdistributed_tpu_torch.ops import attention as tattn
from nbdistributed_tpu_torch.ops import flash_attention


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast, and leaves the
    cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, B, Sq, Sk, H, Hkv, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D), dtype=np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D), dtype=np.float32)
    g = rng.standard_normal((B, Sq, H, D), dtype=np.float32)
    return q, k, v, g


def _segments(B, S, seed=2):
    return np.sort(np.random.default_rng(seed).integers(0, 3, (B, S)),
                   axis=1).astype(np.int32)


def _jax_lse(lse, B, H, Sq):
    """(B*Hkv, group, Sq_pad) -> (B, H, Sq)."""
    lse = np.asarray(lse)
    return lse.reshape(B, H, lse.shape[-1])[..., :Sq]


# (name, B, Sq, Sk, H, Hkv, D, causal, window, segments, offsets)
CASES = [
    ("causal_ragged_gqa", 2, 37, 37, 4, 2, 16, True, None, False, None),
    ("noncausal_ragged_sq_ne_sk", 1, 19, 37, 4, 2, 16, False, None, False,
     None),
    ("window", 1, 40, 40, 4, 2, 16, True, 8, False, None),
    ("segments", 2, 32, 32, 4, 2, 16, True, None, True, None),
    ("offsets", 1, 16, 32, 2, 1, 16, True, None, False, (16, 0)),
    ("mha_group1", 1, 24, 24, 2, 2, 16, True, None, False, None),
    ("group4_window_offsets", 1, 20, 36, 8, 2, 16, True, 6, False,
     (16, 0)),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_backward_plain_matches_pallas_interpret(case):
    """``_flash_backward`` (CPU: the plain version) against the JAX
    ``_flash_backward`` — both Pallas backward kernels — from the same
    forward residuals (out and lse of the JAX forward)."""
    _, B, Sq, Sk, H, Hkv, D, causal, window, segs, offsets = case
    q, k, v, g = _inputs(1, B, Sq, Sk, H, Hkv, D)
    seg = _segments(B, Sq) if segs else None
    scale = 1.0 / np.sqrt(D)
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    jseg = None if seg is None else jnp.asarray(seg)
    common = dict(causal=causal, scale=scale, block_q=16, block_k=16,
                  interpret=True, offsets=offsets, window=window,
                  segment_ids=jseg, kv_segment_ids=jseg)
    j_out, j_lse = jattn._flash_forward(jq, jk, jv, **common)
    want = jattn._flash_backward(jq, jk, jv, j_out, j_lse, jg, **common)
    tseg = None if seg is None else torch.from_numpy(seg)
    got = tattn._flash_backward(
        *(torch.from_numpy(x) for x in (q, k, v)),
        torch.from_numpy(np.array(j_out)),
        torch.from_numpy(_jax_lse(j_lse, B, H, Sq).copy()),
        torch.from_numpy(g), causal=causal, scale=scale, offsets=offsets,
        window=window, segment_ids=tseg, kv_segment_ids=tseg)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=name)


def test_bwd_prep_delta_matches_jax():
    """delta = rowsum(dO * O), laid out (B, H, Sq) like the lse."""
    _, _, _, g = _inputs(7, 2, 21, 21, 6, 2, 16)
    o = np.random.default_rng(8).standard_normal(g.shape,
                                                 dtype=np.float32)
    _, _, j_delta = jattn._flash_bwd_prep(jnp.asarray(o), jnp.asarray(o),
                                          jnp.asarray(g), 16, 2)
    got = tattn._flash_bwd_prep(torch.from_numpy(o), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), _jax_lse(j_delta, 2, 6, 21),
                               **TOL)


# (name, B, S, H, Hkv, D, causal, window, segments)
VJP_CASES = [
    ("causal_gqa", 2, 24, 4, 2, 16, True, None, False),
    ("noncausal", 1, 20, 4, 2, 16, False, None, False),
    ("window", 1, 32, 4, 1, 16, True, 5, False),
    ("segments", 2, 32, 6, 2, 16, True, None, True),
]


@pytest.mark.parametrize("case", VJP_CASES, ids=[c[0] for c in VJP_CASES])
def test_flash_attention_autograd_matches_jax_vjp(case):
    """``flash_attention``'s gradients (autograd through
    ``_FlashAttention``) against ``jax.vjp`` of the JAX
    ``flash_attention`` (its ``custom_vjp``, Pallas in interpret mode);
    outputs too."""
    _, B, S, H, Hkv, D, causal, window, segs = case
    q, k, v, g = _inputs(3, B, S, S, H, Hkv, D)
    seg = _segments(B, S, seed=4) if segs else None
    jseg = None if seg is None else jnp.asarray(seg)
    j_out, vjp = jax.vjp(
        lambda a, b, c: jattn.flash_attention(a, b, c, causal, None, 16,
                                              16, window, jseg),
        *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal, None, window,
                          None if seg is None else torch.from_numpy(seg))
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               **TOL)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=name)


def test_plain_backward_matches_autograd_of_reference():
    """The plain backward from the saved lse equals autograd of
    ``attention_reference`` (the ``use_flash=False`` path) — the two
    paths the chip's full-width gradient check compares."""
    q, k, v, g = (torch.from_numpy(x)
                  for x in _inputs(5, 2, 30, 30, 6, 3, 16))
    seg = torch.from_numpy(_segments(2, 30, seed=6))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = tattn.attention_reference(*leaves, window=9, segment_ids=seg)
    want = torch.autograd.grad(ref, leaves, g)
    out, lse = tattn._flash_forward(q, k, v, causal=True, scale=0.25,
                                    window=9, segment_ids=seg)
    got = tattn._flash_backward_plain(q, k, v, out, lse, g, causal=True,
                                      scale=0.25, window=9,
                                      segment_ids=seg, kv_segment_ids=seg)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_backward_keeps_bf16_and_noncontiguous_grad():
    """Gradients come back in the inputs' dtype, and a non-contiguous
    output gradient (as a transposed view delivers it) is accepted."""
    q, k, v, _ = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in _inputs(9, 1, 16, 16, 4, 2, 16))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves)
    g = torch.ones(1, 4, 16, 16, dtype=torch.bfloat16).transpose(1, 2)
    assert not g.is_contiguous()
    dq, dk, dv = torch.autograd.grad(out, leaves, g)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert dk.shape == k.shape and torch.isfinite(dq.float()).all()
