"""The port's flash-attention forward (K1) against the JAX package's
Pallas kernel, which runs in interpret mode on the CPU.

Inputs come from a numpy seed and go through both packages.  On CPU
tensors the port's wrapper takes its plain version, so these tests hold
that plain version — the function the CUDA kernel is compared with on
the card — to the TPU kernel.  Tolerance for fp32: 2e-5 absolute and
relative, since the Pallas kernel sums blockwise with the online
softmax and the plain version in one pass.
"""

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
    return q, k, v


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
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_forward_plain_matches_pallas_interpret(case):
    _, B, Sq, Sk, H, Hkv, D, causal, window, segs, offsets = case
    q, k, v = _inputs(1, B, Sq, Sk, H, Hkv, D)
    seg = None
    if segs:
        seg = np.sort(np.random.default_rng(2).integers(0, 3, (B, Sq)),
                      axis=1).astype(np.int32)
    scale = 1.0 / np.sqrt(D)
    j_out, j_lse = jattn._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        scale=scale, block_q=16, block_k=16, interpret=True,
        offsets=offsets, window=window,
        segment_ids=None if seg is None else jnp.asarray(seg),
        kv_segment_ids=None if seg is None else jnp.asarray(seg))
    t_seg = None if seg is None else torch.from_numpy(seg)
    t_out, t_lse = tattn._flash_forward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, scale=scale, offsets=offsets, window=window,
        segment_ids=t_seg, kv_segment_ids=t_seg)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(t_lse.numpy(), _jax_lse(j_lse, B, H, Sq),
                               **TOL)


def test_public_flash_attention_and_reference_match_jax():
    """flash_attention and attention_reference (the use_flash=False
    path) against the JAX package's, at its default block sizes."""
    q, k, v = _inputs(3, 1, 24, 24, 4, 2, 16)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    want = np.asarray(jattn.flash_attention(jq, jk, jv, True))
    np.testing.assert_allclose(flash_attention(tq, tk, tv).numpy(), want,
                               **TOL)
    want_ref = np.asarray(jattn.attention_reference(jq, jk, jv, window=5))
    got_ref = tattn.attention_reference(tq, tk, tv, window=5).numpy()
    np.testing.assert_allclose(got_ref, want_ref, **TOL)


def test_wrapper_refuses_what_it_cannot_run():
    """No silent fallback: mixed or non-CPU/CUDA devices and a window
    without causality raise; gradients flow through the plain
    backward; launches stay 0 on the CPU."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(4, 1, 8, 8, 2, 1, 16))
    before = flash_attention.launches
    flash_attention(q, k, v)
    assert flash_attention.launches == before == 0
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="CPU tensors"):
        flash_attention(*meta)
    qg = q.clone().requires_grad_()
    dq, = torch.autograd.grad(flash_attention(qg, k, v).sum(), qg)
    assert dq.shape == q.shape and torch.isfinite(dq).all()
    assert dq.abs().sum() > 0
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_attention(q[:, :4], k, v,
                        segment_ids=torch.zeros(1, 4, dtype=torch.int32))
    assert flash_attention.launches == 0
    assert tattn.flash_attention_bwd_dq.launches == 0
    assert tattn.flash_attention_bwd_dkv.launches == 0


def test_kernel_launch_on_a_cpu_box_raises_not_falls_back(monkeypatch):
    """Driving the CUDA launcher where there is no toolkit raises a
    clear error; it never runs the plain version in its place."""
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    from nbdistributed_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    q, k, v = (torch.from_numpy(x) for x in _inputs(5, 1, 8, 8, 2, 1, 32))
    args = dict(causal=True, scale=0.25, offsets=(0, 0), window=None,
                segment_ids=None, kv_segment_ids=None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tattn._flash_forward_cuda(q, k, v, **args)
    out, lse = tattn._flash_forward_plain(q, k, v, **args)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tattn._flash_backward_cuda(q, k, v, out, lse, torch.ones_like(q),
                                   **args)
    assert flash_attention.launches == 0
    assert tattn.flash_attention_bwd_dq.launches == 0
    assert tattn.flash_attention_bwd_dkv.launches == 0
