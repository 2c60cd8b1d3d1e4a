"""The port's flash-decode (K4) against the JAX package's Pallas decode
kernel, which runs in interpret mode on the CPU.

On CPU tensors the wrapper takes its plain version, the function the
CUDA kernel is held to on the card.  Cases cover per-row positions at
0 and T-1, a window, a position past the cache end whose window lies
beyond every valid key (the all-masked guard), an int8 cache with
scales, and the lse.  Tolerance for fp32: 2e-5 absolute and relative
(blockwise online softmax against a one-pass softmax).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbdistributed_tpu.ops.decode import \
    flash_decode_attention as jax_decode
from nbdistributed_tpu_torch.models.generate import _cached_attention
from nbdistributed_tpu_torch.ops import flash_decode_attention
from nbdistributed_tpu_torch.ops._common import NEG_INF


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast, and leaves the
    cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(atol=2e-5, rtol=2e-5)
B, HKV, GROUP, D, T = 4, 2, 2, 16, 40


def _inputs(seed, int8=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, HKV * GROUP, D), dtype=np.float32)
    shape = (B, HKV, T, D)
    if int8:
        kc = rng.integers(-127, 128, shape).astype(np.int8)
        vc = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (B, HKV, T, 1)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (B, HKV, T, 1)).astype(np.float32)
        return q, kc, vc, ks, vs
    kc = rng.standard_normal(shape, dtype=np.float32)
    vc = rng.standard_normal(shape, dtype=np.float32)
    return q, kc, vc, None, None


POS_SETS = {"edges": [0, T - 1, 17, 5], "overshoot": [0, T - 1, 17, T + 10]}
CASES = [("plain", "edges", None, False),
         ("window", "edges", 8, False),
         ("window_overshoot", "overshoot", 8, False),
         ("int8", "edges", None, True),
         ("int8_window", "edges", 8, True)]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_decode_plain_matches_pallas_interpret(case):
    _, pos_set, window, int8 = case
    q, kc, vc, ks, vs = _inputs(7, int8)
    pos = np.asarray(POS_SETS[pos_set], np.int32)
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    j_out, j_lse = jax_decode(j(q), j(kc), j(vc), j(pos), block_k=16,
                              window=window, k_s=j(ks), v_s=j(vs),
                              return_lse=True)
    t_out, t_lse = flash_decode_attention(t(q), t(kc), t(vc), t(pos),
                                          window=window, k_s=t(ks),
                                          v_s=t(vs), return_lse=True)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), **TOL)
    if pos_set == "overshoot":
        # Window [T+1, T+11) lies past every valid key: nothing attends.
        assert np.all(t_out.numpy()[3] == 0)
        assert np.all(t_lse.numpy()[3] == np.float32(NEG_INF))
    assert flash_decode_attention.launches == 0


def test_decode_equals_cached_attention_at_one_token():
    """The plain version is _cached_attention at S = 1 for in-range
    positions (same masks, same fp32 math)."""
    q, kc, vc, _, _ = _inputs(8)
    pos = torch.tensor([0, T - 1, 17, 5])
    scale = 1.0 / np.sqrt(D)
    for window in (None, 8):
        got = flash_decode_attention(torch.from_numpy(q),
                                     torch.from_numpy(kc),
                                     torch.from_numpy(vc), pos,
                                     window=window)
        want = _cached_attention(torch.from_numpy(q)[:, None],
                                 torch.from_numpy(kc),
                                 torch.from_numpy(vc), pos[:, None], scale,
                                 window=window)
        np.testing.assert_allclose(got.reshape(B, -1).numpy(),
                                   want[:, 0].numpy(), **TOL)


def test_decode_wrapper_validates_and_never_falls_back():
    q, kc, vc, ks, vs = (None if x is None else torch.from_numpy(x)
                         for x in _inputs(9, int8=True))
    pos = torch.zeros(B, dtype=torch.int32)
    with pytest.raises(ValueError, match="both k_s and v_s"):
        flash_decode_attention(q, kc, vc, pos, k_s=ks)
    with pytest.raises(ValueError, match="window"):
        flash_decode_attention(q, kc, vc, pos, k_s=ks, v_s=vs, window=0)
    with pytest.raises(ValueError, match="CPU tensors"):
        flash_decode_attention(q.to("meta"), kc.to("meta"), vc.to("meta"),
                               pos.to("meta"), k_s=ks.to("meta"),
                               v_s=vs.to("meta"))
    with pytest.raises(ValueError, match="pos must be"):
        flash_decode_attention(q, kc, vc, pos[:2], k_s=ks, v_s=vs)
    assert flash_decode_attention.launches == 0


def test_kernel_launch_on_a_cpu_box_raises_not_falls_back(monkeypatch):
    """Driving the CUDA launcher where there is no toolkit raises a
    clear error; it never runs the plain version in its place."""
    from nbdistributed_tpu_torch.ops import _build
    from nbdistributed_tpu_torch.ops import decode as tdecode
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    rng = np.random.default_rng(10)
    q = torch.from_numpy(rng.standard_normal((2, 4, 32), dtype=np.float32))
    kc = torch.from_numpy(rng.standard_normal((2, 2, 8, 32),
                                              dtype=np.float32))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tdecode._decode_cuda(q, kc, kc.clone(), torch.tensor([0, 7]),
                             scale=0.2, window=None, k_s=None, v_s=None,
                             return_lse=True)
    assert flash_decode_attention.launches == 0
