"""The split of flash-decode (K4, ``csrc/flash_decode.cu``), mirrored
on the CPU.

The kernel runs only on the card.  What it computes besides the plain
softmax is bookkeeping: ``_decode_splits`` (the wrapper's choice of
nsplit and chunk, from B * Hkv and T alone), each block's chunk bounds
and early exit, each warp's share of a key tile and its online softmax
in the log2 domain, the merge of the four warps, and the combine of the
chunks' partials by their lse.  ``split_decode`` below follows
``decode_split_kernel`` and ``decode_combine_kernel`` step for step in
fp32 and is held to ``decode_reference`` (1e-6: the same fp32 math,
summed in another order) and to the JAX package's Pallas decode kernel
in interpret mode (2e-5, as ``tests/test_torch_decode.py``).
"""

import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbdistributed_tpu.ops.decode import \
    flash_decode_attention as jax_decode
from nbdistributed_tpu_torch.ops import decode as tdecode
from nbdistributed_tpu_torch.ops._common import NEG_INF

SRC = (Path(__file__).resolve().parents[1] / "nbdistributed_tpu_torch"
       / "ops" / "csrc" / "flash_decode.cu")
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
WARPS = 4                                    # csrc kWarps
TOL_PLAIN = dict(atol=1e-6, rtol=1e-6)
TOL_JAX = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast, and leaves the
    cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# csrc/flash_decode.cu, step for step

def tile(D, itemsize):
    """Tile<CT, D>: (keys per warp, keys per tile)."""
    row = D * itemsize
    lpk = 1 if row <= 64 else row // 64
    return 32 // lpk, WARPS * (32 // lpk)


def _warp_state(q2, k, v, ks, vs, tiles, w, kpw, k_lo, k_hi):
    """One warp's online softmax (log2 domain) over its kpw keys of each
    tile: (m, l, o) with m, l (G,) and o (G, D) unnormalized."""
    G, D = q2.shape
    m = torch.full((G,), NEG_INF)
    l = torch.zeros(G)
    o = torch.zeros(G, D)
    for t0 in tiles:
        t = torch.arange(t0 + w * kpw, t0 + (w + 1) * kpw)
        keep = (t >= k_lo) & (t < k_hi)
        tc = t.clamp(max=k.shape[0] - 1)
        s = (q2 @ k[tc].T) * ks[tc]
        x = torch.where(keep, s, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, x.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.where(keep, torch.exp2(x - m_new[:, None]), 0.0)
        l = l * corr + p.sum(-1)
        o = o * corr[:, None] + (p * vs[tc]) @ torch.where(
            keep[:, None], v[tc], 0.0)
        m = m_new
    return m, l, o


def split_decode(q, kc, vc, pos, *, scale, window=None, k_s=None,
                 v_s=None):
    """(out (B, H, D) fp32, lse (B, H)) as the kernels compute them."""
    B, H, D = q.shape
    Hkv, T = kc.shape[1], kc.shape[2]
    group = H // Hkv
    kpw, tk = tile(D, kc.element_size())
    nsplit, chunk = tdecode._decode_splits(B * Hkv, T)
    out = torch.zeros(B, H, D)
    lse = torch.full((B, H), NEG_INF)
    ones = torch.ones(T)
    for b in range(B):
        valid = int(pos[b]) + 1
        valid_k = min(valid, T)
        lo = valid - window if window else 0
        for hk in range(Hkv):
            rows = slice(hk * group, (hk + 1) * group)
            q2 = q[b, rows].float() * (scale * LOG2E)
            k, v = kc[b, hk].float(), vc[b, hk].float()
            ks = ones if k_s is None else k_s[b, hk, :, 0]
            vs = ones if v_s is None else v_s[b, hk, :, 0]
            parts = []                                # (m, l, o) per chunk
            for split in range(nsplit):
                c0 = split * chunk
                k_lo, k_hi = max(c0, max(lo, 0)), min(c0 + chunk, valid_k)
                if k_lo >= k_hi:                      # the early exit
                    parts.append((torch.full((group,), NEG_INF),
                                  torch.zeros(group), None))
                    continue
                tiles = range(c0 + (k_lo - c0) // tk * tk, k_hi, tk)
                ws = [_warp_state(q2, k, v, ks, vs, tiles, w, kpw, k_lo,
                                  k_hi) for w in range(WARPS)]
                M = torch.stack([s[0] for s in ws]).amax(0)
                a = [torch.exp2(s[0] - M) for s in ws]
                num = sum(ai[:, None] * s[2] for ai, s in zip(a, ws))
                den = sum(ai * s[1] for ai, s in zip(a, ws))
                parts.append((M, den, num))
            if nsplit == 1:
                M, den, num = parts[0]
                if num is not None:
                    out[b, rows] = num / den[:, None]
                    lse[b, rows] = M * LN2 + torch.log(den)
                continue
            # decode_combine_kernel: a chunk with l = 0 weighs nothing.
            live = [p for p in parts if p[2] is not None]
            M = torch.full((group,), NEG_INF)
            for m_i, l_i, _ in live:
                M = torch.where(l_i > 0, torch.maximum(M, m_i), M)
            num, den = torch.zeros(group, D), torch.zeros(group)
            for m_i, l_i, o_i in live:
                a = torch.where(l_i > 0, torch.exp2(m_i - M), 0.0)
                den = den + a * l_i
                num = num + a[:, None] * o_i
            out[b, rows] = num / den.clamp(min=1e-30)[:, None]
            lse[b, rows] = torch.where(den > 0, M * LN2 + torch.log(
                den.clamp(min=1e-30)), torch.tensor(NEG_INF))
    return out, lse


# ----------------------------------------------------------------------
# cases

def _inputs(B, Hkv, group, D, T, int8, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hkv * group, D), dtype=np.float32)
    shape = (B, Hkv, T, D)
    if int8:
        kc = rng.integers(-127, 128, shape).astype(np.int8)
        vc = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (B, Hkv, T, 1)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (B, Hkv, T, 1)).astype(np.float32)
        return q, kc, vc, ks, vs
    kc = rng.standard_normal(shape, dtype=np.float32)
    vc = rng.standard_normal(shape, dtype=np.float32)
    return q, kc, vc, None, None


# (name, B, Hkv, group, D, T, window, int8, positions); T = 300 is not a
# multiple of the 128-key chunk.
CASES = [
    ("edges_T300", 4, 2, 2, 64, 300, None, False, [0, 299, 150, 5]),
    ("chunk_edges_T384", 4, 2, 2, 64, 384, None, False,
     [127, 128, 255, 383]),
    ("window256_T600", 4, 2, 2, 64, 600, 256, False, [599, 255, 256, 300]),
    # pos >= T: row 2's window [T + 45, T + 301) and row 3's [T, T + 256)
    # lie past every valid key (lo >= valid_k); row 1's reaches back in.
    ("window_past_valid_T300", 4, 2, 2, 64, 300, 256, False,
     [0, 400, 600, 555]),
    ("int8_scales_T300", 4, 2, 2, 64, 300, None, True, [0, 299, 150, 5]),
    ("int8_window256_T600", 2, 2, 2, 64, 600, 256, True, [599, 130]),
    ("group1_T300", 2, 4, 1, 64, 300, None, False, [299, 77]),
    ("group8_T300", 2, 1, 8, 64, 300, 256, False, [299, 77]),
    ("D32_T300", 2, 2, 2, 32, 300, None, False, [299, 140]),
    ("D128_T300", 2, 2, 2, 128, 300, None, False, [299, 140]),
    ("int8_D32_T300", 2, 2, 2, 32, 300, None, True, [299, 140]),
    # one chunk (nsplit = 1): the split kernel writes o and lse itself.
    ("one_chunk_T100", 4, 2, 2, 64, 100, 30, False, [0, 99, 60, 200]),
]


def _torch(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_mirror_matches_reference_and_pallas(case):
    _, B, Hkv, group, D, T, window, int8, positions = case
    q, kc, vc, ks, vs = _inputs(B, Hkv, group, D, T, int8, seed=len(case[0]))
    pos = np.asarray(positions, np.int32)
    scale = 1.0 / np.sqrt(D)
    args = dict(scale=scale, window=window, k_s=_torch(ks), v_s=_torch(vs))
    out, lse = split_decode(_torch(q), _torch(kc), _torch(vc),
                            torch.from_numpy(pos), **args)
    want, want_lse = tdecode.decode_reference(
        _torch(q), _torch(kc), _torch(vc), torch.from_numpy(pos), **args)
    np.testing.assert_allclose(out.numpy(), want.numpy(), **TOL_PLAIN)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), **TOL_PLAIN)

    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    j_out, j_lse = jax_decode(j(q), j(kc), j(vc), j(pos), block_k=64,
                              scale=float(scale), window=window, k_s=j(ks),
                              v_s=j(vs), return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL_JAX)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), **TOL_JAX)

    # A row whose window lies past every valid key attends nothing.
    valid = pos.astype(np.int64) + 1
    lo = valid - window if window else np.zeros_like(valid)
    empty = lo >= np.minimum(valid, T)
    assert np.all(out.numpy()[empty] == 0)
    assert np.all(lse.numpy()[empty] == np.float32(NEG_INF))
    assert empty.any() == ("past_valid" in case[0]
                           or "one_chunk" in case[0])


def test_cases_reach_both_paths_and_early_exits():
    """The cases run both paths of the entry point (nsplit = 1, where the
    split kernel writes the output, and nsplit > 1, where the combine
    does) and chunks that exit at once (a position below the last
    chunk)."""
    splits = {c[0]: tdecode._decode_splits(c[1] * c[2], c[5]) for c in CASES}
    assert splits["one_chunk_T100"][0] == 1
    assert all(n > 1 for name, (n, _) in splits.items()
               if name != "one_chunk_T100")
    nsplit, chunk = splits["edges_T300"]
    assert 5 + 1 <= (nsplit - 1) * chunk        # pos 5 misses chunk 2


# ----------------------------------------------------------------------
# _decode_splits and the wrapper's launch

@pytest.mark.parametrize("T", [1, 100, 128, 129, 1000, 1024, 2048, 32768])
@pytest.mark.parametrize("bh", [1, 3, 24, 100, 600])
def test_decode_splits_cover_the_cache(bh, T):
    nsplit, chunk = tdecode._decode_splits(bh, T)
    assert chunk % tdecode.CHUNK_KEYS == 0 and 1 <= nsplit <= 65535
    assert (nsplit - 1) * chunk < T <= nsplit * chunk
    # About TARGET_BLOCKS blocks in all: one more row of bh at most.
    assert nsplit <= max(1, -(-tdecode.TARGET_BLOCKS // bh))


def test_decode_splits_at_the_serving_shapes():
    """B=8 slots x Hkv=3: max_len 1024 gives 8 chunks of 128 keys
    (192 blocks), SmolLM2's full context of 2048 gives 16 (384)."""
    assert tdecode._decode_splits(24, 1024) == (8, 128)
    assert tdecode._decode_splits(24, 2048) == (16, 128)


def test_chunk_keys_match_kernel():
    m = re.search(r"constexpr int kChunkKeys = (\d+);", SRC.read_text())
    assert m and int(m.group(1)) == tdecode.CHUNK_KEYS


@pytest.mark.parametrize("T", [1000, 100], ids=["split", "one_chunk"])
def test_launch_never_reads_pos_on_the_host(monkeypatch, T):
    """``_decode_cuda`` hands pos to the kernel by pointer: it reads no
    value of any tensor on the host (a read of a tensor on the card is a
    sync of the decode loop), passes ``_decode_splits(B * Hkv, T)`` and
    allocates the partials' scratch exactly when the cache is split."""
    calls = []

    def fake_entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(tdecode._build, "bind",
                        lambda name, symbol, argtypes: fake_entry)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))

    def host_read(*_a, **_k):
        raise AssertionError("a tensor was read on the host")

    for name in ("item", "tolist", "numpy", "cpu", "__int__", "__index__",
                 "__bool__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    B, Hkv, group, D = 8, 3, 3, 64
    q = torch.zeros(B, Hkv * group, D)
    kc = torch.zeros(B, Hkv, T, D)
    pos = torch.zeros(B, dtype=torch.int32)
    before = tdecode.flash_decode_attention.launches
    tdecode._decode_cuda(q, kc, kc, pos, scale=0.125, window=None,
                         k_s=None, v_s=None, return_lse=True)
    monkeypatch.undo()
    tdecode.flash_decode_attention.launches = before
    (args,) = calls
    assert len(args) == len(tdecode.ARGTYPES)
    nsplit, chunk = args[16], args[17]
    assert (nsplit, chunk) == tdecode._decode_splits(B * Hkv, T)
    assert (args[8] is not None) == (nsplit > 1)    # the partials' scratch
