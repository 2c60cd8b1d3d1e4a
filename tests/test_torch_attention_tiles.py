"""The tile logic and rounding of the tensor-core flash kernels (K1, the
forward, K2, dQ, and K3, dK/dV, in bf16), emulated on the CPU.

The kernels run only on the card.  What decides which (64-row, 64-key)
tiles they compute, and which of those they mask, is plain integer
arithmetic: ``key_range``, ``row_range``, ``pair_kept`` and
``tile_needs_mask`` in ``nbdistributed_tpu_torch/ops/csrc/sm90.cuh``,
and the segment votes of ``flash_fwd_wgmma_kernel``
(``csrc/flash_attention.cu``) and ``flash_bwd_dkv_wgmma_kernel``
(``csrc/flash_attention_bwd.cu``).  This file mirrors that code line for
line in Python and holds every tile's class against ``_keep_mask``, the
plain version's mask: a skipped tile holds no kept pair, a full tile
(computed without a mask) no removed pair, and a masked tile's
per-element test equals the mask.  ``flash_bwd_dq_wgmma_kernel`` (K2)
walks exactly K1's tiles (the same row tiles, ``key_range``, votes and
``tile_needs_mask``), so K1's cases cover it.

The second half computes K1, K2 and K3 in plain PyTorch with the
kernels' rounding points -- P rounded to bf16 before P.V (K1), dS as a
bf16 hi + lo pair before dS.K (K2), P and dS each as a hi + lo pair
before dV and dK (K3), every sum fp32 -- and holds them to
``_flash_forward_plain`` / ``_flash_backward_plain`` under the bf16
limits the card's check uses.
"""

import numpy as np
import pytest
import torch

from nbdistributed_tpu_torch.ops import attention as tattn

TILE = 64


# ----------------------------------------------------------------------
# sm90.cuh, line for line (C integer division of non-negative values is
# Python's //; every division below has a non-negative numerator).

def key_range(row0, nrows, group, Sk, causal, window, q_off, k_off):
    qi_lo = row0 // group
    qi_hi = (min(row0 + 64, nrows) - 1) // group
    b, e = 0, Sk
    if causal:
        e = min(Sk, qi_hi + q_off - k_off + 1)
        if window > 0:
            b = max(0, qi_lo + q_off - k_off - window + 1)
    return (b // 64) * 64, e


def row_range(kb0, Sq, group, causal, window, q_off, k_off):
    nrows = Sq * group
    b, e = 0, nrows
    if causal:
        qlo = max(0, kb0 + k_off - q_off)
        b = qlo * group if qlo < Sq else nrows
        if window > 0:
            qhi = kb0 + 64 - 1 + k_off - q_off + window - 1
            e = 0 if qhi < 0 else ((qhi + 1) * group if qhi + 1 < Sq
                                   else nrows)
    return (b // 64) * 64, e


def pair_kept(qi, ki, Sk, causal, window, q_off, k_off):
    keep = qi >= 0 and ki < Sk
    if causal:
        keep = keep and (ki + k_off <= qi + q_off)
        if window > 0:
            keep = keep and (ki + k_off > qi + q_off - window)
    return keep


def tile_needs_mask(row0, kb0, nrows, group, Sk, causal, window, q_off,
                    k_off, has_seg, seg_uniform):
    if kb0 + 64 > Sk or row0 + 64 > nrows:
        return True
    if has_seg and not seg_uniform:
        return True
    if not causal:
        return False
    q_first, q_last = row0 // group + q_off, (row0 + 63) // group + q_off
    if kb0 + 63 + k_off > q_first:
        return True                                  # the causal diagonal
    return window > 0 and kb0 + k_off <= q_last - window  # the window's edge


# The kernels' tile loops: {(row0, kb0): "full" | "masked"} for the tiles
# a block computes; every other tile of the grid is skipped.

def k1_tiles(Sq, Sk, group, causal, window, q_off, k_off, qseg, kseg):
    """flash_fwd_wgmma_kernel: one block per 64-row tile walks its keys."""
    nrows, has_seg, out = Sq * group, qseg is not None, {}
    for row0 in range(0, nrows, TILE):
        seg0 = qseg[row0 // group] if has_seg else 0
        rows_uniform = all(R >= nrows or qseg[R // group] == seg0
                           for R in range(row0, row0 + 64)) if has_seg \
            else True
        kbeg, kend = key_range(row0, nrows, group, Sk, causal, window,
                               q_off, k_off)
        for kb0 in range(kbeg, kend, TILE):
            vote = not has_seg or all(ki >= Sk or kseg[ki] == seg0
                                      for ki in range(kb0, kb0 + 64))
            seg_uniform = rows_uniform and vote
            out[row0, kb0] = ("masked" if tile_needs_mask(
                row0, kb0, nrows, group, Sk, causal, window, q_off, k_off,
                has_seg, seg_uniform) else "full")
    return out


def k3_tiles(Sq, Sk, group, causal, window, q_off, k_off, qseg, kseg):
    """flash_bwd_dkv_wgmma_kernel: one block per 64-key tile walks its
    folded rows."""
    nrows, has_seg, out = Sq * group, qseg is not None, {}
    for kb0 in range(0, Sk, TILE):
        seg0 = kseg[kb0] if has_seg else 0
        keys_uniform = all(ki >= Sk or kseg[ki] == seg0
                           for ki in range(kb0, kb0 + 64)) if has_seg \
            else True
        rbeg, rend = row_range(kb0, Sq, group, causal, window, q_off, k_off)
        for row0 in range(rbeg, rend, TILE):
            vote = not has_seg or all(R >= nrows or qseg[R // group] == seg0
                                      for R in range(row0, row0 + 64))
            seg_uniform = keys_uniform and vote
            out[row0, kb0] = ("masked" if tile_needs_mask(
                row0, kb0, nrows, group, Sk, causal, window, q_off, k_off,
                has_seg, seg_uniform) else "full")
    return out


def element_keep(R, ki, Sq, Sk, group, causal, window, q_off, k_off, qseg,
                 kseg):
    """A masked tile's per-element test (both kernels)."""
    qi = R // group if R < Sq * group else -1
    return (pair_kept(qi, ki, Sk, causal, window, q_off, k_off)
            and (qseg is None or qseg[qi] == kseg[ki]))


# (name, Sq, Sk, group, causal, window, (q_off, k_off), segments)
CASES = [
    ("causal_g1", 200, 200, 1, True, 0, (0, 0), None),
    ("causal_g2_ragged", 150, 150, 2, True, 0, (0, 0), None),
    ("causal_g3", 300, 300, 3, True, 0, (0, 0), None),
    ("noncausal_g3", 130, 130, 3, False, 0, (0, 0), None),
    ("noncausal_ragged_sq_ne_sk_g2", 90, 170, 2, False, 0, (0, 0), None),
    ("window70_g3", 300, 300, 3, True, 70, (0, 0), None),
    ("window5_g1", 260, 260, 1, True, 5, (0, 0), None),
    ("window200_g2", 400, 400, 2, True, 200, (0, 0), None),
    # the window's last row one past a row-tile edge
    ("window66_g1", 300, 300, 1, True, 66, (0, 0), None),
    # a tile's first query one before / on its last key's diagonal
    ("offsets_diag_minus1_g1", 200, 300, 1, True, 0, (62, 0), None),
    ("offsets_diag_g1", 200, 300, 1, True, 0, (63, 0), None),
    # the last key a row tile sees is the first of the next key tile
    ("offsets_q1_g1", 200, 300, 1, True, 0, (1, 0), None),
    ("offsets_g3", 100, 230, 3, True, 0, (130, 0), None),
    ("offsets_window_g2", 120, 300, 2, True, 50, (180, 0), None),
    ("offsets_k_ahead_g1", 200, 200, 1, True, 0, (0, 40), None),
    ("segments_aligned_g3", 256, 256, 3, True, 0, (0, 0),
     [0, 64, 192]),
    ("segments_cut_g1", 300, 300, 1, True, 0, (0, 0), [0, 100, 101, 250]),
    ("segments_noncausal_g2", 200, 200, 2, False, 0, (0, 0), [0, 128]),
    ("segments_window_g3", 256, 256, 3, True, 40, (0, 0), [0, 130]),
]


def _segments(S, starts):
    if starts is None:
        return None
    seg = np.zeros(S, np.int64)
    for i, s in enumerate(starts):
        seg[s:] = i
    return seg


def _keep(Sq, Sk, group, causal, window, offsets, seg):
    """The plain version's mask over folded rows: (Sq * group, Sk)."""
    t = None if seg is None else torch.from_numpy(seg)[None]
    keep = tattn._keep_mask(Sq, Sk, causal=causal, window=window or None,
                            q_off=offsets[0], k_off=offsets[1],
                            segment_ids=t, kv_segment_ids=t, device="cpu")
    keep = (torch.ones(Sq, Sk, dtype=torch.bool) if keep is None
            else keep[0, 0].expand(Sq, Sk))
    return keep.repeat_interleave(group, dim=0).numpy()


@pytest.mark.parametrize("kernel", ["k1", "k3"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tile_classes_match_the_plain_mask(case, kernel):
    _, Sq, Sk, group, causal, window, (q_off, k_off), starts = case
    seg = _segments(Sq, starts)
    keep = _keep(Sq, Sk, group, causal, window, (q_off, k_off), seg)
    nrows = Sq * group
    tiles = (k1_tiles if kernel == "k1" else k3_tiles)(
        Sq, Sk, group, causal, window, q_off, k_off, seg, seg)
    n_masked = 0
    for row0 in range(0, nrows, TILE):
        for kb0 in range(0, Sk, TILE):
            block = keep[row0:row0 + TILE, kb0:kb0 + TILE]
            cls = tiles.get((row0, kb0), "skipped")
            if cls == "skipped":
                assert not block.any(), (row0, kb0)
                continue
            # Full (no mask) exactly where every pair of a whole tile is
            # kept: masked only where needed.
            all_kept = block.shape == (TILE, TILE) and block.all()
            assert (cls == "full") == all_kept, (row0, kb0, cls)
            if cls == "masked":
                n_masked += 1
                want = np.array([[element_keep(
                    R, ki, Sq, Sk, group, causal, window, q_off, k_off, seg,
                    seg) for ki in range(kb0, kb0 + TILE)]
                    for R in range(row0, row0 + TILE)])
                np.testing.assert_array_equal(
                    want[:block.shape[0], :block.shape[1]], block)
                assert not want[block.shape[0]:].any()
                assert not want[:, block.shape[1]:].any()
    assert n_masked > 0


def test_heaviest_tiles_first():
    """K1 and K2 launch their row tiles last-first and K3 its key tiles
    first-first: in each the first block launched has the most causal
    tiles to walk."""
    Sq = Sk = 512
    group = 3
    walk1 = {r: len([1 for (r0, _) in k1_tiles(Sq, Sk, group, True, 0, 0,
                                               0, None, None) if r0 == r])
             for r in range(0, Sq * group, TILE)}
    n_row_tiles = len(walk1)
    first_k1 = (n_row_tiles - 1) * TILE          # gridDim.y - 1 - blockIdx.y
    assert walk1[first_k1] == max(walk1.values())
    walk3 = {k: len([1 for (_, k0) in k3_tiles(Sq, Sk, group, True, 0, 0, 0,
                                               None, None) if k0 == k])
             for k in range(0, Sk, TILE)}
    assert walk3[0] == max(walk3.values())       # blockIdx.y * 64


# ----------------------------------------------------------------------
# rounding

# chip_smoke.py's limits for bf16 (K1_TOL, LSE_TOL, K23_TOL at
# chip_smoke.py:124-132): |got - want| <= atol + rtol * |want|.
K1_TOL_BF16 = (4e-3, 1e-2)
K23_TOL_BF16 = (4e-3, 1e-2)
LSE_TOL = 1e-4


def _ratio(got, want, tol):
    atol, rtol = tol
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _k1_kernel_rounding(q, k, v, scale, seg=None):
    """K1 as the kernel computes it, causal (and within the segments
    ``seg`` (S,), if given): 64-key tiles, online softmax in the log2
    domain in fp32, P rounded to bf16 for P.V, l summed from the fp32 P."""
    B, S, H, D = q.shape
    g = H // k.shape[2]
    qf = q.float().transpose(1, 2)                       # (B, H, S, D)
    kf = k.float().repeat_interleave(g, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(g, 2).transpose(1, 2)
    qi = torch.arange(S)[:, None]
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros(B, H, S, 1)
    acc = torch.zeros(B, H, S, D)
    sl2 = scale * 1.4426950408889634
    for kb0 in range(0, S, TILE):
        s = (qf @ kf[:, :, kb0:kb0 + TILE].transpose(-1, -2)) * sl2
        s = s.masked_fill(torch.arange(kb0, kb0 + TILE)[None] > qi, -1e30)
        if seg is not None:
            s = s.masked_fill(seg[:, None] != seg[None, kb0:kb0 + TILE],
                              -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _bf16(p) @ vf[:, :, kb0:kb0 + TILE]
        m = m_new
    out = (acc / l).transpose(1, 2).to(q.dtype)
    lse = (m * 0.6931471805599453 + torch.log(l))[..., 0]
    return out, lse


def _rounded(x, split):
    """x as the kernels feed it to the tensor cores: one bf16 rounding,
    or (``split``) the pair hi = bf16(x), lo = bf16(x - hi), summed."""
    hi = _bf16(x)
    return hi + _bf16(x - hi) if split else hi


def _k2_kernel_rounding(q, k, v, g_out, out, lse, scale, split=True,
                        seg=None):
    """K2 as the kernel computes it, causal (and within the segments
    ``seg`` (S,), if given): 64-key tiles, P = exp2 of the scores in the
    log2 domain less the saved lse, dS = P (dP - delta) in fp32, rounded
    as a bf16 hi + lo pair (``split``; once otherwise) for dQ += dS K,
    the tiles' sum in fp32, dQ scaled at the end."""
    B, S, H, D = q.shape
    grp = H // k.shape[2]
    qf = q.float().transpose(1, 2)                       # (B, H, S, D)
    kf = k.float().repeat_interleave(grp, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(grp, 2).transpose(1, 2)
    gf = g_out.float().transpose(1, 2)
    delta = tattn._flash_bwd_prep(out, g_out)[..., None]
    lse2 = lse[..., None] * 1.4426950408889634
    qi = torch.arange(S)[:, None]
    dq = torch.zeros(B, H, S, D)
    for kb0 in range(0, S, TILE):
        kt, vt = kf[:, :, kb0:kb0 + TILE], vf[:, :, kb0:kb0 + TILE]
        s = qf @ kt.transpose(-1, -2)
        p = torch.exp2(s * (scale * 1.4426950408889634) - lse2)
        keep = torch.arange(kb0, kb0 + TILE)[None] <= qi
        if seg is not None:
            keep = keep & (seg[:, None] == seg[None, kb0:kb0 + TILE])
        p = p.masked_fill(~keep, 0.0)
        ds = p * (gf @ vt.transpose(-1, -2) - delta)
        dq = dq + _rounded(ds, split) @ kt
    return (dq * scale).transpose(1, 2).to(q.dtype)


def _k3_kernel_rounding(q, k, v, g_out, out, lse, scale, split=True):
    """K3 as the kernel computes it, causal: P and dS in fp32, each as
    a bf16 hi + lo pair (``split``; one bf16 rounding otherwise) for
    dV += P^T dO and dK += dS^T Q, sums fp32, dK scaled at the end."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    grp = H // Hkv
    keep = torch.arange(S)[None, :] <= torch.arange(S)[:, None]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float().repeat_interleave(grp, 2))
    p = torch.exp2(s * (scale * 1.4426950408889634)
                   - lse[..., None] * 1.4426950408889634)
    p = p.masked_fill(~keep, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", g_out.float(),
                      v.float().repeat_interleave(grp, 2))
    ds = p * (dp - tattn._flash_bwd_prep(out, g_out)[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", _rounded(p, split), g_out.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", _rounded(ds, split),
                      q.float()) * scale
    fold = lambda x: x.reshape(B, S, Hkv, grp, D).sum(3).to(k.dtype)  # noqa
    return fold(dk), fold(dv)


@pytest.fixture(scope="module")
def bf16_case():
    """B=1, S=1024, H=9, Hkv=3, D=64, bf16, causal, from a numpy seed."""
    rng = np.random.default_rng(0)
    shapes = [(1, 1024, 9, 64), (1, 1024, 3, 64), (1, 1024, 3, 64),
              (1, 1024, 9, 64)]
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                  .to(torch.bfloat16) for s in shapes)
    return q, k, v, g, 0.125


def _packed_segments(S, seed):
    """Segment ids (S,) of documents of 64-1536 tokens packed end to end,
    as the training batch packs them."""
    lengths = np.random.default_rng(seed).integers(64, 1537, size=S // 64)
    return torch.from_numpy(np.repeat(np.arange(len(lengths)), lengths)[:S])


@pytest.mark.parametrize("segments", [False, True],
                         ids=["causal", "causal_packed_segments"])
def test_k1_rounding_within_the_chip_limits(bf16_case, segments):
    q, k, v, _, scale = bf16_case
    seg = _packed_segments(q.shape[1], seed=1) if segments else None
    out, lse = _k1_kernel_rounding(q, k, v, scale, seg)
    ids = None if seg is None else seg[None].to(torch.int32)
    want, want_lse = tattn._flash_forward_plain(
        q, k, v, causal=True, scale=scale, segment_ids=ids,
        kv_segment_ids=ids)
    assert _ratio(out, want, K1_TOL_BF16) <= 1
    assert float((lse - want_lse).abs().max()) <= LSE_TOL


def test_k3_rounding_within_the_chip_limits(bf16_case):
    """dK and dV with P and dS as bf16 hi + lo pairs stay well inside
    the limit; one bf16 rounding of each term goes past it (on the card
    too: ratio 1.2-1.4 at S=2048), which is why the kernel splits."""
    q, k, v, g, scale = bf16_case
    out, lse = tattn._flash_forward_plain(q, k, v, causal=True, scale=scale)
    _, want_dk, want_dv = tattn._flash_backward_plain(
        q, k, v, out, lse, g, causal=True, scale=scale)
    dk, dv = _k3_kernel_rounding(q, k, v, g, out, lse, scale)
    split = max(_ratio(dk, want_dk, K23_TOL_BF16),
                _ratio(dv, want_dv, K23_TOL_BF16))
    assert split <= 1
    dk1, dv1 = _k3_kernel_rounding(q, k, v, g, out, lse, scale, split=False)
    single = max(_ratio(dk1, want_dk, K23_TOL_BF16),
                 _ratio(dv1, want_dv, K23_TOL_BF16))
    assert single > 1


@pytest.mark.parametrize("segments", [False, True],
                         ids=["causal", "causal_packed_segments"])
def test_k2_rounding_within_the_chip_limits(bf16_case, segments):
    """dQ with dS as a bf16 hi + lo pair stays within 0.8 of the limit
    (0.40 here); one bf16 rounding of the signed, cancelling dS reaches
    0.89, too close to it, which is why the kernel splits dS."""
    q, k, v, g, scale = bf16_case
    seg = _packed_segments(q.shape[1], seed=1) if segments else None
    ids = None if seg is None else seg[None].to(torch.int32)
    args = dict(causal=True, scale=scale, segment_ids=ids,
                kv_segment_ids=ids)
    out, lse = tattn._flash_forward_plain(q, k, v, **args)
    want_dq = tattn._flash_backward_plain(q, k, v, out, lse, g, **args)[0]
    split = _ratio(_k2_kernel_rounding(q, k, v, g, out, lse, scale,
                                       seg=seg), want_dq, K23_TOL_BF16)
    single = _ratio(_k2_kernel_rounding(q, k, v, g, out, lse, scale,
                                        split=False, seg=seg),
                    want_dq, K23_TOL_BF16)
    assert split <= 0.8 < single
