"""The harness's operation and byte counts against brute-force counts
at tiny shapes."""

import itertools

import pytest
import torch

from perfkit import counts, weights


def _mask_pairs(doc_lens, window):
    """Allowed (query, key) pairs of a packed row, by building the mask."""
    seg = torch.repeat_interleave(torch.arange(len(doc_lens)),
                                  torch.tensor(doc_lens))
    S = len(seg)
    q, k = torch.arange(S)[:, None], torch.arange(S)[None]
    keep = (k <= q) & (seg[:, None] == seg[None])
    if window is not None:
        keep &= k > q - window
    return int(keep.sum())


@pytest.mark.parametrize("doc_lens,window", [
    ([1], None), ([7], 3), ([5, 9, 2], None), ([5, 9, 2], 4),
    ([12, 1, 30], 8), ([64], 64), ([65], 64)])
def test_pairs_against_the_mask(doc_lens, window):
    assert counts.pairs([doc_lens], window) == _mask_pairs(doc_lens, window)


def test_segments_to_lengths():
    assert counts.segments_to_lengths([[0, 0, 1, 2, 2, 2]]) == [[2, 1, 3]]
    assert counts.segments_to_lengths([[4] * 5, [0, 1]]) == [[5], [1, 1]]


def test_attention_products_and_bytes():
    B, S, H, Hkv, Dh = 2, 8, 4, 2, 16
    n = counts.pairs([[3, 5], [8]], None)
    f, b = counts.attn_fwd(B, S, H, Hkv, Dh, n)
    # two products of 2 * Dh per pair and head
    assert f == 2 * (2 * Dh) * H * n
    q = B * S * H * Dh * 2
    kv = B * S * Hkv * Dh * 2
    assert b == q + 2 * kv + 4 * B * S + q + 4 * B * H * S
    fb, bb = counts.attn_bwd(B, S, H, Hkv, Dh, n)
    assert fb == 5 * 2 * Dh * H * n
    assert bb == 3 * q + 2 * kv + 4 * B * H * S + 4 * B * S + q + 2 * kv


def test_decode_keys_and_bytes_brute_force():
    pos, H, Hkv, Dh, window = [0, 5, 17, 40], 8, 2, 4, 16
    keys = [sum(1 for t in range(p + 1) if t > p - window) for p in pos]
    assert counts.decode_keys(pos, window) == keys
    f, b = counts.attn_decode(pos, H, Hkv, Dh, window)
    assert f == 4 * H * Dh * sum(keys)
    assert b == sum(keys) * Hkv * Dh * 2 * 2 + 2 * len(pos) * H * Dh * 2


def _sizes(**kw):
    s = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=48, rope_theta=1e4, norm_eps=1e-5, sliding_window=None,
             dtype="float32")
    s.update(kw)
    return s


def test_train_model_flops_count_every_non_embedding_parameter():
    s = _sizes()
    specs = weights.leaf_specs(s)
    n = sum(torch.Size(shape).numel() for p, (shape, _, _) in specs.items()
            if p != "embed")
    tokens, n_pairs = 40, 100
    Dh = s["d_model"] // s["n_heads"]
    want = 6 * n * tokens + 12 * s["n_layers"] * s["n_heads"] * Dh * n_pairs
    assert counts.train_model_flops(s, tokens, n_pairs) == want


def test_serve_flops_count_the_active_experts():
    s = _sizes(n_experts=4, top_k=2)
    specs = weights.leaf_specs(s)
    L = s["n_layers"]
    per_layer = sum(torch.Size(shape).numel() // L
                    for p, (shape, _, _) in specs.items()
                    if p.startswith("layers/") and "norm" not in p)
    expert = sum(torch.Size(shape).numel() // (L * 4)
                 for p, (shape, _, _) in specs.items() if "/w_" in p)
    active = per_layer - (4 - s["top_k"]) * expert
    Dh = s["d_model"] // s["n_heads"]
    tokens, keys, heads = 10, 55, 3
    want = (2 * L * active * tokens + 4 * L * s["n_heads"] * Dh * keys
            + 2 * s["d_model"] * s["vocab_size"] * heads)
    assert counts.serve_flops(s, tokens, keys, heads) == want


def test_roofline_share_takes_the_larger_bound():
    peak = {"bf16_flops": 1e12, "hbm_bytes": 1e9}
    assert counts.roofline_share(1e12, 0, 2.0, peak) == pytest.approx(50.0)
    assert counts.roofline_share(0, 1e9, 4.0, peak) == pytest.approx(25.0)
    for f, b in itertools.product((0, 5e11), (0, 5e8)):
        assert counts.roofline_share(f, b, 1.0, peak) <= 100.0


def test_the_card_has_peaks():
    p = counts.peaks("NVIDIA H100 80GB HBM3")
    assert p["bf16_flops"] == 989e12 and p["hbm_bytes"] == 3.35e12
