"""The harness's own count of the operations and bytes a call needs,
worked out from the inputs' shapes, the window, the packed documents
and the cache lengths -- never from what a kernel happens to execute.

A roofline share is ``max(flops / peak_flops, bytes / peak_bytes)``
over the device time the call took.  Bytes count each input read once
and each output written once.  Attention counts only the (query, key)
pairs that the causal mask, the window and the documents allow.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS_FILE = Path(__file__).with_name("peaks.json")


def peaks(kind: str) -> dict:
    """The published peaks of a card, by ``torch.cuda.get_device_name``."""
    with open(PEAKS_FILE) as f:
        table = json.load(f)
    if kind not in table:
        raise KeyError(f"no peaks for device {kind!r} in {PEAKS_FILE.name}")
    return table[kind]


def doc_pairs(n: int, window: int | None) -> int:
    """Causal (query, key) pairs of one document of ``n`` tokens, keys
    at most ``window - 1`` behind their query."""
    if window is None or n <= window:
        return n * (n + 1) // 2
    return window * (window + 1) // 2 + (n - window) * window


def segments_to_lengths(segments) -> list[list[int]]:
    """Document lengths of each row of a (B, S) segment-id array whose
    ids are constant within a document."""
    rows = []
    for row in segments:
        lens, run = [], 1
        for a, b in zip(row[:-1], row[1:]):
            if a == b:
                run += 1
            else:
                lens.append(run)
                run = 1
        lens.append(run)
        rows.append(lens)
    return rows


def pairs(doc_lens: list[list[int]], window: int | None) -> int:
    """Allowed pairs of a packed batch, every row."""
    return sum(doc_pairs(n, window) for row in doc_lens for n in row)


def attn_fwd(B: int, S: int, H: int, Hkv: int, Dh: int, n_pairs: int,
             elem: int = 2, segmented: bool = True) -> tuple[int, int]:
    """K1: ``(flops, bytes)``.  Two products over the allowed pairs;
    reads q, k, v (and the int32 segment ids), writes o and the fp32
    lse."""
    flops = 4 * H * Dh * n_pairs
    rd = B * S * (H + 2 * Hkv) * Dh * elem + (4 * B * S if segmented else 0)
    wr = B * S * H * Dh * elem + 4 * B * H * S
    return flops, rd + wr


def attn_bwd(B: int, S: int, H: int, Hkv: int, Dh: int, n_pairs: int,
             elem: int = 2, segmented: bool = True) -> tuple[int, int]:
    """K2 + K3, the whole backward: ``(flops, bytes)``.  Five products
    over the allowed pairs (the scores again, dV, dP, dQ, dK); reads q,
    k, v, o, dO, the lse (and the segment ids), writes dq, dk, dv."""
    flops = 10 * H * Dh * n_pairs
    q = B * S * H * Dh * elem
    kv = B * S * Hkv * Dh * elem
    rd = 3 * q + 2 * kv + 4 * B * H * S + (4 * B * S if segmented else 0)
    wr = q + 2 * kv
    return flops, rd + wr


def decode_keys(pos: list[int], window: int | None) -> list[int]:
    """Keys each row's query attends: its cache up to ``pos``, the last
    ``window`` of them."""
    return [min(p + 1, window) if window else p + 1 for p in pos]


def attn_decode(pos: list[int], H: int, Hkv: int, Dh: int,
                window: int | None, elem: int = 2) -> tuple[int, int]:
    """K4 over one step of rows at positions ``pos``: ``(flops,
    bytes)``.  Bytes are the K/V rows each row's position needs, its
    query and its output."""
    keys = sum(decode_keys(pos, window))
    flops = 4 * H * Dh * keys
    return flops, 2 * keys * Hkv * Dh * elem + 2 * len(pos) * H * Dh * elem


def dense_layer_params(s: dict) -> int:
    D, H, Hkv, F = s["d_model"], s["n_heads"], s["n_kv_heads"], s["d_ff"]
    Dh = D // H
    return D * (H * Dh) + 2 * D * Hkv * Dh + H * Dh * D + 3 * D * F + 2 * D


def train_model_flops(s: dict, tokens: int, n_pairs: int) -> int:
    """Model FLOPs of one training step over ``tokens``: six per
    non-embedding parameter (the lm_head included) per token, and the
    attention products of the allowed pairs (forward 2, backward 4);
    recomputation is not counted."""
    D, L, V = s["d_model"], s["n_layers"], s["vocab_size"]
    Dh = D // s["n_heads"]
    n = L * dense_layer_params(s) + D + D * V
    return 6 * n * tokens + 12 * L * s["n_heads"] * Dh * n_pairs


def moe_active_layer_params(s: dict) -> int:
    """Parameters one token passes through in a MoE layer: attention,
    the router and ``top_k`` experts."""
    D, H, Hkv, F = s["d_model"], s["n_heads"], s["n_kv_heads"], s["d_ff"]
    Dh = D // H
    attn = D * (H * Dh) + 2 * D * Hkv * Dh + H * Dh * D
    return attn + D * s["n_experts"] + s["top_k"] * 3 * D * F


def serve_flops(s: dict, tokens: int, attended_keys: int,
                head_rows: int) -> int:
    """Forward FLOPs of serving: two per active parameter per token
    processed, the attention products of every (query, key) pair
    attended (``attended_keys``, summed over queries), and the lm_head
    at the ``head_rows`` positions whose logits are taken."""
    L, D = s["n_layers"], s["d_model"]
    Dh = D // s["n_heads"]
    per_layer = (moe_active_layer_params(s) if s.get("n_experts")
                 else dense_layer_params(s))
    return (2 * L * per_layer * tokens
            + 4 * L * s["n_heads"] * Dh * attended_keys
            + 2 * D * s["vocab_size"] * head_rows)


def roofline_share(flops: int, nbytes: int, seconds: float,
                   peak: dict) -> float:
    """Percent of the least time the chip could take."""
    bound = max(flops / peak["bf16_flops"], nbytes / peak["hbm_bytes"])
    return 100.0 * bound / seconds
