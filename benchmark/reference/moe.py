"""The Mixtral expert layer in float32 or the control's fp8.

Routing is Mixtral's: softmax over the router's logits, the top
``top_k`` experts by probability (ties to the lower index), their
probabilities renormalised, every routed token computed (no capacity,
no drop).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Precision


def moe_ffn(h, lw: dict, top_k: int, prec: Precision):
    """h (N, D) float32 -> (N, D): the experts' weighted SwiGLU."""
    probs = torch.softmax(prec.mm(h, lw["router"]), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[:, :top_k] / vals[:, :top_k].sum(-1, keepdim=True)
    idx = idx[:, :top_k]
    out = torch.zeros_like(h)
    for e in range(lw["w_gate"].shape[0]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = h[tok]
        ye = prec.mm(F.silu(prec.mm(xe, lw["w_gate"][e]))
                     * prec.mm(xe, lw["w_up"][e]), lw["w_down"][e])
        out.index_add_(0, tok, ye * gates[tok, slot][:, None])
    return out
