"""A served model's forward over whole sequences (a prompt and the
tokens served after it), in float32 or the control's fp8, one layer at
a time over all sequences, giving the logits at the positions that
predicted each served token.  The feed-forward branch is the dense
SwiGLU or, for a tree with ``layers["moe"]``, the experts
(:func:`.moe.moe_ffn`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Precision, attention, rms_norm, rope
from .moe import moe_ffn

ATTN = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm")


def _layer(w: dict, i: int) -> dict:
    lw = {n: w["layers"][n][i].float() for n in ATTN}
    if "moe" in w["layers"]:
        lw.update({n: w["layers"]["moe"][n][i].float()
                   for n in ("router", "w_gate", "w_up", "w_down")})
    else:
        lw.update({n: w["layers"][n][i].float()
                   for n in ("w_gate", "w_up", "w_down")})
    return lw


def _ffn(h, lw: dict, sizes: dict, prec: Precision):
    if "router" in lw:
        return moe_ffn(h, lw, sizes["top_k"], prec)
    return prec.mm(F.silu(prec.mm(h, lw["w_gate"])) * prec.mm(h, lw["w_up"]),
                   lw["w_down"])


@torch.no_grad()
def served_logits(w: dict, sizes: dict, seqs: list, prec: Precision,
                  device) -> list:
    """``seqs``: list of (prompt ids, served ids).  Returns, for each, the
    (n_served, V) float32 logits of the positions that predict the
    served tokens (the prompt's last position, then each served token
    but the last)."""
    H, Hkv = sizes["n_heads"], sizes["n_kv_heads"]
    D, L = sizes["d_model"], sizes["n_layers"]
    Dh = D // H
    eps, theta = sizes["norm_eps"], sizes["rope_theta"]
    ids = [torch.tensor(p + s[:-1], dtype=torch.long, device=device)
           for p, s in seqs]
    xs = [w["embed"][t].float() for t in ids]
    for i in range(L):
        lw = _layer(w, i)
        for j, x in enumerate(xs):
            S = x.shape[0]
            pos = torch.arange(S, device=device)
            doc = torch.zeros(S, dtype=torch.long, device=device)
            h = rms_norm(x, lw["attn_norm"], eps)
            q = rope(prec.mm(h, lw["wq"]).view(S, H, Dh), pos, theta)
            k = rope(prec.mm(h, lw["wk"]).view(S, Hkv, Dh), pos, theta)
            v = prec.mm(h, lw["wv"]).view(S, Hkv, Dh)
            o = attention(q, k, v, doc, sizes["sliding_window"], prec)
            x = x + prec.mm(o, lw["wo"])
            xs[j] = x + _ffn(rms_norm(x, lw["mlp_norm"], eps), lw, sizes,
                             prec)
        del lw
    head = w["lm_head"].float()
    fn = w["final_norm"].float()
    return [prec.mm(rms_norm(x[len(p) - 1:], fn, eps), head)
            for (p, _), x in zip(seqs, xs)]
