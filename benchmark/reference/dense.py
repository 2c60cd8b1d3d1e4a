"""The Mistral block (a Llama-style decoder with GQA and a sliding
window) trained by AdamW: forward, loss and gradients in float32 (or
the control's fp8), one layer at a time.

A step runs the layers forward without a graph, keeping each layer's
input; the loss and its gradient come from the last; then each layer,
from the top, runs again under autograd from its kept input, gives the
gradient of its input and of its weights, and its weights are stepped
at once (its input gradient is already computed from the old weights).
So the memory is the tree, the moments, the layer inputs and one
layer's activations.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .adamw import AdamW
from .common import Precision, attention, rms_norm, rope

LAYER_LEAVES = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
                "w_up", "w_down")


def packed_positions(doc: torch.Tensor) -> torch.Tensor:
    """Position of each token inside its document (S,)."""
    S = doc.shape[0]
    idx = torch.arange(S, device=doc.device)
    start = torch.ones(S, dtype=torch.bool, device=doc.device)
    start[1:] = doc[1:] != doc[:-1]
    first = torch.cummax(torch.where(start, idx, 0), dim=0).values
    return idx - first


def layer_forward(x, lw: dict, pos, doc, sizes: dict, prec: Precision,
                  checkpointed: bool = False):
    """One decoder layer on one sequence x (S, D) float32."""
    S = x.shape[0]
    H, Hkv = sizes["n_heads"], sizes["n_kv_heads"]
    Dh = sizes["d_model"] // H
    eps, theta = sizes["norm_eps"], sizes["rope_theta"]
    h = rms_norm(x, lw["attn_norm"], eps)
    q = rope(prec.mm(h, lw["wq"]).view(S, H, Dh), pos, theta)
    k = rope(prec.mm(h, lw["wk"]).view(S, Hkv, Dh), pos, theta)
    v = prec.mm(h, lw["wv"]).view(S, Hkv, Dh)
    o = attention(q, k, v, doc, sizes["sliding_window"], prec,
                  checkpointed=checkpointed)
    x = x + prec.mm(o, lw["wo"])
    h = rms_norm(x, lw["mlp_norm"], eps)
    gated = F.silu(prec.mm(h, lw["w_gate"])) * prec.mm(h, lw["w_up"])
    return x + prec.mm(gated, lw["w_down"])


def _layer_slice(w: dict, i: int, grad: bool) -> dict:
    return {n: _f32(w["layers"][n][i]).requires_grad_(grad)
            for n in LAYER_LEAVES}


def _f32(t):
    """A float32 copy that is a fresh leaf, never the tree's tensor."""
    return t.to(torch.float32, copy=True)


def train_steps(w: dict, sizes: dict, batches: list, opt: AdamW,
                prec: Precision, target_keep=None, first_grad=None) -> dict:
    """Step the tree ``w`` (the port's layout, updated in place) once per
    batch (``{"tokens", "segments"}`` (B, S) long tensors on w's
    device).  ``target_keep(B, S)`` -> bool (B, S - 1) leaves targets
    out of the mean (the half-batch fault).  ``first_grad(path, layer,
    g)`` sees every float32 gradient of the first step (``layer`` None
    for a leaf that is not stacked).  Returns the losses and the first
    step's gradient norm of every leaf."""
    losses, grad_sq = [], {}
    L, D = sizes["n_layers"], sizes["d_model"]
    for n_step, batch in enumerate(batches):
        opt.begin_step()
        first = n_step == 0
        tokens, seg = batch["tokens"], batch["segments"]
        B, S = tokens.shape
        pos = [packed_positions(seg[b]) for b in range(B)]

        def rows(x, lw, ckpt):
            return torch.stack([layer_forward(x[b], lw, pos[b], seg[b],
                                              sizes, prec, ckpt)
                                for b in range(B)])

        with torch.no_grad():
            xs = [w["embed"][tokens].float()]
            for i in range(L):
                xs.append(rows(xs[-1], _layer_slice(w, i, False), False))
        # loss over the kept next-token targets
        xL = xs.pop().requires_grad_(True)
        fn = _f32(w["final_norm"]).requires_grad_(True)
        head = _f32(w["lm_head"]).requires_grad_(True)
        h = rms_norm(xL[:, :-1], fn, sizes["norm_eps"]).reshape(-1, D)
        logp = torch.log_softmax(prec.mm(h, head), dim=-1)
        tgt = tokens[:, 1:].reshape(-1)
        keep = (seg[:, :-1] == seg[:, 1:])
        if target_keep is not None:
            keep = keep & target_keep(B, S).to(keep.device)
        keep = keep.reshape(-1).float()
        nll = -logp.gather(1, tgt[:, None])[:, 0]
        loss = (nll * keep).sum() / keep.sum().clamp(min=1)
        loss.backward()
        losses.append(float(loss.detach()))
        dx = xL.grad
        del logp, h, nll, loss, xL

        def step(key, p, g):
            if first:
                grad_sq[key[0]] = grad_sq.get(key[0], 0.0) + \
                    float((g.double() ** 2).sum())
                if first_grad is not None:
                    first_grad(key[0], key[1] if len(key) > 1 else None, g)
            opt.update(key, p, g)

        step(("final_norm",), w["final_norm"], fn.grad)
        step(("lm_head",), w["lm_head"], head.grad)
        del fn, head
        for i in reversed(range(L)):
            x_in = xs.pop().requires_grad_(True)
            lw = _layer_slice(w, i, True)
            rows(x_in, lw, True).backward(dx)
            dx = x_in.grad
            del x_in
            for n in LAYER_LEAVES:
                step((f"layers/{n}", i), w["layers"][n][i], lw[n].grad)
            del lw
        g_embed = torch.zeros(w["embed"].shape, dtype=torch.float32,
                              device=dx.device)
        g_embed.index_add_(0, tokens.reshape(-1), dx.reshape(-1, D))
        del dx
        step(("embed",), w["embed"], g_embed)
        del g_embed
    return {"losses": losses,
            "grad_norms": {k: v ** 0.5 for k, v in grad_sq.items()}}
