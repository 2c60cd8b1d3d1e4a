"""Mixture-of-experts decoder transformer, Mixtral-style (counterpart of
``nbdistributed_tpu/models/moe.py``).

The dense family's attention, RMSNorm and rotary stack
(:mod:`.transformer`; K1 forward, K2/K3 backward) with the SwiGLU MLP
swapped for the expert layer (:func:`..parallel.expert.moe_ffn`).
Per-layer tensors carry a leading (n_layers,) axis, the experts' a
second (n_experts,) one: ``layers["moe"] = {"router" (L, D, E) fp32,
"w_gate", "w_up" (L, E, D, F), "w_down" (L, E, F, D)}``.  The forward
loops over layers and returns the load-balance aux loss averaged over
them.  On a mesh (:mod:`..parallel.mesh`) the experts split over
``ep`` (:func:`moe_model_shardings`), the tokens over ``dp`` and the
attention over ``tp`` as in the dense family (``rules=``); the loss on
a mesh trains there.  With ``sp`` (:class:`.transformer.SeqParallel`)
each rank holds its chunk of the sequence, attention runs as the ring
or Ulysses and the expert layer routes the tokens JAX routes together
(:func:`..parallel.expert.moe_ffn`'s ``seq_axis``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..observability.spans import maybe_span
from ..ops._common import resolve_device
from ..ops.xent import shifted_chunked_xent
from ..parallel.expert import init_moe_params, moe_ffn, moe_param_shardings
from ..parallel.mesh import P
from ..utils import fan_in_normal
from .transformer import (TransformerConfig, _as_tokens, _attention_block,
                          _chunked_tail, _embed, _head, _layout,
                          _model_inputs, _rms_norm, _sp_inputs, _sp_mesh,
                          _sp_nll_sum, _sp_xent, dp_loss_scale, layer_params,
                          packed_positions, shifted_xent)


@dataclasses.dataclass(frozen=True)
class MoEConfig(TransformerConfig):
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    lb_coef: float = 0.01
    # "dense" (one-hot einsums), "sparse" (sort/segment, the same drops)
    # or "dropless" (no capacity): parallel/expert.py.
    moe_dispatch: str = "dense"

    def num_params(self) -> int:
        emb = self.vocab_size * self.d_model
        attn = (self.d_model * self.n_heads * self.head_dim
                + 2 * self.d_model * self.n_kv_heads * self.head_dim
                + self.n_heads * self.head_dim * self.d_model)
        router = self.d_model * self.n_experts
        experts = self.n_experts * 3 * self.d_model * self.d_ff
        norms = 2 * self.d_model
        return (emb * 2 + self.d_model
                + self.n_layers * (attn + router + experts + norms))


# Presets (moe.py:55-66); caller kwargs override the defaults.
def tiny_moe_config(**kw) -> MoEConfig:
    return MoEConfig(**{**dict(
        vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=256, max_seq_len=256, n_experts=4, top_k=2), **kw})


def mixtral_8x7b_config(**kw) -> MoEConfig:
    return MoEConfig(**{**dict(
        vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, d_ff=14336, max_seq_len=4096, n_experts=8, top_k=2),
        **kw})


def init_moe_model(cfg: MoEConfig, seed: int = 0, device=None) -> dict:
    """Random layer-stacked parameters drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (None = the GPU), with the JAX
    ``init_moe_model``'s distributions (not its numbers: tests hand both
    packages one set via :func:`.convert.params_from_jax`)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    D, H, Hkv, Dh, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.n_layers)

    def normal(shape, fan_in):
        return fan_in_normal(gen, shape, fan_in, cfg.dtype)

    per_layer = [init_moe_params(gen, D, cfg.d_ff, cfg.n_experts, cfg.dtype)
                 for _ in range(L)]
    moe = {name: torch.stack([p.pop(name) for p in per_layer])
           for name in ("router", "w_gate", "w_up", "w_down")}
    return {
        "embed": normal((cfg.vocab_size, D), 1.0),
        "layers": {
            "attn_norm": torch.ones((L, D), dtype=torch.float32, device=dev),
            "wq": normal((L, D, H * Dh), D),
            "wk": normal((L, D, Hkv * Dh), D),
            "wv": normal((L, D, Hkv * Dh), D),
            "wo": normal((L, H * Dh, D), H * Dh),
            "mlp_norm": torch.ones((L, D), dtype=torch.float32, device=dev),
            "moe": moe,
        },
        "final_norm": torch.ones((D,), dtype=torch.float32, device=dev),
        "lm_head": normal((D, cfg.vocab_size), D),
    }


def moe_model_shardings(cfg: MoEConfig, ep_axis: str = "ep",
                        tp_axis: str | None = "tp") -> dict:
    """Rules of an :func:`init_moe_model` tree (``moe.py:99``): the
    attention tensor-parallel over ``tp_axis`` as in the dense family,
    the experts over ``ep_axis``."""
    return {
        "embed": P(None, tp_axis),
        "layers": {
            "attn_norm": P(None, None),
            "wq": P(None, None, tp_axis),
            "wk": P(None, None, tp_axis),
            "wv": P(None, None, tp_axis),
            "wo": P(None, tp_axis, None),
            "mlp_norm": P(None, None),
            "moe": moe_param_shardings(ep_axis, None, leading=(None,)),
        },
        "final_norm": P(None),
        "lm_head": P(None, tp_axis),
    }


def _moe_mlp_block(x, layer, cfg: MoEConfig, mesh=None, ep_axis: str = "ep",
                   token_mask=None, token_axes: tuple = ("dp",),
                   token_blocks: int = 1, seq_axis: str | None = None):
    """The MoE feed-forward residual block, shared by the training
    forward and the cached generation path; returns (x, layer aux).
    Masked tokens pass through the residual untouched.  On a mesh,
    ``x``'s tokens are this rank's block over ``token_axes`` (and its
    sequence chunk over ``seq_axis``), routed by the dropless ``ep``
    path as ``token_blocks`` blocks."""
    with maybe_span("moe/block"):
        h = _rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
        y, aux = moe_ffn(h, layer["moe"], top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor, mesh=mesh,
                         ep_axis=ep_axis, dispatch_mode=cfg.moe_dispatch,
                         token_mask=token_mask, token_axes=token_axes,
                         token_blocks=token_blocks, seq_axis=seq_axis)
        return x + y, aux


def moe_forward_hidden(params: dict, tokens, cfg: MoEConfig, *, mesh=None,
                       ep_axis: str = "ep", positions=None, sp=None,
                       segment_ids=None, rules=None, dp_axis: str = "dp"):
    """tokens (B, S) -> (final-norm hidden (B, S, D) in ``cfg.dtype``,
    aux fp32 scalar, the mean of the layers' load-balance losses).
    ``mesh``: ``tokens`` are this rank's rows over ``dp_axis``
    (``parallel.mesh.shard_batch``), the experts split over ``ep_axis``
    (read from the leaves' shapes) and the attention over ``tp`` by
    ``rules`` (:func:`moe_model_shardings`; None: whole on every rank);
    the aux loss covers every rank's tokens.  ``sp``: ``tokens`` (and
    ``positions``, ``segment_ids``) are this rank's chunk of the
    sequence (``mesh`` defaults to ``sp.mesh``)."""
    mesh = _sp_mesh(mesh, sp)
    lay = _layout(mesh, rules, ep_axis)
    device = params["embed"].device
    tokens, positions, segment_ids = _model_inputs(tokens, positions,
                                                   segment_ids, device, sp)
    x = _embed(params, tokens, cfg, lay)
    aux = torch.zeros((), dtype=torch.float32, device=device)
    for i in range(cfg.n_layers):
        layer = layer_params(params, i)
        if lay is not None:
            layer = lay.layer(layer)
        x = _attention_block(x, layer, cfg, positions, segment_ids, lay, sp)
        x, layer_aux = _moe_mlp_block(
            x, layer, cfg, mesh, ep_axis, token_axes=(dp_axis,),
            seq_axis=None if sp is None else sp.axis)
        aux = aux + layer_aux
    norm = params["final_norm"] if lay is None else \
        lay.gather(params["final_norm"], lay.spec("final_norm"))
    return _rms_norm(x, norm, cfg.norm_eps), aux / cfg.n_layers


def moe_forward(params: dict, tokens, cfg: MoEConfig, *, mesh=None,
                ep_axis: str = "ep", positions=None, sp=None,
                segment_ids=None, rules=None):
    """tokens (B, S) -> (logits (B, S, vocab) fp32, aux scalar).
    ``segment_ids``: packed documents for attention; expert dispatch
    routes every token whatever its document."""
    x, aux = moe_forward_hidden(params, tokens, cfg, mesh=mesh,
                                ep_axis=ep_axis, positions=positions, sp=sp,
                                segment_ids=segment_ids, rules=rules)
    return _head(x, params, _layout(_sp_mesh(mesh, sp), rules, ep_axis)), aux


def moe_loss_fn(params, batch, cfg: MoEConfig, *, mesh=None,
                ep_axis: str = "ep", sp=None, rules=None,
                dp_axis: str = "dp"):
    """Next-token cross-entropy (the dense family's logits-shift tail)
    plus ``cfg.lb_coef`` times the aux loss (``moe.py:185``).
    ``batch["segments"]`` packs documents: attention masked across them,
    RoPE restarting in each, boundary targets dropped.  With
    ``cfg.ce_chunk`` and a plain lm_head the chunked-vocab tail runs and
    the (B, S, V) logits never exist (off a mesh, as in JAX).

    ``mesh``/``rules``: as :func:`moe_forward_hidden` takes them; the
    result is this rank's loss, as ``transformer.loss_fn``'s on a mesh:
    its mean over ``dp_axis`` is the whole batch's.  The aux term is the
    whole batch's on every rank.  ``sp``: ``batch`` holds whole rows and
    the xent term is ``transformer.loss_fn(sp=)``'s (this rank's share
    times the ranks over ``dp_axis`` and ``sp``)."""
    device = params["embed"].device
    if sp is not None:
        mesh = _sp_mesh(mesh, sp)
        inp = _sp_inputs(batch, sp, device)
        x, aux = moe_forward_hidden(params, inp["tokens"], cfg, mesh=mesh,
                                    ep_axis=ep_axis,
                                    positions=inp["positions"], sp=sp,
                                    segment_ids=inp["segments"], rules=rules,
                                    dp_axis=dp_axis)
        # The standard tail under sp, as in JAX (``moe.py:214``).
        nll_sum = _sp_nll_sum(x, params, _layout(mesh, rules, ep_axis), inp)
        return (_sp_xent(nll_sum, inp["kept"], sp, mesh, dp_axis)
                + cfg.lb_coef * aux)
    tokens = _as_tokens(batch["tokens"], device)
    seg = batch.get("segments") if isinstance(batch, dict) else None
    positions = None
    if seg is not None:
        seg = _as_tokens(seg, device)
        positions = packed_positions(seg)
    x, aux = moe_forward_hidden(params, tokens, cfg, mesh=mesh,
                                ep_axis=ep_axis, positions=positions,
                                segment_ids=seg, rules=rules,
                                dp_axis=dp_axis)
    if mesh is None and _chunked_tail(cfg, params, None):
        return (shifted_chunked_xent(x, params["lm_head"], tokens,
                                     segment_ids=seg, chunk=cfg.ce_chunk)
                + cfg.lb_coef * aux)
    xent = shifted_xent(_head(x, params, _layout(mesh, rules, ep_axis)),
                        tokens, segment_ids=seg)
    return dp_loss_scale(seg, mesh, dp_axis) * xent + cfg.lb_coef * aux
