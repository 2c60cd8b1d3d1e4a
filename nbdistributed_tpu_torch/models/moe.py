"""Mixture-of-experts decoder transformer, Mixtral-style (counterpart of
``nbdistributed_tpu/models/moe.py``, one device).

The dense family's attention, RMSNorm and rotary stack
(:mod:`.transformer`; K1 forward, K2/K3 backward) with the SwiGLU MLP
swapped for the expert layer (:func:`..parallel.expert.moe_ffn`).
Per-layer tensors carry a leading (n_layers,) axis, the experts' a
second (n_experts,) one: ``layers["moe"] = {"router" (L, D, E) fp32,
"w_gate", "w_up" (L, E, D, F), "w_down" (L, E, F, D)}``.  The forward
loops over layers and returns the load-balance aux loss averaged over
them.  Sequence parallelism and expert meshes wait for the process
group (ROADMAP A5, A5a, A2).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops._common import resolve_device
from ..ops.xent import shifted_chunked_xent
from ..parallel.expert import init_moe_params, moe_ffn
from ..utils import fan_in_normal
from .transformer import (TransformerConfig, _as_tokens, _attention_block,
                          _rms_norm, is_quantized, is_quantized4,
                          layer_params, packed_positions, qlinear,
                          shifted_xent)


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


def _moe_mlp_block(x, layer, cfg: MoEConfig, mesh=None, ep_axis: str = "ep",
                   token_mask=None):
    """The MoE feed-forward residual block, shared by the training
    forward and the cached generation path; returns (x, layer aux).
    Masked tokens pass through the residual untouched."""
    h = _rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    y, aux = moe_ffn(h, layer["moe"], top_k=cfg.top_k,
                     capacity_factor=cfg.capacity_factor, mesh=mesh,
                     ep_axis=ep_axis, dispatch_mode=cfg.moe_dispatch,
                     token_mask=token_mask)
    return x + y, aux


def _check_parallel(mesh, sp) -> None:
    if sp is not None:
        raise NotImplementedError("sp: sequence parallelism needs the "
                                  "port's process group (ROADMAP A5)")
    if mesh is not None:
        raise NotImplementedError("mesh: expert parallelism needs the "
                                  "port's process group (ROADMAP A5a, "
                                  "then A2)")


def moe_forward_hidden(params: dict, tokens, cfg: MoEConfig, *, mesh=None,
                       ep_axis: str = "ep", positions=None, sp=None,
                       segment_ids=None):
    """tokens (B, S) -> (final-norm hidden (B, S, D) in ``cfg.dtype``,
    aux fp32 scalar, the mean of the layers' load-balance losses)."""
    _check_parallel(mesh, sp)
    device = params["embed"].device
    tokens = _as_tokens(tokens, device)
    B, S = tokens.shape
    positions = (torch.arange(S, device=device).expand(B, S)
                 if positions is None else _as_tokens(positions, device))
    if segment_ids is not None:
        segment_ids = _as_tokens(segment_ids, device)
    x = params["embed"][tokens].to(cfg.dtype)
    aux = torch.zeros((), dtype=torch.float32, device=device)
    for i in range(cfg.n_layers):
        layer = layer_params(params, i)
        x = _attention_block(x, layer, cfg, positions, segment_ids)
        x, layer_aux = _moe_mlp_block(x, layer, cfg)
        aux = aux + layer_aux
    return _rms_norm(x, params["final_norm"], cfg.norm_eps), \
        aux / cfg.n_layers


def moe_forward(params: dict, tokens, cfg: MoEConfig, *, mesh=None,
                ep_axis: str = "ep", positions=None, sp=None,
                segment_ids=None):
    """tokens (B, S) -> (logits (B, S, vocab) fp32, aux scalar).
    ``segment_ids``: packed documents for attention; expert dispatch
    routes every token whatever its document."""
    x, aux = moe_forward_hidden(params, tokens, cfg, mesh=mesh,
                                ep_axis=ep_axis, positions=positions, sp=sp,
                                segment_ids=segment_ids)
    return qlinear(x, params["lm_head"]).float(), aux


def moe_loss_fn(params, batch, cfg: MoEConfig, *, mesh=None,
                ep_axis: str = "ep", sp=None):
    """Next-token cross-entropy (the dense family's logits-shift tail)
    plus ``cfg.lb_coef`` times the aux loss (``moe.py:185``).
    ``batch["segments"]`` packs documents: attention masked across them,
    RoPE restarting in each, boundary targets dropped.  With
    ``cfg.ce_chunk`` and a plain lm_head the chunked-vocab tail runs and
    the (B, S, V) logits never exist."""
    _check_parallel(mesh, sp)
    device = params["embed"].device
    tokens = _as_tokens(batch["tokens"], device)
    seg = batch.get("segments") if isinstance(batch, dict) else None
    positions = None
    if seg is not None:
        seg = _as_tokens(seg, device)
        positions = packed_positions(seg)
    head = params["lm_head"]
    if (cfg.ce_chunk is not None and not is_quantized(head)
            and not is_quantized4(head)):
        x, aux = moe_forward_hidden(params, tokens, cfg,
                                    positions=positions, segment_ids=seg)
        return (shifted_chunked_xent(x, head, tokens, segment_ids=seg,
                                     chunk=cfg.ce_chunk)
                + cfg.lb_coef * aux)
    logits, aux = moe_forward(params, tokens, cfg, positions=positions,
                              segment_ids=seg)
    return shifted_xent(logits, tokens, segment_ids=seg) + cfg.lb_coef * aux
