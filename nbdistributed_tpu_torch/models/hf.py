"""HuggingFace interop: Llama- and Mixtral-family checkpoints into the
port's parameters (counterpart of ``nbdistributed_tpu/models/hf.py``).

Converts a ``transformers`` Llama-architecture model (Llama 1/2/3,
SmolLM2, TinyLlama, ...) or a Mixtral one into the layer-stacked dicts
that :func:`~.transformer.forward` and :func:`~.moe.moe_forward`
consume.  The torch tensors go straight into the port's dicts — no
numpy hop — each layer cast to the target dtype before stacking, onto
``device`` (None = the GPU).  Values equal the JAX package's
conversion bit for bit: both read each tensor as float32 and round
once to the target dtype.

Conventions (verified against ``transformers`` by the tests):

* torch ``nn.Linear`` stores (out_features, in_features); our params
  right-multiply, so every projection transposes.
* Head ordering: HF's q/k/v rows are [head0 x Dh, head1 x Dh, ...] —
  transposing preserves our ``reshape(B, S, H, Dh)`` grouping.
* RoPE: HF's rotate-half with cos/sin repeated over both halves is
  algebraically identical to our half-split form (same
  theta^(-2i/head_dim) frequencies).
* ``tie_word_embeddings`` (SmolLM2 does) -> ``lm_head = embed.T``.

:func:`params_from_hf` and :func:`moe_params_from_hf` take any object
with ``.config`` and ``.state_dict()``; only :func:`load_hf_pretrained`
imports ``transformers``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..ops._common import resolve_device
from .moe import MoEConfig
from .transformer import TransformerConfig


def config_from_hf(hf_config) -> TransformerConfig:
    """Map a ``transformers`` Llama-family config onto
    :class:`TransformerConfig`.  Rejects rope-scaling variants this
    forward does not implement rather than silently mis-rotating.
    ``transformers`` 5 keeps the rotary base and type in
    ``rope_parameters`` (and no ``rope_theta`` attribute); 4.x in
    ``rope_theta`` and ``rope_scaling``.  Both are read."""
    rope = getattr(hf_config, "rope_parameters", None) or {}
    scaling = getattr(hf_config, "rope_scaling", None) or rope
    if scaling:
        rope_type = (scaling.get("rope_type")
                     or scaling.get("type") or "?")
        if rope_type != "default":
            raise ValueError(
                f"rope_scaling type {rope_type!r} is not supported "
                "(plain rotary only); use a base-rope checkpoint")
    if getattr(hf_config, "attention_bias", False):
        raise ValueError("attention_bias=True checkpoints are not "
                         "supported (Llama family uses bias-free "
                         "projections)")
    if getattr(hf_config, "mlp_bias", False):
        raise ValueError("mlp_bias=True checkpoints are not supported")
    head_dim = getattr(hf_config, "head_dim", None)
    expect = hf_config.hidden_size // hf_config.num_attention_heads
    if head_dim is not None and head_dim != expect:
        raise ValueError(
            f"head_dim {head_dim} != hidden_size/n_heads {expect}: "
            "decoupled head_dim is not supported")
    # Some HF configs (e.g. Qwen2) carry sliding_window but gate it
    # off with use_sliding_window=False.
    window = getattr(hf_config, "sliding_window", None)
    if not getattr(hf_config, "use_sliding_window", True):
        window = None
    return TransformerConfig(
        sliding_window=window,
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(hf_config, "num_key_value_heads",
                           hf_config.num_attention_heads),
        d_ff=hf_config.intermediate_size,
        max_seq_len=getattr(hf_config, "max_position_embeddings", 2048),
        rope_theta=float(getattr(hf_config, "rope_theta", None)
                         or rope.get("rope_theta", 10000.0)),
        norm_eps=float(getattr(hf_config, "rms_norm_eps", 1e-5)),
    )


def _cast(t: torch.Tensor, dtype, device, transpose: bool = False):
    """One tensor read as float32 (exact for every checkpoint dtype),
    optionally transposed, rounded once to ``dtype`` on ``device``."""
    t = t.detach().to(device=device, dtype=torch.float32)
    if transpose:
        t = t.T
    return t.to(dtype).contiguous()


def _stack(sd, fmt: str, L: int, transpose: bool, device,
           dtype=torch.float32) -> torch.Tensor:
    """Stack L per-layer tensors, casting each layer to ``dtype``
    before stacking so the fp32 transient is one layer, not the whole
    (L, ...) stack (matters at Mixtral/Llama-7B scale)."""
    return torch.stack([_cast(sd[fmt.format(i)], dtype, device, transpose)
                        for i in range(L)])


def _attn_and_embed(sd, L: int, dtype, device) -> dict:
    """The conversion both families share: embed, (possibly tied)
    lm_head, attention projections, and the two per-layer norms."""
    embed = sd["model.embed_tokens.weight"]                  # (V, D)
    head = sd.get("lm_head.weight", embed)                   # tied: embed
    layers = {
        "attn_norm": _stack(
            sd, "model.layers.{}.input_layernorm.weight", L, False, device),
        "mlp_norm": _stack(
            sd, "model.layers.{}.post_attention_layernorm.weight", L,
            False, device),
    }
    for ours, theirs in (("wq", "q_proj"), ("wk", "k_proj"),
                         ("wv", "v_proj"), ("wo", "o_proj")):
        layers[ours] = _stack(
            sd, f"model.layers.{{}}.self_attn.{theirs}.weight", L, True,
            device, dtype)
    return {
        "embed": _cast(embed, dtype, device),
        "layers": layers,
        "final_norm": _cast(sd["model.norm.weight"], torch.float32, device),
        "lm_head": _cast(head, dtype, device, transpose=True),   # (D, V)
    }


def params_from_hf(model, cfg: TransformerConfig | None = None, *,
                   dtype: Any = torch.bfloat16,
                   device=None) -> tuple[dict, TransformerConfig]:
    """Convert a ``transformers`` ``LlamaForCausalLM``-shaped model (or
    any object with its ``.config`` and ``state_dict()`` naming) into
    the port's parameters on ``device`` (None = the GPU).

    Returns ``(params, cfg)`` with weights in ``dtype`` (norms stay
    fp32, as :func:`~.transformer.init_params` makes them), per-layer
    tensors stacked along a leading (n_layers,) axis.
    """
    dev = resolve_device(device)
    if cfg is None:
        cfg = config_from_hf(model.config)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    sd = model.state_dict()
    L = cfg.n_layers
    params = _attn_and_embed(sd, L, dtype, dev)
    for ours, theirs in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                         ("w_down", "down_proj")):
        params["layers"][ours] = _stack(
            sd, f"model.layers.{{}}.mlp.{theirs}.weight", L, True, dev,
            dtype)
    return params, cfg


def moe_config_from_hf(hf_config, *,
                       capacity_factor: float | None = None) -> MoEConfig:
    """Map a ``transformers`` Mixtral-family config onto
    :class:`~.moe.MoEConfig`.

    HF Mixtral routes without capacity limits; this framework's
    dispatch is capacity-bounded, so the default ``capacity_factor``
    is the *lossless* value ``n_experts / top_k`` (no token ever
    dropped — logits match the torch forward).  Pass a tighter factor
    to trade exactness for bounded expert memory."""
    E = hf_config.num_local_experts
    k = hf_config.num_experts_per_tok
    base = config_from_hf(hf_config)
    if capacity_factor is None:
        capacity_factor = E / k
    return MoEConfig(**{**base.__dict__, "n_experts": E, "top_k": k,
                        "capacity_factor": capacity_factor,
                        "lb_coef": float(getattr(
                            hf_config, "router_aux_loss_coef", 0.01))})


def moe_params_from_hf(model, *, dtype: Any = torch.bfloat16,
                       capacity_factor: float | None = None,
                       device=None) -> tuple[dict, MoEConfig]:
    """Convert a ``transformers`` ``MixtralForCausalLM``-shaped model
    into the MoE family's parameters on ``device`` (None = the GPU):
    attention exactly as the dense conversion; the router fp32,
    transposed; per-expert w1/w3/w2 → w_gate/w_up/w_down stacked on a
    leading E axis.  Returns ``(params, cfg)``."""
    dev = resolve_device(device)
    cfg = moe_config_from_hf(model.config,
                             capacity_factor=capacity_factor)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    sd = model.state_dict()
    L, E = cfg.n_layers, cfg.n_experts

    def stack_experts(w: str) -> torch.Tensor:
        # (L, E, in, out) from per-expert torch (out, in) tensors, cast
        # PER LAYER so the fp32 transient is one (E, in, out) slab, not
        # the whole L*E expert stack.
        return torch.stack([torch.stack([
            _cast(sd[f"model.layers.{i}.block_sparse_moe.experts.{e}"
                     f".{w}.weight"], dtype, dev, transpose=True)
            for e in range(E)]) for i in range(L)])

    params = _attn_and_embed(sd, L, dtype, dev)
    params["layers"]["moe"] = {
        # The router stays fp32: gating is numerically delicate.
        "router": _stack(
            sd, "model.layers.{}.block_sparse_moe.gate.weight", L, True,
            dev),
        "w_gate": stack_experts("w1"),
        "w_up": stack_experts("w3"),
        "w_down": stack_experts("w2"),
    }
    return params, cfg


def load_hf_pretrained(name_or_path: str, *, dtype: Any = torch.bfloat16,
                       device=None) -> tuple[dict, Any]:
    """``from_pretrained`` from a local path (torch, CPU) -> (params,
    cfg) on ``device`` (None = the GPU).  Dispatches on architecture:
    Mixtral-family checkpoints convert through
    :func:`moe_params_from_hf`, Llama family through
    :func:`params_from_hf`.  The ``transformers`` model is freed before
    returning."""
    from transformers import AutoModelForCausalLM

    # The checkpoint's own dtype: forcing fp32 would double a
    # Mixtral-class model's host footprint before conversion (each
    # tensor's fp32 hop happens inside _cast, one tensor at a time).
    model = AutoModelForCausalLM.from_pretrained(
        name_or_path, dtype="auto", low_cpu_mem_usage=True)
    try:
        if getattr(model.config, "num_local_experts", None):
            return moe_params_from_hf(model, dtype=dtype, device=device)
        return params_from_hf(model, dtype=dtype, device=device)
    finally:
        del model
