"""LoRA fine-tuning for the dense transformer (Hu et al. 2021,
arXiv:2106.09685; counterpart of ``nbdistributed_tpu/models/lora.py``).

Adapters are a separate tree mirroring the targeted weights,
``{"layers": {name: {"a": (L, d_in, r), "b": (L, r, d_out)}}}`` with
``a ~ N(0, 1/d_in)`` and ``b = 0``, so the adapted model starts exactly
at the base model.  :func:`lora_merge` adds ``(a @ b) * alpha/r`` onto
the frozen base weights inside the differentiated function, so autograd
reaches the adapters through the merge and every config knob (flash
kernels, remat, window, ``ce_chunk``) applies unchanged.  Optimizer
state exists only for the adapter leaves.

A :class:`.moe.MoEConfig` takes adapters on the attention projections
(its expert weights carry a leading n_experts axis, and per-expert
adapters are another object), and its step trains through
:func:`.moe.moe_loss_fn`.  The adapters' tensor-parallel shardings
(``lora_shardings``) wait for tensor parallelism (ROADMAP A5).
"""

from __future__ import annotations

import torch

from ..ops._common import resolve_device
from ..utils import fan_in_normal
from .moe import MoEConfig, moe_loss_fn
from .transformer import (TransformerConfig, _optimizer_step,
                          layer_weight_dims, loss_fn, param_leaves)

# Classic LoRA targets the attention projections; "all-linear" adds the
# SwiGLU MLP weights (QLoRA-style).
ATTN_TARGETS = ("wq", "wk", "wv", "wo")
ALL_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _check_targets(targets) -> None:
    bad = [t for t in targets if t not in ALL_TARGETS]
    if bad:
        raise ValueError(f"unknown LoRA targets {bad}; valid: "
                         f"{sorted(ALL_TARGETS)}")


def lora_init(seed: int, cfg: TransformerConfig, rank: int,
              targets=ATTN_TARGETS, dtype=None, device=None) -> dict:
    """Adapter tree for ``targets`` (per-layer weight names), drawn from
    a ``torch.Generator`` seeded with ``seed`` on ``device`` (None =
    the GPU): ``a`` fan-in-scaled gaussian, ``b`` zeros.  Same
    distributions as the JAX ``lora_init``, not the same numbers — tests
    hand both packages one set via :func:`.convert.lora_from_jax`."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    _check_targets(targets)
    if isinstance(cfg, MoEConfig):
        bad = [t for t in targets if t not in ATTN_TARGETS]
        if bad:
            raise ValueError(
                f"LoRA targets {bad} are expert weights on a MoE "
                f"config (leading n_experts axis); target the "
                f"attention projections {ATTN_TARGETS} instead")
    dev = resolve_device(device)
    dtype = cfg.dtype if dtype is None else dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    L = cfg.n_layers
    dims = layer_weight_dims(cfg)
    layers = {}
    for name in targets:
        d_in, d_out = dims[name]
        layers[name] = {
            "a": fan_in_normal(gen, (L, d_in, rank), d_in, dtype),
            "b": torch.zeros((L, rank, d_out), dtype=dtype, device=dev),
        }
    return {"layers": layers}


def lora_merge(params: dict, lora: dict, *, alpha: float = 16.0) -> dict:
    """Base params with ``(a @ b) * alpha/r`` added to each targeted
    weight, in fp32 and cast once to the base weight's dtype.
    Differentiable in ``lora``; the base tensors are not modified."""
    merged_layers = dict(params["layers"])
    for name, ab in lora["layers"].items():
        scale = alpha / ab["a"].shape[-1]
        base = params["layers"][name]
        delta = torch.einsum("lir,lro->lio", ab["a"].float(),
                             ab["b"].float()) * scale
        merged_layers[name] = (base.float() + delta).to(base.dtype)
    return {**params, "layers": merged_layers}


def lora_num_params(lora: dict) -> int:
    return sum(t.numel() for t in param_leaves(lora))


def make_lora_train_step(cfg: TransformerConfig, optimizer, *,
                         alpha: float = 16.0):
    """Returns ``step(base_params, lora, batch) -> loss``: only the
    adapters are differentiated and updated (in place), by
    ``optimizer``, which holds the adapter leaves (e.g.
    ``AdamW(param_leaves(lora), lr)``).  The base parameters are left
    untouched (``lora.py:138``).  A :class:`.moe.MoEConfig` trains
    through :func:`.moe.moe_loss_fn`, load balance included."""
    base_loss = moe_loss_fn if isinstance(cfg, MoEConfig) else loss_fn
    return _optimizer_step(
        optimizer, lambda base_params, lora, batch: base_loss(
            lora_merge(base_params, lora, alpha=alpha), batch, cfg))
