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
:func:`.moe.moe_loss_fn`.

On a mesh the adapters follow their base weight's Megatron split
(:func:`lora_shardings`): a column-split weight's ``b`` splits its
output columns, a row-split weight's ``a`` its contraction rows, and
the factor left whole enters the merge through Megatron's ``f`` (each
``tp`` rank's slice of the delta gives only its share of that factor's
gradient).
"""

from __future__ import annotations

import torch

from ..ops._common import resolve_device
from ..parallel.mesh import P, _spec_axes
from ..utils import fan_in_normal
from .moe import MoEConfig, moe_loss_fn, moe_model_shardings
from .transformer import (TransformerConfig, _optimizer_step,
                          layer_weight_dims, loss_fn, param_leaves,
                          param_shardings)

# Classic LoRA targets the attention projections; "all-linear" adds the
# SwiGLU MLP weights (QLoRA-style).
ATTN_TARGETS = ("wq", "wk", "wv", "wo")
ALL_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

# The tensor-parallel split of each target (transformer.param_shardings):
# "col" = output columns over tp, "row" = contraction rows over tp.
_SPLIT = {"wq": "col", "wk": "col", "wv": "col", "w_gate": "col",
          "w_up": "col", "wo": "row", "w_down": "row"}


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


def lora_merge(params: dict, lora: dict, *, alpha: float = 16.0,
               mesh=None, rules=None) -> dict:
    """Base params with ``(a @ b) * alpha/r`` added to each targeted
    weight, in fp32 and cast once to the base weight's dtype.
    Differentiable in ``lora``; the base tensors are not modified.
    ``mesh``/``rules`` (:func:`lora_shardings`): this rank's factors of
    a tree cut by the rules, merged into its base shards."""
    merged_layers = dict(params["layers"])
    for name, ab in lora["layers"].items():
        scale = alpha / ab["a"].shape[-1]
        base = params["layers"][name]
        a, b = ab["a"], ab["b"]
        if mesh is not None and rules is not None and mesh.size("tp") > 1:
            spec = rules["layers"][name]
            if "tp" in _spec_axes(spec["b"][-1]):
                a = mesh.copy_to(a, "tp")
            elif "tp" in _spec_axes(spec["a"][-2]):
                b = mesh.copy_to(b, "tp")
        delta = torch.einsum("lir,lro->lio", a.float(), b.float()) * scale
        merged_layers[name] = (base.float() + delta).to(base.dtype)
    return {**params, "layers": merged_layers}


def lora_shardings(cfg: TransformerConfig, lora_or_targets) -> dict:
    """Rules for the adapter tree (``lora.py:115``), from the base
    weight's Megatron split: a column-split target shards ``b``'s output
    columns, a row-split target ``a``'s contraction rows; the rank axis
    stays whole."""
    targets = (tuple(lora_or_targets["layers"])
               if isinstance(lora_or_targets, dict) else
               tuple(lora_or_targets))
    _check_targets(targets)
    return {"layers": {
        name: ({"a": P(None, None, None), "b": P(None, None, "tp")}
               if _SPLIT[name] == "col" else
               {"a": P(None, "tp", None), "b": P(None, None, None)})
        for name in targets}}


def lora_num_params(lora: dict) -> int:
    return sum(t.numel() for t in param_leaves(lora))


def make_lora_train_step(cfg: TransformerConfig, optimizer, *,
                         alpha: float = 16.0, sp=None, mesh=None,
                         ep_axis: str = "ep"):
    """Returns ``step(base_params, lora, batch) -> loss``: only the
    adapters are differentiated and updated (in place), by
    ``optimizer``, which holds the adapter leaves (e.g.
    ``AdamW(param_leaves(lora), lr)``).  The base parameters are left
    untouched (``lora.py:138``).  A :class:`.moe.MoEConfig` trains
    through :func:`.moe.moe_loss_fn`, load balance included.

    ``mesh`` (``ep_axis`` for a MoE config's experts): ``batch`` is this
    rank's rows over ``dp``, and on a mesh with ``tp`` ``base_params``
    and ``lora`` are this rank's shards of trees cut by
    ``param_shardings`` (``moe_model_shardings``) and
    :func:`lora_shardings` (whole without ``tp``; experts split over
    ``ep`` either way).  The adapters' gradients are averaged over
    ``dp`` (:func:`..parallel.tensor_parallel.make_tp_train_step`).

    ``sp`` (a ``transformer.SeqParallel``; ``lora.py:138``): attention
    runs sequence-parallel on ``sp.mesh`` (``mesh`` defaults to it),
    ``batch`` holds whole rows, and the gradients are averaged over
    ``sp``'s axis too — long-context adapter training, the merge
    happening before the forward as in JAX."""
    moe = isinstance(cfg, MoEConfig)
    if sp is not None and mesh is None:
        mesh = sp.mesh
    if mesh is None:
        base_loss = moe_loss_fn if moe else loss_fn
        return _optimizer_step(
            optimizer, lambda base_params, lora, batch: base_loss(
                lora_merge(base_params, lora, alpha=alpha), batch, cfg))
    from ..parallel.tensor_parallel import make_tp_train_step
    tp = mesh.size("tp") > 1
    rules = None
    if tp:
        rules = (moe_model_shardings(cfg, ep_axis=ep_axis) if moe
                 else param_shardings(cfg))

    def base_loss(params, batch):
        if moe:
            return moe_loss_fn(params, batch, cfg, mesh=mesh,
                               ep_axis=ep_axis, rules=rules, sp=sp)
        return loss_fn(params, batch, cfg, mesh=mesh, rules=rules, sp=sp)

    def step(base_params, lora, batch):
        lrules = lora_shardings(cfg, lora) if tp else None
        return make_tp_train_step(
            lambda ad, b: base_loss(lora_merge(base_params, ad, alpha=alpha,
                                               mesh=mesh, rules=lrules), b),
            optimizer, mesh, lrules,
            sp_axis=None if sp is None else sp.axis)(lora, batch)

    return step
