"""Parameter conversion between the JAX package's pytree (as numpy
arrays) and the port's dict of tensors.

Both sides use the same layer-stacked layout
(``nbdistributed_tpu/models/transformer.py:157-179``), so conversion is
leaf by leaf.  bf16 leaves (numpy arrays of the ``bfloat16`` extension
type that JAX hands out) cross through float32, which holds every
bf16 value exactly; the port never imports the extension type.  A
quantized weight (``{"q8" int8, "s" fp32}`` or ``{"q4" uint8, "s"
fp32}``, :mod:`.quant`) crosses member by member, its integers copied
bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops._common import resolve_device
from .moe import MoEConfig
from .transformer import (LAYER_WEIGHTS, TransformerConfig, is_quantized,
                          is_quantized4, layer_weight_dims)

_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16, "int8": torch.int8,
                "uint8": torch.uint8}
_INTEGER = ("int8", "uint8")


def _leaf_to_torch(arr, device) -> torch.Tensor:
    name = str(arr.dtype)
    if name not in _TORCH_DTYPE:
        raise TypeError(f"unsupported parameter dtype {name}")
    if name in _INTEGER:          # bit for bit, never through a float
        return torch.from_numpy(np.array(arr, order="C")).to(device)
    f32 = np.array(arr, dtype=np.float32, order="C")  # own, writable
    return torch.from_numpy(f32).to(device=device,
                                    dtype=_TORCH_DTYPE[name])


def _leaf_to_numpy(t) -> np.ndarray:
    if t.dtype in (torch.int8, torch.uint8):
        return t.detach().cpu().numpy()
    return t.detach().to(device="cpu", dtype=torch.float32).numpy()


def _tree_map(fn, leaf):
    """``fn`` over a plain leaf or every leaf of a nested one (a
    quantized leaf, the MoE ``moe`` group)."""
    return ({k: _tree_map(fn, v) for k, v in leaf.items()}
            if isinstance(leaf, dict) else fn(leaf))


def _check_leaf(name: str, leaf, shape: tuple) -> None:
    """A plain leaf must have the config's ``shape``; a quantized one
    the shapes its quantizer gives a weight of that shape."""
    lead, (d_in, d_out) = shape[:-2], shape[-2:]
    if is_quantized(leaf):
        want = {"q8": shape, "s": lead + (1, d_out)}
    elif is_quantized4(leaf):
        G = leaf["s"].shape[-3] if len(leaf["s"].shape) >= 3 else 0
        if G < 1 or d_in % G or (d_in // G) % 2:
            raise ValueError(f"{name}: int4 scales of shape "
                             f"{tuple(leaf['s'].shape)} do not divide "
                             f"d_in {d_in} in even groups")
        want = {"q4": lead + (d_in // 2, d_out), "s": lead + (G, 1, d_out)}
    else:
        want = {"": shape}
        leaf = {"": leaf}
    for key, wshape in want.items():
        if tuple(leaf[key].shape) != wshape:
            raise ValueError(f"{name}{'/' + key if key else ''} has shape "
                             f"{tuple(leaf[key].shape)}, config wants "
                             f"{wshape}")


def _check_plain(name: str, leaf, shape: tuple) -> None:
    if tuple(leaf.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(leaf.shape)}, config "
                         f"wants {shape}")


def _check_shapes(tree: dict, cfg: TransformerConfig) -> None:
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    _check_plain("embed", tree["embed"], (V, D))
    _check_plain("final_norm", tree["final_norm"], (D,))
    _check_leaf("lm_head", tree["lm_head"], (D, V))
    layers = tree["layers"]
    for name in ("attn_norm", "mlp_norm"):
        _check_plain(f"layers/{name}", layers[name], (L, D))
    dims = layer_weight_dims(cfg)
    if isinstance(cfg, MoEConfig):
        # Attention as in the dense family; the experts (moe.py:69-96)
        # in place of the dense MLP weights.
        E, Fd, moe = cfg.n_experts, cfg.d_ff, layers["moe"]
        _check_plain("layers/moe/router", moe["router"], (L, D, E))
        for name, shape in (("w_gate", (L, E, D, Fd)),
                            ("w_up", (L, E, D, Fd)),
                            ("w_down", (L, E, Fd, D))):
            _check_leaf(f"layers/moe/{name}", moe[name], shape)
        dims = {k: dims[k] for k in ("wq", "wk", "wv", "wo")}
    for name, wdims in dims.items():
        _check_leaf(f"layers/{name}", layers[name], (L,) + wdims)


def _layer_names(cfg) -> tuple:
    if isinstance(cfg, MoEConfig):
        return ("wq", "wk", "wv", "wo", "moe", "attn_norm", "mlp_norm")
    return LAYER_WEIGHTS + ("attn_norm", "mlp_norm")


def params_from_jax(np_tree: dict, cfg: TransformerConfig,
                    device=None) -> dict:
    """The JAX pytree ``{"embed", "layers": {...}, "final_norm",
    "lm_head"}`` of numpy arrays -> the port's parameters on ``device``
    (None = the GPU).  Each leaf keeps its own dtype (weights in the
    model dtype, norm gains and the MoE router fp32, quantized members
    int8 / uint8 / fp32); a :class:`.moe.MoEConfig` carries the
    ``layers["moe"]`` subtree across."""
    dev = resolve_device(device)
    _check_shapes(np_tree, cfg)
    layer_names = _layer_names(cfg)

    def conv(leaf):
        return _tree_map(lambda a: _leaf_to_torch(a, dev), leaf)

    return {
        "embed": conv(np_tree["embed"]),
        "layers": {name: conv(np_tree["layers"][name])
                   for name in layer_names},
        "final_norm": conv(np_tree["final_norm"]),
        "lm_head": conv(np_tree["lm_head"]),
    }


def params_to_numpy(params: dict) -> dict:
    """The inverse, for tests: every float leaf as a float32 numpy array
    (bf16 widened exactly), quantized members in their own dtype."""

    def conv(leaf):
        return _tree_map(_leaf_to_numpy, leaf)

    return {"embed": conv(params["embed"]),
            "layers": {k: conv(v) for k, v in params["layers"].items()},
            "final_norm": conv(params["final_norm"]),
            "lm_head": conv(params["lm_head"])}


def lora_from_jax(np_tree: dict, device=None) -> dict:
    """The JAX adapter tree ``{"layers": {name: {"a", "b"}}}`` of numpy
    arrays -> the port's on ``device`` (None = the GPU), each leaf in
    its own dtype."""
    dev = resolve_device(device)
    return {"layers": {name: {ab: _leaf_to_torch(arr, dev)
                              for ab, arr in leaves.items()}
                       for name, leaves in np_tree["layers"].items()}}


def lora_to_numpy(lora: dict) -> dict:
    """The inverse of :func:`lora_from_jax`, every leaf as float32."""
    return {"layers": {name: {ab: _leaf_to_numpy(t)
                              for ab, t in leaves.items()}
                       for name, leaves in lora["layers"].items()}}
