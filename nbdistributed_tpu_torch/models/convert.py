"""Parameter conversion between the JAX package's pytree (as numpy
arrays) and the port's dict of tensors.

Both sides use the same layer-stacked layout
(``nbdistributed_tpu/models/transformer.py:157-179``), so conversion is
leaf by leaf.  bf16 leaves (numpy arrays of the ``bfloat16`` extension
type that JAX hands out) cross through float32, which holds every
bf16 value exactly; the port never imports the extension type.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops._common import resolve_device
from .transformer import LAYER_WEIGHTS, TransformerConfig

_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}


def _leaf_to_torch(arr, device) -> torch.Tensor:
    name = str(arr.dtype)
    if name not in _TORCH_DTYPE:
        raise TypeError(f"unsupported parameter dtype {name}")
    f32 = np.array(arr, dtype=np.float32, order="C")  # own, writable
    return torch.from_numpy(f32).to(device=device,
                                    dtype=_TORCH_DTYPE[name])


def _leaf_to_numpy(t) -> np.ndarray:
    return t.detach().to(device="cpu", dtype=torch.float32).numpy()


def _check_shapes(tree: dict, cfg: TransformerConfig) -> None:
    from .transformer import layer_weight_dims

    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    want = {("embed",): (V, D), ("final_norm",): (D,),
            ("lm_head",): (D, V),
            ("layers", "attn_norm"): (L, D), ("layers", "mlp_norm"): (L, D)}
    for name, dims in layer_weight_dims(cfg).items():
        want[("layers", name)] = (L,) + dims
    for path, shape in want.items():
        leaf = tree
        for key in path:
            leaf = leaf[key]
        if tuple(leaf.shape) != shape:
            raise ValueError(f"{'/'.join(path)} has shape "
                             f"{tuple(leaf.shape)}, config wants {shape}")


def params_from_jax(np_tree: dict, cfg: TransformerConfig,
                    device=None) -> dict:
    """The JAX pytree ``{"embed", "layers": {...}, "final_norm",
    "lm_head"}`` of numpy arrays -> the port's parameters on ``device``
    (None = the GPU).  Each leaf keeps its own dtype (weights in the
    model dtype, norm gains fp32)."""
    dev = resolve_device(device)
    _check_shapes(np_tree, cfg)
    layer_names = LAYER_WEIGHTS + ("attn_norm", "mlp_norm")
    return {
        "embed": _leaf_to_torch(np_tree["embed"], dev),
        "layers": {name: _leaf_to_torch(np_tree["layers"][name], dev)
                   for name in layer_names},
        "final_norm": _leaf_to_torch(np_tree["final_norm"], dev),
        "lm_head": _leaf_to_torch(np_tree["lm_head"], dev),
    }


def params_to_numpy(params: dict) -> dict:
    """The inverse, for tests: every leaf as a float32 numpy array
    (bf16 widened exactly)."""
    return {"embed": _leaf_to_numpy(params["embed"]),
            "layers": {k: _leaf_to_numpy(v)
                       for k, v in params["layers"].items()},
            "final_norm": _leaf_to_numpy(params["final_norm"]),
            "lm_head": _leaf_to_numpy(params["lm_head"])}


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
