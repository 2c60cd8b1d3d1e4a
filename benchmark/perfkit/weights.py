"""Random weights made on the device from ``--seed``, in the type they
are served in, laid out as the port takes them (layer-stacked leaves:
``{"embed", "layers": {...}, "final_norm", "lm_head"}``, the MoE
family's experts under ``layers["moe"]``).

Each leaf has a generator of its own, seeded from (seed, leaf), and is
drawn into its stacked buffer one layer slice at a time; so any leaf
can be made again alone (the change of a leaf over training steps, the
reference after the window) without holding the tree twice.  The
distributions are the port's own initialisers': fan-in normal weights,
norms at one, the router ``N(0, 0.02^2)`` in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def leaf_specs(sizes: dict) -> dict:
    """path -> (shape, dtype name, std or None for ones)."""
    V, D, L = sizes["vocab_size"], sizes["d_model"], sizes["n_layers"]
    H, Hkv, F = sizes["n_heads"], sizes["n_kv_heads"], sizes["d_ff"]
    Dh = D // H
    wd = sizes["dtype"]
    specs = {
        "embed": ((V, D), wd, 1.0),
        "lm_head": ((D, V), wd, 1 / math.sqrt(D)),
        "final_norm": ((D,), "float32", None),
        "layers/attn_norm": ((L, D), "float32", None),
        "layers/mlp_norm": ((L, D), "float32", None),
        "layers/wq": ((L, D, H * Dh), wd, 1 / math.sqrt(D)),
        "layers/wk": ((L, D, Hkv * Dh), wd, 1 / math.sqrt(D)),
        "layers/wv": ((L, D, Hkv * Dh), wd, 1 / math.sqrt(D)),
        "layers/wo": ((L, H * Dh, D), wd, 1 / math.sqrt(H * Dh)),
    }
    E = sizes.get("n_experts")
    if E:
        specs.update({
            "layers/moe/router": ((L, D, E), "float32", 0.02),
            "layers/moe/w_gate": ((L, E, D, F), wd, 1 / math.sqrt(D)),
            "layers/moe/w_up": ((L, E, D, F), wd, 1 / math.sqrt(D)),
            "layers/moe/w_down": ((L, E, F, D), wd, 1 / math.sqrt(F)),
        })
    else:
        specs.update({
            "layers/w_gate": ((L, D, F), wd, 1 / math.sqrt(D)),
            "layers/w_up": ((L, D, F), wd, 1 / math.sqrt(D)),
            "layers/w_down": ((L, F, D), wd, 1 / math.sqrt(F)),
        })
    return specs


def leaf_seed(seed: int, path: str) -> int:
    key = [int(seed) % (1 << 64)] + list(path.encode())
    state = np.random.SeedSequence(key).generate_state(2, np.uint32)
    return int(state[0]) | (int(state[1] & 0x7FFFFFFF) << 32)


def make_leaf(sizes: dict, seed: int, path: str, device) -> torch.Tensor:
    shape, dtype, std = leaf_specs(sizes)[path]
    if std is None:
        return torch.ones(shape, dtype=DTYPES[dtype], device=device)
    out = torch.empty(shape, dtype=DTYPES[dtype], device=device)
    g = torch.Generator(device=device)
    g.manual_seed(leaf_seed(seed, path))
    for part in (out if out.ndim > 2 else [out]):
        part.normal_(0.0, std, generator=g)
    return out


def make(sizes: dict, seed: int, device) -> dict:
    """The whole tree, nested by the paths' ``/``."""
    tree: dict = {}
    for path in leaf_specs(sizes):
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = make_leaf(sizes, seed, path, device)
    return tree


def get(tree: dict, path: str) -> torch.Tensor:
    node = tree
    for p in path.split("/"):
        node = node[p]
    return node


def sizes_of(cfg) -> dict:
    """The plain numbers of a port config object (a dataclass)."""
    out = {k: getattr(cfg, k) for k in (
        "vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads",
        "d_ff", "rope_theta", "norm_eps", "sliding_window")}
    out["dtype"] = {v: k for k, v in DTYPES.items()}[cfg.dtype]
    for k in ("n_experts", "top_k"):
        if hasattr(cfg, k):
            out[k] = getattr(cfg, k)
    return out
