"""Tensor parallelism: placing a parameter tree on a mesh by its rules
(counterpart of ``nbdistributed_tpu/parallel/tensor_parallel.py``).

A rule tree mirrors the parameter tree with a :class:`.mesh.P` per
leaf (``models.transformer.param_shardings``: columns of wq/wk/wv/
w_gate/w_up and rows of wo/w_down over ``tp``).  :func:`apply_shardings`
gives each rank its slice of every leaf — the counterpart of
``jax.device_put(x, NamedSharding(mesh, spec))`` — and the model code
issues the Megatron pattern's one all-reduce per block itself, where
XLA compiles it from the sharding in the JAX package.  The training
step builder on a tp mesh (``make_tp_train_step``) is training on a
mesh, ROADMAP A8.
"""

from __future__ import annotations

import math

import torch

from .mesh import P, local_slice, spec_split


def _is_int4(node) -> bool:
    return isinstance(node, dict) and "q4" in node and "s" in node


def int4_row_shard(leaf: dict, n: int, idx: int) -> dict:
    """Shard ``idx`` of ``n`` of an int4 leaf split on its contraction
    rows: the packed rows' slice, and the grouped scales re-cut so that
    each local group lies inside one original group.  A shard's rows
    need not start on a group boundary (G need not divide the axis), so
    the local groups are ``gcd(group, rows / n)`` rows, each carrying
    its original group's scale: the same weights, grouped finer."""
    q4, s = leaf["q4"], leaf["s"]
    if n == 1:
        return leaf
    packed = q4.shape[-2]
    if packed % n:
        raise ValueError(f"int4 leaf with {2 * packed} contraction rows "
                         f"is not divisible into {n} shards")
    d_in, rows = 2 * packed, 2 * packed // n
    group = d_in // s.shape[-3]
    sub = math.gcd(group, rows)
    row0 = idx * rows
    src = torch.tensor([(row0 + j * sub) // group
                        for j in range(rows // sub)], device=s.device)
    return {"q4": q4.narrow(q4.ndim - 2, idx * packed // n, packed // n),
            "s": s.index_select(s.ndim - 3, src)}


def _shard(x, mesh, spec):
    """This rank's slice of tensor ``x`` under ``spec``, as a tensor of
    its own (the full one can be freed)."""
    if spec is None:
        return x
    sliced = False
    for dim, entry in enumerate(spec):
        n, idx = spec_split(mesh, entry)
        if n > 1:
            x = local_slice(x, dim, n, idx)
            sliced = True
    return x.clone(memory_format=torch.contiguous_format) if sliced else x


def apply_shardings(tree, mesh, rules):
    """Each leaf of ``tree`` sliced to this rank's shard by the matching
    :class:`.mesh.P` of ``rules`` (same structure; ``None`` or ``P()``
    replicates).  An int4 leaf whose packed rows are split gets its
    scales re-cut with them (:func:`int4_row_shard`)."""
    if isinstance(rules, P) or rules is None:
        if isinstance(tree, dict):
            raise ValueError(f"a partition spec {rules!r} met a subtree "
                             f"with keys {sorted(tree)}: give each leaf "
                             f"its spec")
        return _shard(tree, mesh, rules)
    if not isinstance(tree, dict) or set(tree) != set(rules):
        raise ValueError(f"rules {sorted(rules)} do not match the tree "
                         f"{sorted(tree) if isinstance(tree, dict) else tree}")
    if _is_int4(tree):
        spec = rules["q4"]
        row = spec[-2] if len(spec) >= 2 else None
        n, idx = spec_split(mesh, row)
        out = int4_row_shard(tree, n, idx)
        s_spec = P(*rules["s"][:-3], None, *rules["s"][-2:])
        own = lambda t: t.clone(memory_format=torch.contiguous_format)
        return {"q4": own(_shard(out["q4"], mesh,
                                 P(*spec[:-2], None, *spec[-1:]))),
                "s": own(_shard(out["s"], mesh, s_spec))}
    return {k: apply_shardings(tree[k], mesh, rules[k]) for k in tree}


def sharding_tree(mesh, rules):
    """``(mesh, spec)`` per leaf of ``rules``: the port has no sharding
    object, so a leaf's placement is its mesh and spec."""
    if isinstance(rules, P) or rules is None:
        return (mesh, rules)
    return {k: sharding_tree(mesh, v) for k, v in rules.items()}
