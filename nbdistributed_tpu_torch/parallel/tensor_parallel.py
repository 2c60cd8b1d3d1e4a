"""Tensor parallelism: placing a parameter tree on a mesh by its rules
(counterpart of ``nbdistributed_tpu/parallel/tensor_parallel.py``).

A rule tree mirrors the parameter tree with a :class:`.mesh.P` per
leaf (``models.transformer.param_shardings``: columns of wq/wk/wv/
w_gate/w_up and rows of wo/w_down over ``tp``).  :func:`apply_shardings`
gives each rank its slice of every leaf — the counterpart of
``jax.device_put(x, NamedSharding(mesh, spec))`` — and the model code
issues the Megatron pattern's one all-reduce per block itself, where
XLA compiles it from the sharding in the JAX package.

:func:`make_tp_train_step` (``tensor_parallel.py:35``) is the one
training step on a mesh: DDP (:mod:`.data_parallel`), Megatron tp,
FSDP/HSDP and ZeRO-1/2 (:mod:`.zero`) are its layouts.  Every rank
runs it on its rows of the batch and its shard of the tree; the loss
function returns this rank's loss (DDP's convention: the models' losses
on a mesh, ``models.transformer.loss_fn(mesh=, rules=)``), and the step
takes the mean over ``dp`` of the losses and of the gradients — a leaf
split over ``dp`` (FSDP) gets its gradient already summed by the
gather's reduce-scatter.  A sequence-parallel axis (``sp_axis``) splits
the batch too (each rank its chunk of every row): the step takes the
mean over it as well, so every replicated leaf is reduced once over
each axis that splits the batch.  The JAX step returns new params and optimizer
state; the port's updates them in place, as
``models.transformer.make_train_step`` does.
"""

from __future__ import annotations

import math

import torch

from .mesh import P, _spec_axes, _tree_map, local_slice, spec_split


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


# ----------------------------------------------------------------------
# the training step on a mesh

def _spec_of(rules, path: str):
    """The spec at ``path`` (keys joined by ``/``) of a rule tree; None
    for a replicated leaf or a tree without rules."""
    node = rules
    for key in path.split("/"):
        if not isinstance(node, dict):
            return None
        node = node.get(key)
    return node if isinstance(node, P) else None


def _split_axes(spec, mesh) -> tuple:
    """The mesh axes of size > 1 a leaf's spec splits it over."""
    if spec is None:
        return ()
    return tuple(a for e in spec for a in _spec_axes(e) if mesh.size(a) > 1)


def _dp_dim(spec, dp_axis: str):
    """The dimension ``spec`` puts ``dp_axis`` on, or None."""
    for d, e in enumerate(spec or ()):
        if dp_axis in _spec_axes(e):
            return d
    return None


def _microbatches(batch, accum_steps: int, n_dp: int) -> list:
    """This rank's rows cut into ``accum_steps`` contiguous chunks:
    microbatch i is the i-th chunk of every dp rank's shard
    (``tensor_parallel.py:91-107``)."""
    if accum_steps == 1:
        return [batch]
    leaves = []
    _tree_map(leaves.append, batch)
    B = torch.as_tensor(leaves[0]).shape[0]
    if B % accum_steps:
        raise ValueError(f"batch leading dim {B * n_dp} not divisible by "
                         f"dp({n_dp}) * accum_steps({accum_steps})")
    mb = B // accum_steps
    return [_tree_map(lambda x, i=i: torch.as_tensor(x)[i * mb:(i + 1) * mb],
                      batch) for i in range(accum_steps)]


def _grad_norm_sq(grads: list, axes: list, mesh):
    """fp32 Σ g² over the whole tree: each leaf's local sum psummed over
    exactly the axes its gradient is split on, so a replicated leaf
    counts once (``tensor_parallel.py:133-175``)."""
    by_axes: dict = {}
    for g, ax in zip(grads, axes):
        sq = torch.linalg.vector_norm(g, dtype=torch.float32).square()
        by_axes[ax] = by_axes[ax] + sq if ax in by_axes else sq
    total = None
    for ax, sq in by_axes.items():
        for a in ax:
            sq = mesh.psum(sq, a)
        total = sq if total is None else total + sq
    return total


def _train_step(loss_fn, params, batch, optimizer, mesh, rules, *,
                dp_axis: str, accum_steps: int, accum_rules, guard: bool,
                zero=None, sp_axis: str | None = None):
    """One step on this rank (module docstring); returns the loss, or
    (loss, {"v": [ok, loss, gnorm]}) with ``guard``.  ``zero``: ZeRO's
    sharded optimizer state (:class:`.zero._Zero`), which then takes
    the update in place of ``optimizer``."""
    from ..models.transformer import _trainable, named_param_leaves
    leaves = _trainable(optimizer)
    path_of = {id(t): path for path, t in named_param_leaves(params)}
    specs = [_spec_of(rules, path_of.get(id(p), "")) for p in leaves]
    n_dp = mesh.size(dp_axis)
    # Where each leaf's gradient ends up split over dp: its own dp axis
    # (FSDP: the gather's reduce-scatter summed it), ZeRO's slice, or
    # the fp32 accumulator's shard (ZeRO-2).
    fsdp = [_dp_dim(s, dp_axis) is not None and n_dp > 1 for s in specs]
    acc_dims = [None] * len(leaves)
    if accum_rules is not None and accum_steps > 1:
        acc_dims = [_dp_dim(_spec_of(accum_rules, path_of.get(id(p), "")),
                            dp_axis) for p in leaves]
    micro = _microbatches(batch, accum_steps, n_dp)
    acc, losses = None, []
    for mb in micro:
        for p in leaves:
            p.grad = None
        loss = loss_fn(params, mb)
        loss.backward()
        losses.append(loss.detach().float())
        if accum_steps == 1:
            acc = [p.grad for p in leaves]
            continue
        parts = [mesh.reduce_scatter(p.grad.float(), dp_axis, d)
                 if d is not None and not f else p.grad.float()
                 for p, d, f in zip(leaves, acc_dims, fsdp)]
        acc = parts if acc is None else [a + b for a, b in zip(acc, parts)]
    for p in leaves:
        p.grad = None
    n_sp = mesh.size(sp_axis)
    loss = mesh.psum(mesh.psum(torch.stack(losses), dp_axis),
                     sp_axis).mean() / (n_dp * n_sp)
    grads, split = [], []
    for p, g, spec, f, ad in zip(leaves, acc, specs, fsdp, acc_dims):
        zd = None if zero is None else zero.dims[id(p)]
        if f:                  # FSDP: the gather's reduce-scatter summed it
            pass
        elif ad is not None:   # the accumulator's dp slice, summed: ZeRO's
            if zero is None:
                g = mesh.all_gather(g, dp_axis, ad)
        elif zd is not None:
            g = mesh.reduce_scatter(g, dp_axis, zd)
        else:
            g = mesh.psum(g, dp_axis)
        g = mesh.psum(g, sp_axis)
        if n_dp * n_sp * accum_steps > 1:
            g = g / (n_dp * n_sp * accum_steps)
        grads.append(g if zero is not None else g.to(p.dtype))
        axes = _split_axes(spec, mesh)
        if zd is not None and n_dp > 1:
            axes = axes + (dp_axis,)
        split.append(tuple(sorted(set(axes))))
    ok, v = True, None
    if guard:
        gn_sq = _grad_norm_sq(grads, split, mesh)
        ok_t = torch.isfinite(gn_sq) & torch.isfinite(loss)
        v = torch.stack([ok_t.float(), loss.float(), gn_sq.sqrt()])
        ok = bool(ok_t)
    if ok:
        if zero is not None:
            zero.update(leaves, grads)
        else:
            for p, g in zip(leaves, grads):
                p.grad = g
            optimizer.step()
            for p in leaves:
                p.grad = None
    return (loss, {"v": v}) if guard else loss


def make_tp_train_step(loss_fn, optimizer, mesh, param_rules, *,
                       dp_axis: str = "dp", accum_steps: int = 1,
                       accum_rules=None, guard: bool = False,
                       sp_axis: str | None = None):
    """The train step on a dp x tp mesh (``tensor_parallel.py:35``):
    ``step(params, batch) -> loss`` updates ``params`` in place.

    ``params`` is this rank's shard of a tree cut by ``param_rules``
    (None: whole on every rank, pure DDP), ``batch`` its rows over
    ``dp_axis`` (``mesh.shard_batch``), and ``loss_fn(params, batch)``
    this rank's loss (module docstring; e.g. ``lambda p, b:
    loss_fn(p, b, cfg, mesh=mesh, rules=rules)``).  ``optimizer`` holds
    the leaves of ``params`` (``AdamW(param_leaves(params), lr)``); the
    returned loss is the whole batch's, equal on every rank.

    ``accum_steps > 1`` runs that many microbatches, microbatch i being
    the i-th contiguous chunk of this rank's rows (JAX's order, which
    MoE capacity makes matter), with an fp32 gradient accumulator;
    ``accum_rules`` (:func:`.zero.zero2_accum_rules`) keeps only this
    rank's ``dp`` slice of it, reduce-scattered every microbatch.

    ``guard=True``: the fp32 global gradient norm² (each leaf psummed
    only over the axes it is split on) and the loss must be finite, or
    the step leaves the params, the optimizer's moments and its step
    count untouched; the step returns ``(loss, {"v": [ok, loss,
    gnorm]})``.  The verdict is read on the host once per step.

    ``sp_axis``: the batch's rows are also split into sequence chunks
    over this axis (``models.transformer.SeqParallel``); ``loss_fn``
    returns this rank's share times the ranks splitting the batch
    (``loss_fn(sp=)``), and the step reduces losses and gradients over
    ``sp_axis`` as over ``dp_axis``."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def step(params, batch):
        return _train_step(loss_fn, params, batch, optimizer, mesh,
                           param_rules, dp_axis=dp_axis,
                           accum_steps=accum_steps, accum_rules=accum_rules,
                           guard=guard, sp_axis=sp_axis)

    return step
