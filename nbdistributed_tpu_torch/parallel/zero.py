"""ZeRO-1 and ZeRO-2: the optimizer state, and the gradient
accumulator, sharded over the data-parallel axis (counterpart of
``nbdistributed_tpu/parallel/zero.py``; Xu et al., arXiv:2004.13336).

Each rank keeps the optimizer's moments only for its ``dp`` slice of
each leaf, on the first dimension its rules leave whole and ``dp``
divides (:func:`_add_dp`; a leaf with none keeps them whole).  A step
reduce-scatters each gradient over ``dp``, updates this rank's slice in
the optimizer's own arithmetic (the port's ``AdamW`` is elementwise, so
the numbers are replicated AdamW's) and all-gathers the new leaf.  The
step is :func:`.tensor_parallel.make_tp_train_step`'s, with the state
in :class:`_Zero`.
"""

from __future__ import annotations

import torch

from .mesh import P, local_slice
from .tensor_parallel import _dp_dim, _spec_of, _train_step


def _add_dp(spec: P, shape, dp_axis: str, dp_size: int) -> P:
    """``spec`` extended with ``dp_axis`` on the first dimension it
    leaves whole that ``dp_size`` divides; unchanged (replicated over
    dp) if none qualifies (``zero.py:30``)."""
    ext = tuple(spec) + (None,) * (len(shape) - len(spec))
    for i, (dim, s) in enumerate(zip(shape, ext)):
        if s is None and dim and dim % dp_size == 0:
            return P(*ext[:i], dp_axis, *ext[i + 1:])
    return P(*ext)


class _Zero:
    """ZeRO's optimizer state on this rank: each leaf's slice on its
    first free dimension that ``dp`` divides, as a tensor of its own,
    and the caller's optimizer class over those slices."""

    def __init__(self, optimizer, named: list, rules, mesh, dp_axis: str):
        n, idx = mesh.size(dp_axis), mesh.index(dp_axis)
        self.dims, self.slices = {}, {}
        for path, p in named:
            spec = _spec_of(rules, path)
            if _dp_dim(spec, dp_axis) is not None:
                raise ValueError(f"{path}: ZeRO shards the optimizer state "
                                 f"over {dp_axis!r}; its parameter rules "
                                 f"may not split over it too")
            d = _dp_dim(_add_dp(spec or P(), tuple(p.shape), dp_axis, n),
                        dp_axis)
            self.dims[id(p)] = d
            self.slices[id(p)] = (p.detach() if d is None else local_slice(
                p.detach(), d, n, idx)).clone()
        groups = [{**{k: v for k, v in g.items() if k != "params"},
                   "params": [self.slices[id(p)] for p in g["params"]]}
                  for g in optimizer.param_groups]
        self.optimizer = type(optimizer)(groups, **optimizer.defaults)
        self.mesh, self.dp_axis = mesh, dp_axis

    def moments(self, p) -> dict:
        """The optimizer's state of leaf ``p``'s slice."""
        return self.optimizer.state[self.slices[id(p)]]

    @torch.no_grad()
    def update(self, leaves: list, grads: list) -> None:
        """One optimizer step on the slices, then each leaf gathered back
        over ``dp`` from the ranks' updated slices."""
        for p, g in zip(leaves, grads):
            self.slices[id(p)].grad = g.to(p.dtype)
        self.optimizer.step()
        for p in leaves:
            d, sl = self.dims[id(p)], self.slices[id(p)]
            p.copy_(sl if d is None else
                    self.mesh.all_gather(sl, self.dp_axis, d))
            sl.grad = None


def _rules_or_whole(params, param_rules):
    """``param_rules``, or a tree of whole-leaf specs for ``None``."""
    if param_rules is not None:
        return param_rules
    return {k: (_rules_or_whole(v, None) if isinstance(v, dict)
                else P(*[None] * v.ndim)) for k, v in params.items()}


def zero2_accum_rules(params, param_rules, mesh, *, dp_axis: str = "dp"):
    """Each leaf's spec plus ``dp_axis`` on the first whole, divisible
    dimension (``zero.py:97``): the layout of ZeRO-2's fp32 gradient
    accumulator and of the optimizer's moments.  ``params`` may be the
    whole tree or this rank's shard: ``dp`` only lands on a dimension
    the rules leave whole."""
    rules = _rules_or_whole(params, param_rules)
    n = mesh.size(dp_axis)

    def walk(t, r):
        if isinstance(t, dict):
            return {k: walk(t[k], r[k]) for k in t}
        return _add_dp(r if r is not None else P(), tuple(t.shape),
                       dp_axis, n)

    return walk(params, rules)


def zero1_state_shardings(optimizer, params, param_rules, mesh, *,
                          dp_axis: str = "dp"):
    """The spec of each leaf's optimizer moments under ZeRO
    (``zero.py:41``; the step count is per leaf and whole).  The port's
    optimizer state is per leaf, so this is the tree of
    :func:`zero2_accum_rules`."""
    return zero2_accum_rules(params, param_rules, mesh, dp_axis=dp_axis)


def make_zero1_train_step(loss_fn, optimizer, mesh, param_rules, params, *,
                          dp_axis: str = "dp", guard: bool = False):
    """The dp x tp step with ZeRO-1 optimizer state (``zero.py:67``):
    ZeRO-2 without an accumulator.  Returns ``(step, init)``."""
    return make_zero2_train_step(loss_fn, optimizer, mesh, param_rules,
                                 params, accum_steps=1, dp_axis=dp_axis,
                                 guard=guard)


def make_zero2_train_step(loss_fn, optimizer, mesh, param_rules, params, *,
                          accum_steps: int, dp_axis: str = "dp",
                          guard: bool = False):
    """ZeRO-1's sharded optimizer state plus a ``dp``-sharded fp32
    gradient accumulator (``zero.py:110``); with ``accum_steps == 1``
    there is no accumulator and this is ZeRO-1.

    Returns ``(step, init)``.  ``init(params)`` builds this rank's
    optimizer state: a new optimizer of ``optimizer``'s class and
    hyperparameters over this rank's slice of each leaf of ``params``
    (this rank's shard of a tree cut by ``param_rules``), returned for
    inspection (its ``moments(leaf)``).  ``step(params, batch) -> loss``
    is :func:`.tensor_parallel.make_tp_train_step`'s on that state;
    ``optimizer`` itself is never stepped."""
    from ..models.transformer import named_param_leaves

    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    accum = (zero2_accum_rules(params, param_rules, mesh, dp_axis=dp_axis)
             if accum_steps > 1 else None)
    state = {}

    def init(params):
        state["zero"] = _Zero(optimizer, named_param_leaves(params),
                              param_rules, mesh, dp_axis)
        return state["zero"]

    def step(params, batch):
        if "zero" not in state:
            raise RuntimeError("call init(params) before the first step")
        return _train_step(loss_fn, params, batch, optimizer, mesh,
                           param_rules, dp_axis=dp_axis,
                           accum_steps=accum_steps, accum_rules=accum,
                           guard=guard, zero=state["zero"])

    return step, init
