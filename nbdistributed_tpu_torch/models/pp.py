"""Pipeline-parallel training for the transformer family (counterpart of
``nbdistributed_tpu/models/pp.py``).

The ``(L, ...)`` layer stack is re-chunked into ``n_stages`` contiguous
stage slices (:func:`pp_stage_params`), each rank of the ``pp`` axis
keeps its own (:func:`pp_apply_shardings`) and applies its L/n_stages
layers through the one layer recipe, ``make_layer_fn``; the embedding,
the final norm, the lm_head and the loss stay outside the pipelined
region, replicated on every rank.  :func:`make_pp_train_step` trains
through the GPipe schedule by autograd (``pipeline_forward``);
:func:`make_pp_1f1b_train_step` through the 1F1B schedule, whose
explicit backward also returns the tail's gradients and folds the
embedding's by a scatter-add as each microbatch leaves stage 0.  On
CUDA tensors every stage's layers run K1 forward and K2 + K3 backward.

The steps keep the port's idiom (``models.transformer.make_train_step``):
``step(params_pp, batch) -> loss`` updates ``params_pp`` in place
through an optimizer that holds its leaves
(``AdamW(param_leaves(params_pp), lr)``); every rank passes the whole
batch and gets the same loss.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import _tree_map
from ..parallel.pipeline import (make_pipeline_1f1b_full, pipeline_forward,
                                 shard_stage_params)
from .transformer import (TransformerConfig, _as_tokens, _optimizer_step,
                          _rms_norm, _trainable, _unbind_layers, make_layer_fn,
                          param_leaves, qlinear, shifted_xent)


def pp_stage_params(params: dict, n_stages: int) -> dict:
    """Re-chunk the ``(L, ...)`` layer stack into ``(n_stages,
    L/n_stages, ...)`` stage slices (``layers_pp``); everything else
    passes through.  Keep this rank's slice with
    :func:`pp_apply_shardings`."""
    leaves = []
    _tree_map(leaves.append, params["layers"])
    L = leaves[0].shape[0]
    if L % n_stages:
        raise ValueError(f"{L} layers not divisible into {n_stages} "
                         f"pipeline stages")
    out = dict(params)
    out["layers_pp"] = _tree_map(
        lambda a: a.reshape(n_stages, L // n_stages, *a.shape[1:]),
        out.pop("layers"))
    return out


def pp_unstage_params(params_pp: dict) -> dict:
    """Inverse of :func:`pp_stage_params`."""
    out = dict(params_pp)
    out["layers"] = _tree_map(
        lambda a: a.reshape(a.shape[0] * a.shape[1], *a.shape[2:]),
        out.pop("layers_pp"))
    return out


def pp_apply_shardings(params_pp: dict, mesh, *, pp_axis: str = "pp"):
    """This rank's tree for the pipelined steps: its ``(1, L/n_stages,
    ...)`` slice of ``layers_pp`` (``shard_stage_params``), the rest
    whole (replicated)."""
    out = dict(params_pp)
    out["layers_pp"] = shard_stage_params(params_pp["layers_pp"], mesh,
                                          axis=pp_axis)
    return out


def pp_gather_params(params_pp: dict, mesh, *, pp_axis: str = "pp") -> dict:
    """The whole ``(L, ...)`` tree from every rank's stage slice: the
    slices gathered over ``pp_axis`` and unstaged (every rank of the
    axis calls it)."""
    out = dict(params_pp)
    out["layers_pp"] = _tree_map(
        lambda a: mesh.all_gather(a.detach().contiguous(), pp_axis, 0),
        params_pp["layers_pp"])
    return pp_unstage_params(out)


def _stage_fn(cfg: TransformerConfig, positions):
    """One pipeline stage: this stage's layers in order, each through
    ``make_layer_fn`` (the one layer definition), the stage's stacked
    leaves cut once a call (``transformer.layer_slices``)."""
    one_layer = make_layer_fn(cfg, positions)

    def stage(stage_layers, x):
        for layer in _unbind_layers(stage_layers):
            x = one_layer(x, layer)
        return x

    return stage


def _reject_segments(batch) -> None:
    """Packed-document batches are not plumbed through the pipelined
    losses; reading only ``batch["tokens"]`` would let attention cross
    documents, so they raise (``pp.py:66``)."""
    if isinstance(batch, dict) and batch.get("segments") is not None:
        raise ValueError(
            'batch["segments"] (packed documents) is not supported by '
            "the pipelined losses yet — use the plain or dp/tp train "
            "steps for packed batches, or drop the segments")


def _n_micro(mesh, pp_axis, n_microbatches, B) -> int:
    n = n_microbatches if n_microbatches is not None else mesh.size(pp_axis)
    if B % n:
        raise ValueError(f"batch {B} not divisible by {n} microbatches")
    return n


def _head_loss(cfg, tail, y, tokens):
    y = _rms_norm(y, tail["final_norm"], cfg.norm_eps)
    return shifted_xent(qlinear(y, tail["lm_head"]).float(), tokens)


def pp_loss_fn(params_pp: dict, batch, cfg: TransformerConfig, mesh, *,
               pp_axis: str = "pp", n_microbatches: int | None = None):
    """Next-token cross-entropy with the layer stack pipelined over
    ``mesh``'s ``pp_axis`` (GPipe, ``pp.py:78``): the same tail as
    ``transformer.loss_fn``; batch rows are the microbatch unit, so
    ``n_microbatches`` (default: the number of stages) divides the batch.
    ``params_pp`` is this rank's tree (:func:`pp_apply_shardings`);
    ``batch`` the whole batch on every rank.  The loss is the same on
    every rank, and so is each replicated leaf's gradient."""
    _reject_segments(batch)
    tokens = _as_tokens(batch["tokens"], params_pp["embed"].device)
    B, S = tokens.shape
    n_micro = _n_micro(mesh, pp_axis, n_microbatches, B)
    x = params_pp["embed"][tokens].to(cfg.dtype)
    positions = torch.arange(S, device=tokens.device).expand(B // n_micro, S)
    y = pipeline_forward(_stage_fn(cfg, positions), params_pp["layers_pp"],
                         x, mesh, axis=pp_axis, n_microbatches=n_micro)
    return _head_loss(cfg, params_pp, y, tokens)


def make_pp_train_step(cfg: TransformerConfig, optimizer, mesh, *,
                       pp_axis: str = "pp",
                       n_microbatches: int | None = None):
    """``step(params_pp, batch) -> loss`` with the layer stack pipelined
    by GPipe (``pp.py:108``): :func:`pp_loss_fn`, its gradients by
    autograd through the schedule's reverse tick loop, and one
    ``optimizer`` step updating ``params_pp`` in place."""
    return _optimizer_step(optimizer, lambda params_pp, batch: pp_loss_fn(
        params_pp, batch, cfg, mesh, pp_axis=pp_axis,
        n_microbatches=n_microbatches))


def make_pp_1f1b_train_step(cfg: TransformerConfig, optimizer, mesh, *,
                            pp_axis: str = "pp",
                            n_microbatches: int | None = None,
                            batch_axis: str | None = None):
    """The 1F1B analog of :func:`make_pp_train_step` (``pp.py:128``):
    the same contract, O(stages) in-flight activations instead of O(M).
    The tail (final norm, lm_head, loss) trains through the schedule's
    tail gradients from the last stage, and the embedding through a
    scatter-add ``dx_sink`` on stage 0.  ``batch_axis``: dp x pp, each
    dp group pipelining its rows of every microbatch; the loss and the
    gradients are means over it."""
    leaves = _trainable(optimizer)

    def tail_fn(tail, y, bt_m):
        return _head_loss(cfg, tail, y, bt_m["tokens"])

    def dx_sink(acc, dx, bt_m):
        return acc.index_add_(0, bt_m["tokens"].reshape(-1),
                              dx.reshape(-1, dx.shape[-1]).to(acc.dtype))

    def step(params_pp, batch):
        _reject_segments(batch)
        embed = params_pp["embed"]
        tokens = _as_tokens(batch["tokens"], embed.device)
        B, S = tokens.shape
        n_micro = _n_micro(mesh, pp_axis, n_microbatches, B)
        # (1, S) broadcasts over any microbatch's row count (a dp rank
        # holds B/n_micro/dp of them).
        positions = torch.arange(S, device=tokens.device)[None]
        fn = make_pipeline_1f1b_full(
            _stage_fn(cfg, positions), tail_fn, mesh, axis=pp_axis,
            n_microbatches=n_micro, dx_sink=dx_sink,
            dx_init=lambda: embed.new_zeros(embed.shape),
            batch_axis=batch_axis)
        x = embed.detach()[tokens].to(cfg.dtype)
        tail = {"final_norm": params_pp["final_norm"],
                "lm_head": params_pp["lm_head"]}
        loss, g_layers, g_tail, g_embed = fn(
            tail, params_pp["layers_pp"], x, {"tokens": tokens})
        grads = {"embed": g_embed, "layers_pp": g_layers, **g_tail}
        by_id = {id(p): g for p, g in zip(param_leaves(params_pp),
                                          param_leaves(grads))}
        for p in leaves:
            p.grad = by_id[id(p)].to(p.dtype)
        optimizer.step()
        for p in leaves:
            p.grad = None
        return loss

    return step
