"""Collective matmul: ``all_gather -> matmul`` and ``matmul ->
reduce_scatter`` decomposed into rings of ``ppermute`` hops, for the
Megatron sequence-parallel tensor-parallel block (counterpart of
``nbdistributed_tpu/parallel/overlap.py``).

In the sequence-parallel tp layout activations enter a block split on
the sequence and are all-gathered before the column-split product; the
row-split product's output is reduce-scattered back.  As a ring, each
hop's transfer shares no data with the product of the chunk that
arrived before it, so the two can run at once (the "collective matmul"
of Wang et al., ASPLOS '23): each hop is posted
(:meth:`..parallel.mesh.Mesh.ppermute_start`) before that product and
waited for after it.  The products stay ``torch.matmul``, as they are
XLA dots in JAX.  Both functions are ``torch.autograd.Function``s whose
backward is the other's ring on the transposed operands, as JAX's
autodiff derives it, so the backward overlaps its hops too.

Each function takes this rank's local operands and the mesh axis, as
the JAX functions do inside ``shard_map``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _ag_ring(x, mesh, axis: str, visit) -> None:
    """Visit every rank's ``x`` as it arrives on the +1 ring:
    ``visit(buf, src)`` for src = me, me-1, ...  Each hop is posted
    before the visit of the chunk it carries on, and waited for after."""
    t, me = mesh.size(axis), mesh.index(axis)
    buf = x
    for i in range(t):
        hop = mesh.ppermute_start(buf, axis, 1) if i < t - 1 else None
        visit(buf, (me - i) % t)
        if hop is not None:
            buf = hop.wait()


def _rs_ring(mesh, axis: str, chunk):
    """This rank's ``Σ_ranks chunk(me)`` on the +1 ring: the accumulator
    of row chunk ``d`` starts on rank ``d+1``, visits every rank once
    and ends on ``d``.  The sum carries from hop to hop, so it cannot
    be sent early; the next chunk's product is queued before the wait
    instead."""
    t, me = mesh.size(axis), mesh.index(axis)
    acc = chunk((me - 1) % t)
    for i in range(1, t):
        hop = mesh.ppermute_start(acc, axis, 1)
        part = chunk((me - 1 - i) % t)
        acc = hop.wait() + part
    return acc


def _rows(x, j: int, m: int):
    return x[j * m:(j + 1) * m]


class _AllgatherMatmul(torch.autograd.Function):
    """``all_gather(x) @ w`` on the ring; the backward is
    :class:`_MatmulReducescatter`'s ring on the transposed operands
    (``dx = matmul_reducescatter(g, wᵀ)``), with ``dw = all_gather(x)ᵀ
    @ g`` summed chunk by chunk inside it from the rows the forward
    gathered."""

    @staticmethod
    def forward(ctx, x, w, mesh, axis):
        t, m = mesh.size(axis), x.shape[0]
        parts, rows = [None] * t, [None] * t

        def visit(buf, src):
            rows[src] = buf
            parts[src] = buf @ w

        _ag_ring(x, mesh, axis, visit)
        ctx.save_for_backward(torch.cat(rows, dim=0), w)
        ctx.mesh, ctx.axis, ctx.m = mesh, axis, m
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, g):
        xs, w = ctx.saved_tensors
        mesh, axis, m = ctx.mesh, ctx.axis, ctx.m
        dw = [None]

        def chunk(j):
            gj = _rows(g, j, m)
            part = _rows(xs, j, m).T @ gj
            dw[0] = part if dw[0] is None else dw[0] + part
            return gj @ w.T

        dx = _rs_ring(mesh, axis, chunk)
        return dx, dw[0], None, None


class _MatmulReducescatter(torch.autograd.Function):
    """``reduce_scatter(x @ w)`` on the ring; the backward is
    :class:`_AllgatherMatmul`'s ring on the transposed operands
    (``dx = all_gather(g) @ wᵀ``), with ``dw = xᵀ @ all_gather(g)``
    summed as each rank's cotangent arrives."""

    @staticmethod
    def forward(ctx, x, w, mesh, axis):
        m = x.shape[0] // mesh.size(axis)
        ctx.save_for_backward(x, w)
        ctx.mesh, ctx.axis, ctx.m = mesh, axis, m
        return _rs_ring(mesh, axis, lambda j: _rows(x, j, m) @ w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        mesh, axis, m = ctx.mesh, ctx.axis, ctx.m
        dx = [None] * mesh.size(axis)
        dw = [None]

        def visit(buf, src):
            dx[src] = buf @ w.T
            part = _rows(x, src, m).T @ buf
            dw[0] = part if dw[0] is None else dw[0] + part

        _ag_ring(g.contiguous(), mesh, axis, visit)
        return torch.cat(dx, dim=0), dw[0], None, None


def allgather_matmul(x, w, mesh, axis_name: str):
    """``all_gather(x, axis) @ w``, ring-decomposed (``overlap.py:42``).

    ``x (m, K)``: this rank's rows of the row-split (sequence-split)
    left operand; ``w (K, n)``: this rank's columns of the weight.
    Returns ``(t*m, n)``: every row times the local columns.  Each hop
    is posted before the product of the rows it carries on."""
    return _AllgatherMatmul.apply(x, w, mesh, axis_name)


def matmul_reducescatter(x, w, mesh, axis_name: str):
    """``reduce_scatter(x @ w, axis)``, ring-decomposed
    (``overlap.py:73``).

    ``x (M, k)``: this rank's columns of the column-split left operand;
    ``w (k, N)``: the matching rows of the weight.  Returns ``(M/t,
    N)``: this rank's row chunk of the sum over ranks (:func:`_rs_ring`:
    each hop overlaps the next chunk's product)."""
    t = mesh.size(axis_name)
    M = x.shape[0]
    if M % t:
        raise ValueError(f"leading dim {M} not divisible by axis size {t}")
    return _MatmulReducescatter.apply(x, w, mesh, axis_name)


def megatron_sp_block(x, w_up, w_down, mesh, axis_name: str,
                      act=lambda h: F.gelu(h, approximate="tanh")):
    """The sequence-parallel tp MLP with both collectives ring-
    overlapped: ``reduce_scatter(act(all_gather(x) @ w_up) @ w_down)``
    (``overlap.py:105``).  ``x (S/t, D)``, ``w_up (D, F/t)``, ``w_down
    (F/t, D)``; returns ``(S/t, D)``.  ``act`` defaults to JAX's
    ``jax.nn.gelu`` (the tanh form)."""
    h = act(allgather_matmul(x, w_up, mesh, axis_name))
    return matmul_reducescatter(h, w_down, mesh, axis_name)
