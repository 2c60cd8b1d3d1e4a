"""Collective matmul: ``all_gather -> matmul`` and ``matmul ->
reduce_scatter`` decomposed into rings of ``ppermute`` hops, for the
Megatron sequence-parallel tensor-parallel block (counterpart of
``nbdistributed_tpu/parallel/overlap.py``).

In the sequence-parallel tp layout activations enter a block split on
the sequence and are all-gathered before the column-split product; the
row-split product's output is reduce-scattered back.  As a ring, each
hop's transfer shares no data with the product of the chunk that
arrived before it, so the two can run at once (the "collective matmul"
of Wang et al., ASPLOS '23).  The products stay ``torch.matmul``, as
they are XLA dots in JAX; the hops are
:meth:`..parallel.mesh.Mesh.ppermute`, so every function here is
differentiable through them (the backward is a ring program of the same
shape).

Each function takes this rank's local operands and the mesh axis, as
the JAX functions do inside ``shard_map``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def allgather_matmul(x, w, mesh, axis_name: str):
    """``all_gather(x, axis) @ w``, ring-decomposed (``overlap.py:42``).

    ``x (m, K)``: this rank's rows of the row-split (sequence-split)
    left operand; ``w (K, n)``: this rank's columns of the weight.
    Returns ``(t*m, n)``: every row times the local columns."""
    t, me = mesh.size(axis_name), mesh.index(axis_name)
    parts = [None] * t
    buf = x
    for i in range(t):
        # buf arrived over i hops of the +1 ring: rank (me - i)'s rows.
        parts[(me - i) % t] = buf @ w
        if i < t - 1:
            buf = mesh.ppermute(buf, axis_name, 1)
    return torch.cat(parts, dim=0)


def matmul_reducescatter(x, w, mesh, axis_name: str):
    """``reduce_scatter(x @ w, axis)``, ring-decomposed
    (``overlap.py:73``).

    ``x (M, k)``: this rank's columns of the column-split left operand;
    ``w (k, N)``: the matching rows of the weight.  Returns ``(M/t,
    N)``: this rank's row chunk of the sum over ranks.  The accumulator
    for rank ``d`` starts on rank ``d+1``, visits every rank once and
    ends on ``d``."""
    t, me = mesh.size(axis_name), mesh.index(axis_name)
    M = x.shape[0]
    if M % t:
        raise ValueError(f"leading dim {M} not divisible by axis size {t}")
    m = M // t
    acc = None
    for i in range(t):
        j = (me - 1 - i) % t
        part = x[j * m:(j + 1) * m] @ w
        acc = part if acc is None else acc + part
        if i < t - 1:
            acc = mesh.ppermute(acc, axis_name, 1)
    return acc


def megatron_sp_block(x, w_up, w_down, mesh, axis_name: str,
                      act=lambda h: F.gelu(h, approximate="tanh")):
    """The sequence-parallel tp MLP with both collectives ring-
    overlapped: ``reduce_scatter(act(all_gather(x) @ w_up) @ w_down)``
    (``overlap.py:105``).  ``x (S/t, D)``, ``w_up (D, F/t)``, ``w_down
    (F/t, D)``; returns ``(S/t, D)``.  ``act`` defaults to JAX's
    ``jax.nn.gelu`` (the tanh form)."""
    h = act(allgather_matmul(x, w_up, mesh, axis_name))
    return matmul_reducescatter(h, w_down, mesh, axis_name)
