"""Ulysses all-to-all sequence parallelism (counterpart of
``nbdistributed_tpu/parallel/ulysses.py``).

The second long-context strategy beside the ring (:mod:`.ring`): two
all-to-alls over the ``sp`` axis re-shard the activations from
sequence-split to head-split and back, so every rank runs ordinary
whole-sequence attention on its n-th of the heads (DeepSpeed-Ulysses).
Both head counts (H and Hkv, per ``tp`` shard) must divide by the axis
size; GQA keeps its group ratio, and K/V move at Hkv heads.

Local views, as :mod:`.ring` takes them (axis size n; K/V the same with
H -> Hkv)::

    (B, S/n, H, D) --all_to_all(split H, concat S)--> (B, S, H/n, D)
        ... whole-sequence attention over H/n query heads ...
    (B, S, H/n, D) --all_to_all(split S, concat H)--> (B, S/n, H, D)

The local attention is :func:`..ops.flash_attention` (K1 forward,
K2/K3 backward on CUDA tensors) or the plain reference.
"""

from __future__ import annotations

import math

from ..ops.attention import (attention_reference, check_window,
                             flash_attention)


def ulysses_attention(q, k, v, mesh, *, axis: str = "sp",
                      causal: bool = True, scale: float | None = None,
                      use_flash: bool = False,
                      batch_axis: str | None = None,
                      head_axis: str | None = None,
                      window: int | None = None, segment_ids=None):
    """Exact attention of this rank's sequence chunk, computed head-
    parallel after an all-to-all over ``mesh``'s ``axis``
    (``ulysses.py:57``).

    q: (B, C, H, D), k/v: (B, C, Hkv, D): this rank's chunk, and its
    rows and heads where ``batch_axis`` / ``head_axis`` split those (H
    and Hkv are then the per-shard counts, ``H/t`` and ``Hkv/t``);
    returns this rank's output chunk.  Both head counts must divide by
    the axis size.  ``segment_ids`` (B, C): packed documents, gathered
    to the whole sequence over ``axis``.  Differentiable in q, k, v."""
    n = mesh.size(axis)
    H, Hkv = q.shape[2], k.shape[2]
    for name, ax in (("batch_axis", batch_axis), ("head_axis", head_axis)):
        if ax is not None and ax not in mesh.shape:
            raise ValueError(f"{name} {ax!r} is not an axis of the mesh "
                             f"{mesh.shape}")
    if H % n or Hkv % n:
        raise ValueError(
            f"ulysses_attention needs both per-shard head counts "
            f"divisible by the {axis!r} axis: H/t={H}, Hkv/t={Hkv}, n={n}. "
            "Use ring_attention for head counts that don't split.")
    if H % Hkv:
        raise ValueError(f"n_heads {H} not divisible by n_kv_heads {Hkv}")
    if v.shape[2] != Hkv:
        raise ValueError(f"k/v head counts differ: {Hkv} vs {v.shape[2]}")
    check_window(window, causal)
    if segment_ids is not None:
        if tuple(segment_ids.shape) != tuple(q.shape[:2]):
            raise ValueError(
                f"segment_ids shape {tuple(segment_ids.shape)} != (B, S) "
                f"{tuple(q.shape[:2])}")
        if q.shape[1] != k.shape[1]:
            raise ValueError("segment_ids requires Sq == Sk")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])

    # sequence-split -> head-split: the whole sequence, H/n heads.
    qh, kh, vh = (mesh.all_to_all(t, axis, 2, 1) for t in (q, k, v))
    seg = (None if segment_ids is None else
           mesh.all_gather(segment_ids.contiguous(), axis, 1))
    if use_flash:
        out = flash_attention(qh, kh, vh, causal, scale, window, seg)
    else:
        out = attention_reference(qh, kh, vh, causal=causal, scale=scale,
                                  window=window, segment_ids=seg)
    return mesh.all_to_all(out.to(q.dtype), axis, 1, 2)
