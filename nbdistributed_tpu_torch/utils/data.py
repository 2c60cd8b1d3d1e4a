"""Per-rank data sharding and packing for training (counterpart of
``nbdistributed_tpu/utils/data.py``, whose numpy functions are copied
here so the port imports nothing of the JAX package).

Everything but :func:`prefetch_to_device` is host-side numpy slicing:
deterministic rank-local views of a host-resident dataset with static
batch shapes.  :func:`prefetch_to_device` stages each batch in pinned
host memory and issues its copy to the device ``size`` batches ahead
with ``non_blocking=True``, so the transfer overlaps the current step.
"""

from __future__ import annotations

import collections
from typing import Any, Iterator, Sequence

import numpy as np
import torch

from ..ops._common import resolve_device


def rank_slice(n: int, rank: int, world_size: int) -> slice:
    """Contiguous near-equal split of ``n`` items: the first ``n %
    world_size`` ranks get one extra item; the slices tile [0, n)."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside world of {world_size}")
    base, extra = divmod(n, world_size)
    start = rank * base + min(rank, extra)
    return slice(start, start + base + (1 if rank < extra else 0))


def _check_aligned(arrays: dict[str, np.ndarray]) -> int:
    keys = list(arrays)
    n = len(arrays[keys[0]])
    for k in keys:
        if len(arrays[k]) != n:
            raise ValueError(
                f"leading-axis mismatch: {keys[0]}={n}, "
                f"{k}={len(arrays[k])}")
    return n


def shard_arrays(batch: dict[str, Any], rank: int,
                 world_size: int) -> dict[str, Any]:
    """Slice every leading axis of a dict-of-arrays by rank."""
    arrays = {k: np.asarray(v) for k, v in batch.items()}
    sl = rank_slice(_check_aligned(arrays), rank, world_size)
    return {k: v[sl] for k, v in arrays.items()}


def batch_iterator(data: dict[str, Any], *, batch_size: int, rank: int,
                   world_size: int, seed: int | None = 0,
                   drop_remainder: bool = True,
                   epochs: int | None = 1) -> Iterator[dict[str, Any]]:
    """Deterministic per-rank minibatch stream over a dict-of-arrays.

    Every rank builds it with the same ``seed``: the permutation is the
    same everywhere and rank r takes rows [r*bs, (r+1)*bs) of each
    global batch of ``world_size * batch_size``.  ``drop_remainder``
    keeps shapes static; without it the trailing global batch is split
    near-equally, and dropped when it has fewer rows than ranks, so
    every rank yields the same number of batches.  ``epochs=None``
    streams forever, reshuffling each epoch.  Validation happens at
    call time."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside world of {world_size}")
    keys = list(data)
    arrays = {k: np.asarray(v) for k, v in data.items()}
    n = _check_aligned(arrays)
    global_bs = batch_size * world_size
    if n < global_bs and (drop_remainder or n < world_size):
        raise ValueError(
            f"{n} examples < one global batch ({global_bs}); lower "
            f"batch_size or world size")

    def gen():
        epoch = 0
        while epochs is None or epoch < epochs:
            if seed is None:
                perm = np.arange(n)
            else:
                perm = np.random.default_rng(seed + epoch).permutation(n)
            for start in range(0, n - n % global_bs, global_bs):
                gidx = perm[start:start + global_bs]
                ridx = gidx[rank * batch_size:(rank + 1) * batch_size]
                yield {k: arrays[k][ridx] for k in keys}
            tail = n % global_bs
            if not drop_remainder and tail >= world_size:
                gidx = perm[n - tail:]
                ridx = gidx[rank_slice(tail, rank, world_size)]
                yield {k: arrays[k][ridx] for k in keys}
            epoch += 1

    return gen()


def prefetch_to_device(batches, *, size: int = 2,
                       device=None) -> Iterator[dict[str, torch.Tensor]]:
    """Yield each dict-of-arrays batch as tensors on ``device`` (None =
    the GPU), with the copies of the next ``size`` batches already
    issued.  For a CUDA device each array is staged in pinned host
    memory and copied with ``non_blocking=True`` on the current
    stream, so the transfer overlaps the step that is running; the
    caching host allocator keeps a pinned buffer alive until its copy
    has finished.  Yields in order; any iterator length works."""
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    dev = resolve_device(device)
    it = iter(batches)

    def put(batch):
        out = {}
        for key, arr in batch.items():
            t = torch.as_tensor(np.asarray(arr))
            if dev.type == "cuda":
                t = t.pin_memory()
            out[key] = t.to(dev, non_blocking=True)
        return out

    def gen():
        q: collections.deque = collections.deque()
        for b in it:
            q.append(put(b))
            if len(q) > size:
                yield q.popleft()
        while q:
            yield q.popleft()

    return gen()


def interleave_shards(shards: Sequence[dict[str, Any]]) -> dict[str, Any]:
    """Reassemble per-rank batches into the global batch (inverse of
    one step of :func:`batch_iterator`)."""
    keys = list(shards[0])
    return {k: np.concatenate([np.asarray(s[k]) for s in shards])
            for k in keys}


def pack_tokens(docs: Sequence[Sequence[int]], seq_len: int, *,
                eos_id: int | None = None,
                drop_remainder: bool = True,
                return_segments: bool = False):
    """Pack variable-length token documents into fixed (N, seq_len)
    windows: concatenate the docs (``eos_id``-separated if given) and
    chunk the stream.  A trailing partial window is dropped (default)
    or right-padded with ``eos_id``.

    ``return_segments=True`` also returns per-window document ids
    (N, seq_len) int32 (global doc index; an eos separator belongs to
    the document it ends, trailing padding to the last one) — feed them
    as ``batch["segments"]`` so attention stays inside each document,
    RoPE restarts per document and boundary targets drop from the
    loss."""
    if seq_len < 2:
        raise ValueError(f"seq_len must be >= 2, got {seq_len}")
    parts: list[np.ndarray] = []
    seg_parts: list[np.ndarray] = []
    for i, d in enumerate(docs):
        arr = np.asarray(d, np.int32).ravel()
        n = len(arr) + (1 if eos_id is not None else 0)
        parts.append(arr)
        if eos_id is not None:
            parts.append(np.asarray([eos_id], np.int32))
        seg_parts.append(np.full((n,), i, np.int32))
    stream = (np.concatenate(parts) if parts
              else np.zeros((0,), np.int32))
    segs = (np.concatenate(seg_parts) if seg_parts
            else np.zeros((0,), np.int32))
    n_full, tail = divmod(len(stream), seq_len)
    if tail and not drop_remainder:
        if eos_id is None:
            raise ValueError(
                "drop_remainder=False needs eos_id to pad the "
                "trailing window")
        pad = np.full((seq_len - tail,), eos_id, np.int32)
        stream = np.concatenate([stream, pad])
        segs = np.concatenate(
            [segs, np.full((seq_len - tail,), segs[-1], np.int32)])
        n_full += 1
    windows = stream[: n_full * seq_len].reshape(n_full, seq_len)
    if not return_segments:
        return windows
    return windows, segs[: n_full * seq_len].reshape(n_full, seq_len)
