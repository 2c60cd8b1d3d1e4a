"""Paged KV storage: fixed-size blocks under the dense decode path
(counterpart of ``nbdistributed_tpu/models/paged_kv.py``).

The pool is ``(L, n_blocks + 1, Hkv, block_tokens, D)``: one "batch
row" per block, made by the same :func:`~.generate.init_kv_cache`
(int8 values plus per-token scales when quantized; every helper here
maps over the cache dict, so paged and quantized compose).  Each slot
holds a table of physical block ids covering ``ceil((prompt + max_new)
/ block_tokens)`` blocks; the allocator is
:class:`~..serving_fast.paging.BlockAllocator`.

**Compute path.**  The attention is unchanged: each step *gathers* the
table-selected blocks into a dense ``(L, S, Hkv, MB * bt, D)`` cache
(one ``index_select`` per leaf, contiguous, so every layer's slice is
the contiguous cache the decode kernel takes), runs
:func:`~.generate.forward_with_cache` on it — which writes in place
into the gathered copy — and *scatters* back what changed: decode, the
one block per slot that holds the written position; prefill, the
slot's whole row.  The dense view is materialized per step: paging
buys capacity accounting and admission, not bytes per step.

**The trash block.**  Physical block ``n_blocks`` is never allocated.
Unallocated table entries point at it, and the decode scatter sends
*inactive* slots' blocks there, so a stale slot's frozen-position
write can never land in a block that was freed and handed to another
request.  Whatever sits in the trash block or in allocated but
unwritten blocks is finite (the pool starts zeroed and only ever
receives the model's own K/V), and attention masks it: positions past
a row's ``cache_len`` get probability exactly 0, and a slot's
``cache_len`` never passes its allocated tokens.
"""

from __future__ import annotations

import numpy as np
import torch

from ..serving_fast.paging import BlockAllocator, blocks_needed
from .generate import init_kv_cache, kv_cache_shardings, kv_tp_axis


def make_paged_pool(cfg, n_blocks: int, block_tokens: int, *, mesh=None,
                    quantized: bool = False, device=None) -> dict:
    """The physical block pool: ``init_kv_cache`` with the batch axis
    repurposed as blocks (+1 trash block).  With a mesh only the KV
    heads split (over ``tp``): block ids are gather indices into the
    whole block axis, so every rank holds every block of its heads."""
    rules = None
    if mesh is not None:
        rules = kv_cache_shardings(
            dp_axis=None, tp_axis=kv_tp_axis(cfg, mesh), sp_axis=None,
            quantized=quantized)
    return init_kv_cache(cfg, int(n_blocks) + 1, int(block_tokens),
                         mesh=mesh, rules=rules, quantized=quantized,
                         device=device)


def _flat(c):
    """A pool or dense leaf (L, rows, Hkv, T, X) as (L, rows*Hkv*T, X)."""
    return c.view(c.shape[0], -1, c.shape[-1])


def _dense_rows(table, hkv: int, bt: int):
    """For a (S, MB) table of physical ids: the (S*Hkv*MB*bt,) indices
    of the pool's flat rows that make up the dense (S, Hkv, MB*bt)
    view, in its order."""
    h = torch.arange(hkv, device=table.device)[None, :, None, None]
    t = torch.arange(bt, device=table.device)
    return ((table.long()[:, None, :, None] * hkv + h) * bt + t).reshape(-1)


def gather_dense(pool: dict, table) -> dict:
    """Table-select every slot's blocks into a dense cache: pool leaves
    ``(L, NB+1, Hkv, bt, X)``, table ``(S, MB)`` physical ids -> new
    contiguous leaves ``(L, S, Hkv, MB*bt, X)``."""
    out = {}
    for name, c in pool.items():
        L, _, hkv, bt, X = c.shape
        rows = _dense_rows(table, hkv, bt)
        out[name] = _flat(c).index_select(1, rows).view(
            L, table.shape[0], hkv, table.shape[1] * bt, X)
    return out


def gather_row(pool: dict, row_ids) -> dict:
    """One slot's blocks as a dense ``(L, 1, Hkv, MB*bt, X)`` row — the
    prefill working copy."""
    return gather_dense(pool, row_ids[None])


def scatter_row(pool: dict, row: dict, row_ids) -> dict:
    """Write a slot's whole dense row back to its physical blocks, in
    place.  Trash-mapped ids receive the row's pad positions (several
    copies land on the trash block; which one wins does not matter)."""
    for name, c in pool.items():
        rows = _dense_rows(row_ids[None], c.shape[2], c.shape[3])
        _flat(c).index_copy_(1, rows, _flat(row[name]))
    return pool


def scatter_step(pool: dict, dense: dict, table, pos, active, trash: int,
                 block_tokens: int) -> dict:
    """Write back, in place, the ONE block per slot that a decode step
    touched: the block holding ``pos`` (the position the step wrote,
    the pre-increment ``lens``).  Inactive slots go to the trash block.
    Everything stays on the device: no value is read on the host."""
    S, MB = table.shape
    blk = torch.clamp(pos.long() // block_tokens, 0, MB - 1)     # (S,)
    phys = table.long().gather(1, blk[:, None])[:, 0]
    phys = torch.where(active, phys, torch.full_like(phys, trash))
    for name, c in pool.items():
        hkv, bt = c.shape[2], c.shape[3]
        h = torch.arange(hkv, device=c.device)[None, :, None]
        t = torch.arange(bt, device=c.device)
        src = (((torch.arange(S, device=c.device)[:, None, None] * hkv + h)
                * MB + blk[:, None, None]) * bt + t).reshape(-1)
        dst = ((phys[:, None, None] * hkv + h) * bt + t).reshape(-1)
        _flat(c).index_copy_(1, dst, _flat(dense[name]).index_select(1, src))
    return pool


def apply_moves(pool: dict, moves: dict[int, int]) -> dict:
    """Apply a :meth:`BlockAllocator.defrag` move map to the pool in
    place, ``new[dst] = old[src]``, with one gather per leaf (the map is
    read at once, so chains of moves are safe)."""
    if not moves:
        return pool
    first = next(iter(pool.values()))
    src = np.arange(first.shape[1])
    for old, new in moves.items():
        src[new] = old
    src = torch.as_tensor(src, dtype=torch.long, device=first.device)
    for c in pool.values():
        c.copy_(c.index_select(1, src))
    return pool


class PagedKVCache:
    """Host-side paging state of one decode server: the block allocator
    (owner = slot id) and the per-slot block tables, with a cached
    device copy.  The physical pool lives in the server."""

    def __init__(self, *, slots: int, max_len: int, n_blocks: int,
                 block_tokens: int, device=None):
        self.slots = int(slots)
        self.block_tokens = int(block_tokens)
        self.n_blocks = int(n_blocks)
        self.trash = self.n_blocks
        self.max_blocks = blocks_needed(max_len, block_tokens)
        if self.max_blocks < 1:
            raise ValueError(f"max_len {max_len} yields an empty "
                             f"block table")
        self.device = device
        self.allocator = BlockAllocator(n_blocks, block_tokens)
        # -1 = unallocated (mapped to trash on the device copy).
        self._table = np.full((self.slots, self.max_blocks), -1, np.int32)
        self._dev = None                      # invalidated on change

    # -- allocation (owner = slot) ------------------------------------
    def alloc(self, slot: int, tokens: int) -> None:
        """Worst-case allocation for a request that may reach ``tokens``
        KV entries.  Raises
        :class:`~..serving_fast.paging.BlocksExhausted` untaken."""
        ids = self.allocator.alloc(str(slot),
                                   blocks_needed(tokens, self.block_tokens))
        self._table[slot, :] = -1
        self._table[slot, :len(ids)] = ids
        self._dev = None

    def free(self, slot: int) -> int:
        n = self.allocator.free(str(slot))
        self._table[slot, :] = -1
        self._dev = None
        return n

    def defrag(self) -> dict[int, int]:
        """Compact the allocator and refresh the host tables; the caller
        applies the returned moves to the pool with :func:`apply_moves`
        (host tables and device storage move together or not at all)."""
        moves = self.allocator.defrag()
        if moves:
            for slot in range(self.slots):
                ids = self.allocator._tables.get(str(slot))
                if ids is not None:
                    self._table[slot, :len(ids)] = ids
            self._dev = None
        return moves

    # -- device copy ---------------------------------------------------
    def device_table(self):
        """(S, MB) int32 physical-id table on the device, -1 entries
        mapped to the trash block.  Rebuilt only when the tables
        changed: a decode step reuses the cached tensor."""
        if self._dev is None:
            t = np.where(self._table < 0, self.trash, self._table)
            self._dev = torch.as_tensor(t, dtype=torch.int32,
                                        device=self.device)
        return self._dev

    def device_row(self, slot: int):
        """(MB,) int32 physical ids of one slot (prefill's view)."""
        return self.device_table()[slot]

    # -- accounting ----------------------------------------------------
    @property
    def used_blocks(self) -> int:
        return self.allocator.used_blocks

    @property
    def free_blocks(self) -> int:
        return self.allocator.free_blocks

    def largest_free_run(self) -> int:
        return self.allocator.largest_free_run()

    def snapshot(self) -> dict:
        return self.allocator.snapshot()
