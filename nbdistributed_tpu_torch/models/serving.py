"""Continuous-batching decode server over a fixed slot pool
(counterpart of ``nbdistributed_tpu/models/serving.py:69``).

The cache is one ``(L, max_batch, Hkv, max_len, Dh)`` pool; a request
holds a batch slot for its lifetime.  Admission prefills the prompt,
right-padded to a ``pad_to`` bucket, into the slot's cache rows and
samples the first token from the last real position (``last_index``).
Every :meth:`DecodeServer.step` runs ALL slots in one
``forward_with_cache`` call with per-row cache pointers; inactive
slots keep their pointer and token, so their writes land at a frozen
position and never touch a live row.  Greedy serving is
token-identical per request to a solo :func:`.generate.generate`.

Beyond the dense pool (each written in place, where the JAX package
returns new caches):

* **Paged KV** (``kv_block_tokens``/``kv_blocks``, :mod:`.paged_kv`):
  the pool holds fixed-size blocks, a request reserves
  ``ceil((prompt + max_new) / kv_block_tokens)`` of them at admission,
  and a request that does not fit waits, pending, for blocks to free.
  A step gathers the slots' blocks into a dense view, runs the same
  forward and scatters back the one block per slot it wrote.
* **Speculative decoding** (``draft_params``/``draft_cfg``/``gamma``,
  :mod:`.speculative`): each step is one draft-propose / target-verify
  round and emits 1..gamma+1 tokens per slot.
* **Prefix caching** (:meth:`DecodeServer.cache_prefix`): a shared
  prompt prefix is prefilled once; a matching request copies its K/V
  rows into the slot and prefills only the suffix.
* **Chunked prefill** (``prefill_chunk``): long prompts prefill in
  fixed-size segments; with ``interleave_prefill`` one segment per
  :meth:`DecodeServer.step`, between decode steps.

MoE configs (:mod:`.moe`) serve on every mode but chunked prefill
and prefix caching, as in the JAX package: expert capacity is
shape-derived, so admission runs at the exact prompt length
(``pad_to`` is forced to 1), pads and inactive rows are masked out of
expert dispatch, and a request served alone matches solo ``generate``;
live MoE requests pool expert capacity across rows.

**On a mesh** (``mesh=``, :mod:`..parallel.mesh`) the server runs SPMD:
every rank runs the same host scheduler on the same requests and keeps
the same host state and the same (B,) pointers, and holds its shard of
the pool — rows over ``dp``, KV heads over ``tp``, tokens over ``sp``
(:func:`.generate.init_kv_cache`).  Slot ``s`` lives on the ranks whose
``dp`` coordinate is ``s // (max_batch / dp)``: its prefill runs there
(their ``tp``/``sp``/``ep`` collectives stay among them) and its first
token reaches the other ``dp`` slices by one broadcast over ``dp``.
Each decode step runs every rank's own rows and all-gathers the
sampled tokens over ``dp``, so every host loop sees every row.  The
paged pool and the prefix buffers split over ``tp`` only (as in the
JAX package): their forwards run on every rank.  The target and the
draft of a speculative server share the mesh.
"""

from __future__ import annotations

import torch

from ..serving_fast.paging import BlocksExhausted
from .generate import (_check_sampling, _decode_mesh, _sample, _token_blocks,
                       forward_with_cache, init_kv_cache, kv_cache_shardings,
                       kv_tp_axis)
from .moe import MoEConfig
from .paged_kv import (PagedKVCache, gather_dense, gather_row,
                       make_paged_pool, scatter_row, scatter_step)
from .speculative import spec_round
from .transformer import TransformerConfig


def _real(prompt, length: int):
    """(1, s_pad) mask of a right-padded segment's real positions."""
    return torch.arange(prompt.shape[1], device=prompt.device)[None] < length


class DecodeServer:
    """Slot-pool continuous-batching server around one model::

        srv = DecodeServer(params, cfg, max_batch=8, max_len=512)
        rid = srv.submit([1, 2, 3], max_new_tokens=16)
        srv.run_until_done()
        tokens = srv.outputs[rid]

    Runs on the parameters' device (:func:`.transformer.init_params`
    puts them on the GPU unless asked for the CPU).  Sampling at
    ``temperature > 0`` draws from a ``torch.Generator`` seeded with
    ``seed``.  A step reads its tokens on the host once; the cache
    pointers never leave the device."""

    def __init__(self, params, cfg: TransformerConfig, *,
                 max_batch: int, max_len: int,
                 temperature: float = 0.0, top_k: int | None = None,
                 top_p: float | None = None, eos_id: int | None = None,
                 kv_quantized: bool = False, pad_to: int = 64,
                 seed: int = 0, mesh=None, ep_axis: str = "ep",
                 draft_params=None,
                 draft_cfg=None, gamma: int = 4,
                 prefill_chunk: int | None = None,
                 kv_block_tokens: int | None = None,
                 kv_blocks: int | None = None,
                 interleave_prefill: bool = False):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if pad_to < 1:
            raise ValueError(f"pad_to must be >= 1, got {pad_to}")
        _check_sampling(cfg, top_k, top_p)
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{prefill_chunk}")
        if (draft_params is None) != (draft_cfg is None):
            raise ValueError("pass both draft_params and draft_cfg, "
                             "or neither")
        if kv_block_tokens is not None and kv_block_tokens < 1:
            raise ValueError(f"kv_block_tokens must be >= 1, got "
                             f"{kv_block_tokens}")
        if kv_block_tokens is None and kv_blocks is not None:
            raise ValueError("kv_blocks needs kv_block_tokens (paged "
                             "mode is enabled by the block size)")
        if kv_block_tokens is not None and draft_cfg is not None:
            # A speculative round writes gamma+1 positions per step; the
            # paged scatter writes back exactly one block per slot.
            raise ValueError("paged KV serving does not compose with "
                             "speculative decoding yet")
        if interleave_prefill and prefill_chunk is None:
            raise ValueError("interleave_prefill needs prefill_chunk "
                             "(the per-step prefill work bound)")
        if draft_cfg is not None:
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError("target and draft must share a "
                                 "vocabulary")
            if gamma < 1:
                raise ValueError(f"gamma must be >= 1, got {gamma}")
        if isinstance(cfg, MoEConfig):
            # Expert capacity follows the prefill's token count: a padded
            # bucket (or a chunk) would give a capacity other than a solo
            # run's, and capacity decides which tokens drop.
            pad_to = 1
            if prefill_chunk is not None:
                raise ValueError(
                    "prefill_chunk is a dense-family option: MoE "
                    "expert capacity is shape-derived, so per-chunk "
                    "capacity would differ from a solo run's and "
                    "change which tokens drop")
        self._params = params
        self._cfg = cfg
        self._mesh = mesh
        self._ep_axis = ep_axis
        # The dense pool splits rows, heads and tokens, the paged pool
        # heads only; rows (tokens) that dp (sp) does not divide, and
        # heads that tp does not divide, are held whole on the axis's
        # ranks (generate._decode_mesh).
        self._drop = ()
        if mesh is not None:
            pool = (mesh.without("dp", "sp") if kv_block_tokens is not None
                    else _decode_mesh(mesh, max_batch, max_len))
            self._drop = tuple(a for a in ("dp", "sp")
                               if a in mesh.shape and a not in pool.shape)
        # A dp rank's slots: [dp_idx * B_loc, (dp_idx + 1) * B_loc).
        split = mesh is not None and "dp" not in self._drop
        self._B_loc = max_batch // mesh.size("dp") if split else max_batch
        self._dp_idx = mesh.index("dp") if split else 0
        self._kv_quantized = kv_quantized
        self._B = max_batch
        self._T = max_len
        self._pad_to = pad_to
        self._prefill_chunk = prefill_chunk
        self._temperature = temperature
        self._top_k = top_k
        self._top_p = top_p
        self._eos = eos_id
        device = params["embed"].device
        self._device = device
        self._gen = torch.Generator(device=device)
        self._gen.manual_seed(seed)

        if kv_block_tokens is not None:
            if kv_blocks is None:
                # The dense pool's capacity: paging with no explicit
                # budget never refuses a request the dense server takes.
                kv_blocks = max_batch * -(-max_len // kv_block_tokens)
            self._paged = PagedKVCache(slots=max_batch, max_len=max_len,
                                       n_blocks=kv_blocks,
                                       block_tokens=kv_block_tokens,
                                       device=device)
            self._cache = make_paged_pool(cfg, kv_blocks, kv_block_tokens,
                                          mesh=mesh, quantized=kv_quantized,
                                          device=device)
            self._prefill_fn = self._make_prefill_paged()
        else:
            self._paged = None
            self._cache = init_kv_cache(cfg, max_batch, max_len,
                                        mesh=self._pool_mesh(),
                                        quantized=kv_quantized,
                                        device=device)
            self._prefill_fn = self._make_prefill(cfg)
        self._lens = torch.zeros(max_batch, dtype=torch.long, device=device)
        self._last = torch.zeros(max_batch, dtype=torch.long, device=device)
        self._active = torch.zeros(max_batch, dtype=torch.bool,
                                   device=device)

        self._draft_params = draft_params
        self._draft_cfg = draft_cfg
        self._gamma = gamma
        if draft_cfg is not None:
            self._cache_d = init_kv_cache(draft_cfg, max_batch, max_len,
                                          mesh=self._pool_mesh(),
                                          quantized=kv_quantized,
                                          device=device)
            self._lens_d = torch.zeros(max_batch, dtype=torch.long,
                                       device=device)
            self._prefill_d = self._make_prefill(draft_cfg)

        # Prefix cache: pid -> (tokens, target rows, draft rows, logits).
        self._prefixes: dict[int, tuple] = {}
        self._next_pid = 0

        self._free = list(range(max_batch))
        self._slot_req: dict[int, int] = {}      # slot -> request id
        self._budget: dict[int, int] = {}        # request id -> remaining
        self._pending: list[tuple[int, list[int], int]] = []
        self._next_id = 0
        self.outputs: dict[int, list[int]] = {}
        self.prompts: dict[int, list[int]] = {}
        self._finished: set[int] = set()
        # Interleaved chunked prefill: slot -> [rid, prompt, budget,
        # written], oldest first; each step advances at most one chunk.
        self._interleave = bool(interleave_prefill)
        self._prefilling: dict[int, list] = {}
        self.prefill_tokens_total = 0
        self.decode_tokens_total = 0

    # ---- device work -----------------------------------------------------

    def _owner(self, slot: int) -> int:
        """The dp coordinate of the ranks that hold ``slot``'s rows."""
        return slot // self._B_loc

    def _pool_mesh(self):
        """The mesh the dense pool splits over: without the axes that do
        not divide it."""
        return None if self._mesh is None else self._mesh.without(*self._drop)

    def _fwd(self, *drop: str) -> dict:
        """forward_with_cache's mesh arguments: the mesh without the axes
        ``drop`` and those the pool is not split on (the call's rows or
        cache are whole on them), the tokens routed as JAX's dp blocks
        where its rows are whole (``generate._token_blocks``)."""
        if self._mesh is None:
            return {}
        used = self._mesh.without(*drop, *self._drop)
        return dict(mesh=used, ep_axis=self._ep_axis,
                    token_blocks=_token_blocks(self._mesh, used))

    def _make_prefill(self, cfg, whole: bool = False):
        """The prefill of one slot of the pool (``whole=False``) or of a
        one-row buffer held whole on every rank (a prefix buffer)."""
        fwd = self._fwd("dp", "sp") if whole else self._fwd("dp")
        b_loc, dp_idx = self._B_loc, self._dp_idx   # no cycle via self

        def fn(params, cache, prompt, slot, start, length):
            """prompt (1, s_pad), right-padded: writes the slot's cache
            rows (in place, through a view of the pool) at offset
            ``start`` and returns (cache, logits (V,) at the segment's
            last real token).  The pads stay out of expert dispatch.  On
            a mesh only the slot's dp ranks run it; the others return
            (cache, None)."""
            if not whole:
                if slot // b_loc != dp_idx:
                    return cache, None
                slot -= dp_idx * b_loc
            row = {name: buf[:, slot:slot + 1] for name, buf in cache.items()}
            logits, _ = forward_with_cache(params, prompt, row, start, cfg,
                                           last_index=[length - 1],
                                           token_mask=_real(prompt, length),
                                           **fwd)
            return cache, logits[0, 0]

        return fn

    def _make_prefill_paged(self):
        """Paged prefill, shaped like the dense one so
        :meth:`_run_prefill` drives both: gather the slot's blocks into a
        dense row, run the same forward, scatter the whole row back.  On
        a mesh every rank runs it on its heads' whole pool."""
        cfg, fwd, paged = self._cfg, self._fwd("dp", "sp"), self._paged

        def fn(params, pool, prompt, slot, start, length):
            ids = paged.device_row(slot)
            row = gather_row(pool, ids)
            logits, _ = forward_with_cache(params, prompt, row, start, cfg,
                                           last_index=[length - 1],
                                           token_mask=_real(prompt, length),
                                           **fwd)
            scatter_row(pool, row, ids)
            return pool, logits[0, 0]

        return fn

    def _rows(self):
        """This rank's slots of the (B,) pointers: its dp rows."""
        return slice(self._dp_idx * self._B_loc,
                     (self._dp_idx + 1) * self._B_loc)

    def _gather_rows(self, t):
        """This rank's rows of a per-slot result, gathered over ``dp``."""
        if self._mesh is None or self._paged is not None or \
                "dp" in self._drop:
            return t
        return self._mesh.all_gather(t, "dp")

    def _decode_step(self):
        """One decode step of every slot; returns the (B,) next tokens
        on the device (inactive slots repeat their last token).  Paged:
        the slots' blocks are gathered into a dense view and the block
        holding each slot's written position goes back (inactive slots
        to the trash block).  On a mesh each rank decodes its dp rows
        (paged: every row) and the tokens are gathered over ``dp``."""
        cache = self._cache
        if self._paged is not None:
            table = self._paged.device_table()
            cache = gather_dense(self._cache, table)
            rows, fwd = slice(None), self._fwd("dp", "sp")
        else:
            rows, fwd = self._rows(), self._fwd()
        logits, _ = forward_with_cache(self._params, self._last[rows, None],
                                       cache, self._lens[rows], self._cfg,
                                       row_mask=self._active[rows], **fwd)
        nxt = _sample(logits[:, -1], self._temperature, self._gen,
                      self._top_k, self._top_p)
        nxt = torch.where(self._active, self._gather_rows(nxt), self._last)
        if self._paged is not None:
            scatter_step(self._cache, cache, table, self._lens, self._active,
                         self._paged.trash, self._paged.block_tokens)
        self._lens = self._lens + self._active.long()
        self._last = nxt
        return nxt

    def _bucket(self, n: int) -> int:
        return -(-n // self._pad_to) * self._pad_to

    def _segment(self, toks: list[int], length: int):
        """``toks`` right-padded with zeros to ``length``, as (1, length)."""
        return torch.tensor([toks + [0] * (length - len(toks))],
                            dtype=torch.long, device=self._device)

    def _run_prefill(self, prefill_fn, params, cache, prompt: list,
                     slot: int, start: int = 0):
        """Prefill one slot; returns (cache, last-real-token logits).

        Default: one bucketed whole-prompt forward.  With
        ``prefill_chunk`` and a longer prompt: full chunks at increasing
        offsets, then the tail padded to the chunk (its logits are the
        result); a causal forward makes the two the same computation.
        ``start`` is the cache offset of the first token: 0, or the
        prefix length for a suffix after a :meth:`cache_prefix` hit.
        Every padded write is clamped to end at ``max_len``."""
        L = len(prompt)
        ck = self._prefill_chunk
        if ck is None or L <= ck:
            s_pad = min(self._bucket(L), self._T - start)
            return prefill_fn(params, cache, self._segment(prompt, s_pad),
                              slot, start, L)
        n_full = L // ck
        if L % ck == 0:
            n_full -= 1        # keep the last full chunk as the tail
        for i in range(n_full):
            cache, _ = prefill_fn(params, cache,
                                  self._segment(prompt[i * ck:(i + 1) * ck],
                                                ck),
                                  slot, start + i * ck, ck)
        tail = prompt[n_full * ck:]
        seg_len = min(ck, self._T - start - n_full * ck)
        return prefill_fn(params, cache, self._segment(tail, seg_len), slot,
                          start + n_full * ck, len(tail))

    # ---- host-side API ---------------------------------------------------

    def submit(self, prompt, max_new_tokens: int) -> int:
        """Queue a request; returns its id.  Admitted on this call if a
        slot (and, paged, enough blocks) is free, else at a later
        :meth:`step`."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        need = len(prompt) + max_new_tokens
        if self._draft_cfg is not None:
            # A final round can write up to gamma + 1 cache slots past
            # the budget before the slot finishes.
            need += self._gamma + 1
        if need > self._T:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens})"
                + (f" + speculative headroom ({self._gamma + 1})"
                   if self._draft_cfg is not None else "")
                + f" exceeds max_len {self._T}")
        rid = self._next_id
        self._next_id += 1
        self.prompts[rid] = prompt
        self.outputs[rid] = []
        self._pending.append((rid, prompt, max_new_tokens))
        self._admit_pending()
        return rid

    def cache_prefix(self, tokens) -> int:
        """Prefill a shared prompt prefix ONCE into a 1-slot buffer and
        return its id.  A later :meth:`submit` whose prompt starts with
        these tokens copies the buffer's rows into its slot and prefills
        only the suffix.  The copied rows are the ones a full prefill
        writes: causal attention makes a position's K/V depend only on
        the tokens up to it, and RoPE positions are absolute.  Dense
        family only: a suffix's prefill gives MoE experts another
        capacity than a solo run's."""
        if isinstance(self._cfg, MoEConfig):
            raise ValueError(
                "prefix caching is a dense-family option: MoE expert "
                "capacity is shape-derived, so suffix prefill would "
                "differ from a solo run and change which tokens drop")
        if self._paged is not None:
            raise ValueError(
                "prefix caching is not paged yet: the absorb copy "
                "assumes contiguous per-slot cache rows — register "
                "prefixes on a dense server")
        toks = [int(t) for t in tokens]
        if not toks:
            raise ValueError("empty prefix")
        if len(toks) >= self._T:
            raise ValueError(f"prefix ({len(toks)}) must leave room "
                             f"under max_len {self._T}")

        # On a mesh the buffer splits over tp only, like the paged pool:
        # a one-row buffer cannot split over dp, and its length need not
        # divide sp.  Every rank prefills it.
        def build(cfg, params):
            rules = None if self._mesh is None else kv_cache_shardings(
                dp_axis=None, tp_axis=kv_tp_axis(cfg, self._mesh),
                sp_axis=None, quantized=self._kv_quantized)
            # Room for the PADDED writes (bucket or whole chunks), so no
            # write is clamped onto earlier rows.
            ck = self._prefill_chunk
            t_buf = self._bucket(len(toks))
            if ck is not None and len(toks) > ck:
                t_buf = max(t_buf, -(-len(toks) // ck) * ck)
            buf = init_kv_cache(cfg, 1, min(t_buf, self._T), mesh=self._mesh,
                                rules=rules, quantized=self._kv_quantized,
                                device=self._device)
            prefill_fn = self._make_prefill(cfg, whole=True)
            buf, last_logits = self._run_prefill(prefill_fn, params, buf,
                                                 toks, 0)
            # Only the real rows: the copy into a slot must not carry
            # pad K/V past the suffix's writes.
            return ({name: c[:, :, :, :len(toks)].clone()
                     for name, c in buf.items()}, last_logits)

        buf_t, last_logits = build(self._cfg, self._params)
        buf_d = (build(self._draft_cfg, self._draft_params)[0]
                 if self._draft_cfg is not None else None)
        pid = self._next_pid
        self._next_pid += 1
        self._prefixes[pid] = (toks, buf_t, buf_d, last_logits)
        return pid

    def drop_prefix(self, pid: int) -> None:
        """Free a cached prefix (requests that already copied it keep
        their copy)."""
        if pid not in self._prefixes:
            raise KeyError(f"unknown prefix id {pid}")
        del self._prefixes[pid]

    def _match_prefix(self, prompt: list):
        """Longest registered prefix the prompt starts with, or None."""
        best = None
        for pid, (toks, *_rest) in self._prefixes.items():
            n = len(toks)
            if n <= len(prompt) and prompt[:n] == toks:
                if best is None or n > len(self._prefixes[best][0]):
                    best = pid
        return best

    def _absorb(self, cache: dict, pfx: dict, slot: int) -> None:
        """Copy a prefix's K/V rows into ``slot``'s first rows (on a
        mesh: on the slot's dp ranks, the positions of their sp slice)."""
        if self._owner(slot) != self._dp_idx:
            return
        slot -= self._dp_idx * self._B_loc
        for name, c in cache.items():
            T_loc = c.shape[3]
            off = self._pool_mesh().index("sp") * T_loc if self._mesh else 0
            lo, hi = max(off, 0), min(off + T_loc, pfx[name].shape[3])
            if lo < hi:
                c[:, slot:slot + 1, :, lo - off:hi - off] = \
                    pfx[name][:, :, :, lo:hi]

    def _admit_pending(self) -> None:
        while self._pending and self._free:
            rid, prompt, budget = self._pending[0]
            slot = self._free[0]
            if self._paged is not None:
                # Worst-case reservation at admission, so a stream never
                # stalls mid-decode on allocation; exhaustion leaves the
                # request pending until finishing streams free blocks.
                try:
                    self._paged.alloc(slot, len(prompt) + budget)
                except BlocksExhausted:
                    break
            self._pending.pop(0)
            self._free.pop(0)
            if self._interleave and len(prompt) > self._prefill_chunk:
                # Stream the prompt in one chunk per step; the slot is
                # reserved but inactive until the last chunk, and lens
                # tracks the written frontier, so the decode step's
                # frozen-position write for this row lands where the
                # next chunk writes (dense pool; the paged scatter sends
                # inactive rows to the trash block anyway).
                self._prefilling[slot] = [rid, prompt, budget, 0]
                self._set_frontier(slot, 0)
                continue
            self._admit_now(slot, rid, prompt, budget)

    def _admit_now(self, slot: int, rid: int, prompt: list[int],
                   budget: int) -> None:
        pid = self._match_prefix(prompt)
        if pid is not None:
            ptoks, buf_t, buf_d, plogits = self._prefixes[pid]
            n_pfx = len(ptoks)
            suffix = prompt[n_pfx:]
            self._absorb(self._cache, buf_t, slot)
            last_logits = plogits
            if suffix:
                self._cache, last_logits = self._run_prefill(
                    self._prefill_fn, self._params, self._cache, suffix,
                    slot, start=n_pfx)
            if self._draft_cfg is not None:
                self._absorb(self._cache_d, buf_d, slot)
                if suffix:
                    self._run_prefill(self._prefill_d, self._draft_params,
                                      self._cache_d, suffix, slot,
                                      start=n_pfx)
        else:
            self._cache, last_logits = self._run_prefill(
                self._prefill_fn, self._params, self._cache, prompt, slot)
            if self._draft_cfg is not None:
                # The draft prefills the same prompt; the target's logits
                # seed the stream.
                self._run_prefill(self._prefill_d, self._draft_params,
                                  self._cache_d, prompt, slot)
        self.prefill_tokens_total += len(prompt)
        self._activate(slot, rid, prompt, budget, last_logits)

    def _activate(self, slot: int, rid: int, prompt: list[int],
                  budget: int, last_logits) -> None:
        """Sample a prefilled request's first token and make its slot
        live (or finish it at once).  On a mesh whose pool splits over
        dp, the slot's dp ranks sample it and broadcast it over dp."""
        owner = self._owner(slot)
        if owner == self._dp_idx:
            t = _sample(last_logits[None], self._temperature, self._gen,
                        self._top_k, self._top_p)
        else:
            t = torch.zeros(1, dtype=torch.long, device=self._device)
        if (self._mesh is not None and self._paged is None
                and "dp" not in self._drop):
            t = self._mesh.broadcast(t, "dp", owner)
        tok = int(t[0])
        self.outputs[rid].append(tok)
        self._lens[slot] = len(prompt)
        self._last[slot] = tok
        if self._draft_cfg is not None:
            self._lens_d[slot] = len(prompt)
        if budget == 1 or (self._eos is not None and tok == self._eos):
            self._finish(slot, rid)
        else:
            self._slot_req[slot] = rid
            self._budget[rid] = budget - 1
            self._active[slot] = True

    def _finish(self, slot: int, rid: int) -> None:
        self._finished.add(rid)
        self._slot_req.pop(slot, None)
        self._budget.pop(rid, None)
        self._active[slot] = False
        self._free.append(slot)
        if self._paged is not None:
            self._paged.free(slot)

    def _advance_prefill(self) -> None:
        """Advance AT MOST ONE chunk of the oldest mid-prefill prompt,
        segmented as :meth:`_run_prefill` segments it (full chunks, then
        the tail padded to the chunk), so the stream equals a
        monolithic admission.  The last chunk samples the first token
        and activates the slot.  A speculative server prefills the
        draft's cache chunk by chunk beside the target's."""
        if not self._prefilling:
            return
        slot, st = next(iter(self._prefilling.items()))
        rid, prompt, budget, written = st
        ck = self._prefill_chunk
        last = len(prompt) - written <= ck
        seg = prompt[written:] if last else prompt[written:written + ck]
        seg_t = self._segment(seg, min(ck, self._T - written) if last
                              else ck)
        self._cache, logits = self._prefill_fn(
            self._params, self._cache, seg_t, slot, written, len(seg))
        if self._draft_cfg is not None:
            self._prefill_d(self._draft_params, self._cache_d, seg_t, slot,
                            written, len(seg))
        self.prefill_tokens_total += len(seg)
        if not last:
            st[3] = written + ck
            self._set_frontier(slot, st[3])
            return
        del self._prefilling[slot]
        self._activate(slot, rid, prompt, budget, logits)

    def _set_frontier(self, slot: int, written: int) -> None:
        """Point a mid-prefill slot's cache pointers (the draft's too) at
        its written frontier: the frozen-position writes a step makes
        for the inactive row land where the next chunk overwrites them."""
        self._lens[slot] = written
        if self._draft_cfg is not None:
            self._lens_d[slot] = written

    def cancel(self, rid: int) -> bool:
        """Abort an in-flight request now: drop it from the pending
        queue, the prefill stream or its slot, freeing the slot and
        (paged) its blocks.  False for unknown or finished ids."""
        for i, (r, _p, _b) in enumerate(self._pending):
            if r == rid:
                self._pending.pop(i)
                self._finished.add(rid)
                return True
        for slot, st in list(self._prefilling.items()):
            if st[0] == rid:
                del self._prefilling[slot]
                self._finish(slot, rid)
                return True
        for slot, r in list(self._slot_req.items()):
            if r == rid:
                self._finish(slot, rid)
                return True
        return False

    def step(self) -> dict[int, list[int]]:
        """One decode step for every active slot; returns
        {request_id: tokens emitted this step} — one token per step, or
        1..gamma+1 in speculative mode.  Admits pending requests first,
        then advances at most one mid-prefill chunk (interleave mode)."""
        self._admit_pending()
        self._advance_prefill()
        if not self._slot_req:
            return {}
        if self._draft_cfg is not None:
            return self._spec_step()
        toks = self._decode_step().tolist()
        emitted = {rid: self._emit(slot, rid, [toks[slot]])
                   for slot, rid in list(self._slot_req.items())}
        self._admit_pending()
        return emitted

    def _spec_round(self, active):
        """One speculative round of every slot (``active`` rows
        advance); returns (cand, n_acc) on the device.  On a mesh each
        rank runs its dp rows and one all-gather over dp returns every
        row's pointers, tokens and acceptance."""
        r = self._rows()
        out = spec_round(
            self._params, self._draft_params, self._cfg, self._draft_cfg,
            gamma=self._gamma, temperature=self._temperature,
            cache_t=self._cache, len_t=self._lens[r], cache_d=self._cache_d,
            len_d=self._lens_d[r], last_tok=self._last[r], active=active[r],
            generator=self._gen, top_k=self._top_k, top_p=self._top_p,
            **self._fwd())
        lens, lens_d, cand, n_acc, last = out
        if self._mesh is not None:
            packed = self._gather_rows(torch.cat(
                [torch.stack([lens, lens_d, n_acc.long(), last], dim=1),
                 cand], dim=1))
            lens, lens_d, n_acc, last = packed[:, :4].unbind(1)
            cand = packed[:, 4:]
        self._lens, self._lens_d, self._last = lens, lens_d, last
        return cand, n_acc

    def _spec_step(self) -> dict[int, list[int]]:
        """One speculative round; each slot emits its accepted prefix
        and the correction/bonus token.  Budget and EOS cut a stream by
        truncating its emission; the slot's stale device state dies with
        the slot (re-admission prefills from 0)."""
        cand, n_acc = self._spec_round(self._active)
        rows = torch.cat([cand, n_acc[:, None]], dim=1).tolist()  # one sync
        emitted = {rid: self._emit(slot, rid,
                                   rows[slot][:rows[slot][-1] + 1])
                   for slot, rid in list(self._slot_req.items())}
        self._admit_pending()
        return emitted

    def _emit(self, slot: int, rid: int, toks: list[int]) -> list[int]:
        """Budget-then-EOS truncation and bookkeeping of an emission,
        shared by the single step, the speculative round and the
        multi-step runs (which can overshoot on the device)."""
        toks = toks[: self._budget[rid]]
        if self._eos is not None and self._eos in toks:
            toks = toks[: toks.index(self._eos) + 1]
        self.outputs[rid].extend(toks)
        self.decode_tokens_total += len(toks)
        self._budget[rid] -= len(toks)
        if (self._budget[rid] == 0
                or (self._eos is not None and toks
                    and toks[-1] == self._eos)):
            self._finish(slot, rid)
        return toks

    def step_many(self, n: int) -> dict[int, list[int]]:
        """``n`` decode steps with one host sync at the end; budget and
        EOS apply afterwards, so a stream that ends mid-run computes to
        the end and its surplus is discarded.  Greedy tokens equal ``n``
        successive :meth:`step` calls; pending requests admit only
        before and after.  Dense plain serving only."""
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        if self._draft_cfg is not None:
            raise ValueError("step_many is for plain serving; use "
                             "spec_step_many on a speculative server")
        if self._paged is not None:
            raise ValueError("step_many is a dense-pool fast path; paged "
                             "serving steps one tick at a time (step())")
        self._admit_pending()
        if not self._slot_req:
            return {}
        toks = torch.stack([self._decode_step() for _ in range(n)])
        toks = toks.tolist()                     # (n, B), one sync
        emitted = {rid: self._emit(slot, rid, [row[slot] for row in toks])
                   for slot, rid in list(self._slot_req.items())}
        self._admit_pending()
        return emitted

    def spec_step_many(self, n: int) -> dict[int, list[int]]:
        """``n`` speculative rounds with one host sync at the end — up
        to ``n * (gamma + 1)`` tokens per slot.  As :meth:`step_many`:
        admission only before and after, budget and EOS applied
        afterwards.  A row stops advancing on the device once another
        round could write past ``max_len``; that happens only past its
        budget, so greedy emissions equal ``n`` successive
        :meth:`step` calls."""
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        if self._draft_cfg is None:
            raise ValueError("spec_step_many needs a speculative server "
                             "(draft_params/draft_cfg); use step_many "
                             "for plain serving")
        self._admit_pending()
        if not self._slot_req:
            return {}
        rounds = []
        for _ in range(n):
            act = self._active & (self._lens + self._gamma + 1 <= self._T)
            cand, n_acc = self._spec_round(act)
            rounds.append(torch.cat([cand, n_acc[:, None],
                                     act[:, None].long()], dim=1))
        rounds = torch.stack(rounds).tolist()    # (n, B, g+3), one sync
        emitted = {}
        for slot, rid in list(self._slot_req.items()):
            toks = []
            for r in rounds:
                row = r[slot]
                if row[-1]:
                    toks.extend(row[:row[-2] + 1])
            emitted[rid] = self._emit(slot, rid, toks)
        self._admit_pending()
        return emitted

    def release(self, rid: int) -> list[int]:
        """Drop a finished request's record and return its tokens."""
        if rid in self._budget \
                or any(r == rid for r, _, _ in self._pending) \
                or any(st[0] == rid for st in self._prefilling.values()):
            raise ValueError(f"request {rid} is still in flight")
        if rid not in self.outputs:
            raise KeyError(f"unknown or already-released request {rid}")
        toks = self.outputs.pop(rid)
        self.prompts.pop(rid, None)
        self._finished.discard(rid)
        return toks

    def done(self) -> bool:
        return (not self._slot_req and not self._pending
                and not self._prefilling)

    def run_until_done(self, max_steps: int | None = None):
        """Drive :meth:`step` until every request finishes; returns
        ``self.outputs``."""
        steps = 0
        while not self.done():
            self.step()
            steps += 1
            if max_steps is not None and steps > max_steps:
                raise RuntimeError(f"server not drained after "
                                   f"{max_steps} steps")
        return self.outputs

    @property
    def finished(self):
        return set(self._finished)

    @property
    def n_active(self) -> int:
        return len(self._slot_req)

    def prefill_progress(self) -> dict[int, tuple[int, int]]:
        """Mid-prefill streams: ``{request_id: (tokens_written,
        prompt_len)}``."""
        return {st[0]: (st[3], len(st[1]))
                for st in self._prefilling.values()}

    def kv_snapshot(self) -> dict | None:
        """Paged block occupancy (``{"blocks", "block_tokens", "used",
        "free", "largest_run", "owners"}``), None on a dense server."""
        return (self._paged.snapshot() if self._paged is not None
                else None)
