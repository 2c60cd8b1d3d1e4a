"""Continuous-batching decode server over a fixed slot pool
(counterpart of ``nbdistributed_tpu/models/serving.py:69``, dense-pool
mode).

The cache is one ``(L, max_batch, Hkv, max_len, Dh)`` pool; a request
holds a batch slot for its lifetime.  Admission prefills the prompt,
right-padded to a ``pad_to`` bucket, into the slot's cache rows and
samples the first token from the last real position (``last_index``).
Every :meth:`DecodeServer.step` runs ALL slots in one
``forward_with_cache`` call with per-row cache pointers; inactive
slots keep their pointer and token, so their idempotent writes land at
a frozen position and never touch a live row.  Greedy serving is
token-identical per request to a solo :func:`.generate.generate`.

Paged KV, speculative decoding, chunked / interleaved prefill, prefix
caching, meshes and MoE configs are later slices of the port
(ROADMAP queue A, "Serving beyond the dense pool"); their arguments
raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from .generate import _check_sampling, _sample, forward_with_cache, \
    init_kv_cache
from .transformer import TransformerConfig

_LATER = ("is a later slice of the port (ROADMAP queue A, 'Serving "
          "beyond the dense pool')")


class DecodeServer:
    """Slot-pool continuous-batching server around one model::

        srv = DecodeServer(params, cfg, max_batch=8, max_len=512)
        rid = srv.submit([1, 2, 3], max_new_tokens=16)
        srv.run_until_done()
        tokens = srv.outputs[rid]

    Runs on the parameters' device (:func:`.transformer.init_params`
    puts them on the GPU unless asked for the CPU).  Sampling at
    ``temperature > 0`` draws from a ``torch.Generator`` seeded with
    ``seed``."""

    def __init__(self, params, cfg: TransformerConfig, *,
                 max_batch: int, max_len: int,
                 temperature: float = 0.0, top_k: int | None = None,
                 top_p: float | None = None, eos_id: int | None = None,
                 kv_quantized: bool = False, pad_to: int = 64,
                 seed: int = 0, mesh=None, draft_params=None,
                 draft_cfg=None, prefill_chunk: int | None = None,
                 kv_block_tokens: int | None = None,
                 kv_blocks: int | None = None,
                 interleave_prefill: bool = False):
        later = {"mesh": mesh is not None,
                 "draft_params/draft_cfg": (draft_params is not None
                                            or draft_cfg is not None),
                 "prefill_chunk": prefill_chunk is not None,
                 "kv_block_tokens/kv_blocks": (kv_block_tokens is not None
                                               or kv_blocks is not None),
                 "interleave_prefill": bool(interleave_prefill)}
        for name, given in later.items():
            if given:
                raise NotImplementedError(f"{name} {_LATER}")
        if type(cfg) is not TransformerConfig:
            raise NotImplementedError(f"MoE configs {_LATER}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if pad_to < 1:
            raise ValueError(f"pad_to must be >= 1, got {pad_to}")
        _check_sampling(cfg, top_k, top_p)
        self._params = params
        self._cfg = cfg
        self._B = max_batch
        self._T = max_len
        self._pad_to = pad_to
        self._temperature = temperature
        self._top_k = top_k
        self._top_p = top_p
        self._eos = eos_id
        device = params["embed"].device
        self._device = device
        self._gen = torch.Generator(device=device)
        self._gen.manual_seed(seed)
        self._cache = init_kv_cache(cfg, max_batch, max_len,
                                    quantized=kv_quantized, device=device)
        self._lens = torch.zeros(max_batch, dtype=torch.long,
                                 device=device)
        self._last = torch.zeros(max_batch, dtype=torch.long, device=device)
        self._active = torch.zeros(max_batch, dtype=torch.bool,
                                   device=device)

        self._free = list(range(max_batch))
        self._slot_req: dict[int, int] = {}      # slot -> request id
        self._budget: dict[int, int] = {}        # request id -> remaining
        self._pending: list[tuple[int, list[int], int]] = []
        self._next_id = 0
        self.outputs: dict[int, list[int]] = {}
        self.prompts: dict[int, list[int]] = {}
        self._finished: set[int] = set()
        self.prefill_tokens_total = 0
        self.decode_tokens_total = 0

    # ---- device work -----------------------------------------------------

    def _bucket(self, n: int) -> int:
        return -(-n // self._pad_to) * self._pad_to

    def _run_prefill(self, prompt: list[int], slot: int):
        """Prefill one slot's cache rows (in place, through a view of the
        pool) with the right-padded prompt; returns the logits (V,) at
        the last real token.  The pad is clamped so the padded write
        never reaches past max_len."""
        L = len(prompt)
        s_pad = min(self._bucket(L), self._T)
        padded = torch.tensor([prompt + [0] * (s_pad - L)], dtype=torch.long,
                              device=self._device)
        row = {name: buf[:, slot:slot + 1]
               for name, buf in self._cache.items()}
        logits, _ = forward_with_cache(self._params, padded, row, 0,
                                       self._cfg, last_index=[L - 1])
        return logits[0, 0]

    def _decode_step(self):
        """One decode step of every slot; returns the (B,) next tokens
        on the device (inactive slots repeat their last token)."""
        logits, _ = forward_with_cache(self._params, self._last[:, None],
                                       self._cache, self._lens, self._cfg,
                                       row_mask=self._active)
        nxt = _sample(logits[:, -1], self._temperature, self._gen,
                      self._top_k, self._top_p)
        nxt = torch.where(self._active, nxt, self._last)
        self._lens += self._active.long()
        self._last = nxt
        return nxt

    # ---- host-side API ---------------------------------------------------

    def submit(self, prompt, max_new_tokens: int) -> int:
        """Queue a request; returns its id.  Admitted on this call if a
        slot is free, else at the next :meth:`step`."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        if len(prompt) + max_new_tokens > self._T:
            raise ValueError(f"prompt ({len(prompt)}) + max_new_tokens "
                             f"({max_new_tokens}) exceeds max_len "
                             f"{self._T}")
        rid = self._next_id
        self._next_id += 1
        self.prompts[rid] = prompt
        self.outputs[rid] = []
        self._pending.append((rid, prompt, max_new_tokens))
        self._admit_pending()
        return rid

    def cache_prefix(self, tokens) -> int:
        raise NotImplementedError(f"cache_prefix {_LATER}")

    def _admit_pending(self) -> None:
        while self._pending and self._free:
            rid, prompt, budget = self._pending.pop(0)
            self._admit_now(self._free.pop(0), rid, prompt, budget)

    def _admit_now(self, slot: int, rid: int, prompt: list[int],
                   budget: int) -> None:
        last_logits = self._run_prefill(prompt, slot)
        tok = int(_sample(last_logits[None], self._temperature, self._gen,
                          self._top_k, self._top_p)[0])
        self.outputs[rid].append(tok)
        self.prefill_tokens_total += len(prompt)
        self._lens[slot] = len(prompt)
        self._last[slot] = tok
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

    def _emit(self, slot: int, rid: int, toks: list[int]) -> list[int]:
        """Budget-then-EOS truncation and bookkeeping of an emission."""
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

    def cancel(self, rid: int) -> bool:
        """Abort a pending or active request now, freeing its slot.
        False for unknown or finished ids."""
        for i, (r, _p, _b) in enumerate(self._pending):
            if r == rid:
                self._pending.pop(i)
                self._finished.add(rid)
                return True
        for slot, r in list(self._slot_req.items()):
            if r == rid:
                self._finish(slot, rid)
                return True
        return False

    def step(self) -> dict[int, list[int]]:
        """One decode step for every active slot; returns
        {request_id: [token]} for this step."""
        self._admit_pending()
        if not self._slot_req:
            return {}
        toks = self._decode_step().tolist()
        emitted = {rid: self._emit(slot, rid, [toks[slot]])
                   for slot, rid in list(self._slot_req.items())}
        self._admit_pending()
        return emitted

    def step_many(self, n: int) -> dict[int, list[int]]:
        """``n`` decode steps with one host sync at the end; budget and
        EOS apply afterwards, so a stream that ends mid-run computes to
        the end and its surplus is discarded.  Greedy tokens equal ``n``
        successive :meth:`step` calls; pending requests admit only
        before and after."""
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        self._admit_pending()
        if not self._slot_req:
            return {}
        toks = torch.stack([self._decode_step() for _ in range(n)])
        toks = toks.tolist()                     # (n, B), one sync
        emitted = {rid: self._emit(slot, rid, [row[slot] for row in toks])
                   for slot, rid in list(self._slot_req.items())}
        self._admit_pending()
        return emitted

    def release(self, rid: int) -> list[int]:
        """Drop a finished request's record and return its tokens."""
        if rid in self._budget or any(r == rid for r, _, _ in
                                      self._pending):
            raise ValueError(f"request {rid} is still in flight")
        if rid not in self.outputs:
            raise KeyError(f"unknown or already-released request {rid}")
        toks = self.outputs.pop(rid)
        self.prompts.pop(rid, None)
        self._finished.discard(rid)
        return toks

    def done(self) -> bool:
        return not self._slot_req and not self._pending

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
        """Mid-prefill streams; always empty on the dense pool, whose
        admission prefills a prompt in one call."""
        return {}
