"""Autoregressive generation with a KV cache (counterpart of
``nbdistributed_tpu/models/generate.py``; the dense and MoE families).

The cache is a dict of heads-major buffers ``(L, B, Hkv, T, Dh)``
(int8 plus ``(L, B, Hkv, T, 1)`` fp32 scales when quantized).  Where
the JAX package returns a new cache, the port writes the buffers in
place and returns the same dict: the pool is the largest tensor of a
server, and copying it per step would double its memory.

Cache writes reproduce ``jax.lax.dynamic_update_slice``'s clamp: the
start is clamped to ``[0, T - S]`` so the update fits, for a shared
scalar pointer and for per-row pointers alike.  Decode steps (S == 1)
with ``cfg.use_flash`` call the flash-decode kernel; prefill goes
through :func:`_cached_attention`, whose large products stay
``torch.einsum``.
"""

from __future__ import annotations

import math

import torch

from ..ops import flash_decode_attention
from ..ops._common import NEG_INF, resolve_device
from .moe import MoEConfig, _moe_mlp_block
from .quant import dequantize_weight, quantize_weight
from .transformer import (TransformerConfig, _as_tokens, _mlp_block,
                          _rms_norm, _rope, layer_params, qlinear)


# ----------------------------------------------------------------------
# cache

def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int, *,
                  quantized: bool = False, device=None) -> dict:
    """Zeroed (L, B, Hkv, max_len, Dh) K and V buffers on ``device``
    (None = the GPU); int8 with per-(token, kv-head) fp32 scales
    ``k_s``/``v_s`` (L, B, Hkv, max_len, 1) when ``quantized``."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    if quantized:
        sshape = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_s": torch.zeros(sshape, dtype=torch.float32, device=dev),
                "v_s": torch.zeros(sshape, dtype=torch.float32, device=dev)}
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def _quantize_kv(x):
    """(B, Hkv, S, D) -> (int8 same shape, scales (B, Hkv, S, 1) fp32)."""
    qw = quantize_weight(x, axis=-1)
    return qw["q8"], qw["s"]


def _dequantize_kv(q8, s):
    return dequantize_weight({"q8": q8, "s": s})


def _write_kv(buf, new, start) -> None:
    """Write ``new`` (B, Hkv, S, X) into ``buf`` (B, Hkv, T, X) at token
    offset ``start`` — an int, a 0-d tensor, or a (B,) tensor of per-row
    offsets — as ``dynamic_update_slice`` places it: a negative start
    counts once from the end, then the start is clamped to [0, T - S]."""
    T, S = buf.shape[2], new.shape[2]
    if S > T:
        raise ValueError(f"cannot write {S} tokens into a cache of {T}")
    if not torch.is_tensor(start) or start.ndim == 0:
        s0 = int(start)
        s0 = min(max(s0 + T if s0 < 0 else s0, 0), T - S)
        buf[:, :, s0:s0 + S] = new
        return
    first = start.to(torch.long)
    first = torch.clamp(torch.where(first < 0, first + T, first), 0, T - S)
    idx = first[:, None] + torch.arange(S, device=buf.device)   # (B, S)
    idx = idx[:, None, :, None].expand(-1, buf.shape[1], -1, buf.shape[3])
    buf.scatter_(2, idx, new)


def _cached_attention(q, kc, vc, positions, scale, window=None):
    """GQA attention of S new queries against the whole cache
    (``generate.py:131``).  q: (B, S, H, Dh); kc/vc: (B, Hkv, T, Dh);
    positions: (B, S).  Keys ``t <= position`` (and inside the window)
    attend.  Returns (B, S, H*Dh) in q's dtype."""
    B, S, H, Dh = q.shape
    Hkv, T = kc.shape[1], kc.shape[2]
    group = H // Hkv
    qg = (q.float() * scale).reshape(B, S, Hkv, group, Dh)
    s = torch.einsum("bskgd,bktd->bkgst", qg, kc.float())
    t_idx = torch.arange(T, device=q.device)
    mask = t_idx[None, None, :] <= positions[:, :, None]        # (B, S, T)
    if window is not None:
        mask = mask & (t_idx[None, None, :] > positions[:, :, None] - window)
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bskgd", p, vc.float())
    return o.reshape(B, S, H * Dh).to(q.dtype)


def _make_mlp_fn(cfg: TransformerConfig, token_mask=None):
    """The per-layer feed-forward branch (``generate.py:231``): the
    dense SwiGLU, or the MoE block for a :class:`.moe.MoEConfig`, with
    ``token_mask`` reaching its expert dispatch."""
    if isinstance(cfg, MoEConfig):
        return lambda x, layer: _moe_mlp_block(x, layer, cfg,
                                               token_mask=token_mask)[0]
    return lambda x, layer: _mlp_block(x, layer, cfg)


@torch.no_grad()
def forward_with_cache(params: dict, tokens, cache: dict, cache_len,
                       cfg: TransformerConfig, *, last_only: bool = False,
                       last_index=None, row_mask=None, token_mask=None):
    """Run ``tokens`` (B, S) through the model, writing K/V into
    ``cache`` at offset ``cache_len`` (an int or a per-row (B,)
    tensor) and attending everything up to each position.

    Returns (logits fp32, cache): (B, S, V), or (B, 1, V) with
    ``last_only`` or ``last_index`` (B,) (the last real token of
    right-padded rows, gathered before the final norm and lm_head).

    The feed-forward branch dispatches on the config: the dense SwiGLU,
    or the MoE layer for a :class:`.moe.MoEConfig`.  ``token_mask``
    (B, S) bool marks the real positions: pads must not enter expert
    dispatch, where they would take capacity slots and could evict
    real tokens.  ``row_mask`` (B,) masks whole rows (inactive server
    slots, finished speculative streams); passing both ANDs them.  The
    dense SwiGLU is per-token, so the masks reach only the MoE layer."""
    device = params["embed"].device
    tokens = _as_tokens(tokens, device)
    B, S = tokens.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if torch.is_tensor(cache_len) and cache_len.ndim == 1:
        offs = cache_len.to(device=device, dtype=torch.long)[:, None]
        start = offs[:, 0]
    else:
        offs = int(cache_len)
        start = offs
    positions = offs + torch.arange(S, device=device).expand(B, S)
    x = params["embed"][tokens].to(cfg.dtype)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if token_mask is not None:
        token_mask = torch.as_tensor(token_mask, dtype=torch.bool,
                                     device=device)
    if row_mask is not None:
        rows = row_mask.to(device)[:, None].expand(B, S)
        token_mask = rows if token_mask is None else token_mask & rows
    mlp = _make_mlp_fn(cfg, token_mask)
    quantized = "k_s" in cache
    window = cfg.sliding_window
    decode = S == 1 and cfg.use_flash
    if decode:   # the kernel's int32 positions, cast once for all layers
        pos32 = positions[:, 0].to(torch.int32).contiguous()
    for i in range(cfg.n_layers):
        layer = layer_params(params, i)
        kc, vc = cache["k"][i], cache["v"][i]
        ks = cache["k_s"][i] if quantized else None
        vs = cache["v_s"][i] if quantized else None
        h = _rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q = _rope(qlinear(h, layer["wq"]).reshape(B, S, H, Dh), positions,
                  cfg.rope_theta)
        k = _rope(qlinear(h, layer["wk"]).reshape(B, S, Hkv, Dh),
                  positions, cfg.rope_theta)
        v = qlinear(h, layer["wv"]).reshape(B, S, Hkv, Dh)
        kT, vT = k.transpose(1, 2), v.transpose(1, 2)   # heads-major
        if quantized:
            k8, k_sc = _quantize_kv(kT)
            v8, v_sc = _quantize_kv(vT)
            _write_kv(kc, k8, start)
            _write_kv(vc, v8, start)
            _write_kv(ks, k_sc, start)
            _write_kv(vs, v_sc, start)
        else:
            _write_kv(kc, kT.to(kc.dtype), start)
            _write_kv(vc, vT.to(vc.dtype), start)
        if decode:
            o = flash_decode_attention(
                q[:, 0].contiguous(), kc, vc, pos32,
                scale=scale, window=window, k_s=ks,
                v_s=vs).reshape(B, 1, H * Dh)
        else:
            if quantized:
                kc, vc = _dequantize_kv(kc, ks), _dequantize_kv(vc, vs)
            o = _cached_attention(q, kc, vc, positions, scale,
                                  window=window)
        x = x + qlinear(o, layer["wo"])
        x = mlp(x, layer)
    if last_index is not None:
        idx = torch.as_tensor(last_index, dtype=torch.long, device=device)
        x = x.gather(1, idx.reshape(B, 1, 1).expand(B, 1, x.shape[-1]))
    elif last_only:
        x = x[:, -1:]
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    return qlinear(x, params["lm_head"]).float(), cache


# ----------------------------------------------------------------------
# sampling + the decode loop

def truncate_logits(logits, top_k: int | None = None,
                    top_p: float | None = None):
    """Mask ``logits`` (..., V) outside the ``top_k`` largest and/or the
    ``top_p`` nucleus to -inf (``generate.py:393``)."""
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1) - probs
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True) - 1
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def _sample(logits, temperature: float, generator=None,
            top_k: int | None = None, top_p: float | None = None):
    """logits (B, V) -> (B,) long: greedy at ``temperature == 0``, else
    a categorical draw from ``generator`` over the truncated
    temperature-scaled distribution."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(truncate_logits(logits / temperature, top_k,
                                          top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _check_sampling(cfg, top_k, top_p) -> None:
    if top_k is not None and not 1 <= top_k <= cfg.vocab_size:
        raise ValueError(f"top_k must be in [1, vocab_size="
                         f"{cfg.vocab_size}], got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


@torch.no_grad()
def generate(params: dict, prompt, cfg: TransformerConfig,
             max_new_tokens: int, *, temperature: float = 0.0,
             top_k: int | None = None, top_p: float | None = None,
             generator: torch.Generator | None = None,
             max_len: int | None = None, kv_quantized: bool = False):
    """Generate ``max_new_tokens`` continuations of ``prompt`` (B, S0)
    on the parameters' device; returns (B, S0 + max_new_tokens) long.
    Greedy at ``temperature == 0``, else sampled from ``generator``."""
    device = params["embed"].device
    prompt = _as_tokens(prompt, device)
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0, got "
                         f"{max_new_tokens}")
    if max_new_tokens == 0:
        return prompt
    if prompt.shape[1] == 0:
        raise ValueError("cannot generate from an empty prompt (S == 0)")
    if temperature != 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) requires a "
                         "torch.Generator")
    _check_sampling(cfg, top_k, top_p)
    B, S0 = prompt.shape
    T = max_len if max_len is not None else S0 + max_new_tokens
    if T < S0 + max_new_tokens:
        raise ValueError(f"max_len {T} < prompt {S0} + new "
                         f"{max_new_tokens}")
    cache = init_kv_cache(cfg, B, T, quantized=kv_quantized,
                          device=device)
    logits, cache = forward_with_cache(params, prompt, cache, 0, cfg,
                                       last_only=True)
    toks = [_sample(logits[:, -1], temperature, generator, top_k, top_p)]
    for i in range(max_new_tokens - 1):
        logits, cache = forward_with_cache(params, toks[-1][:, None],
                                           cache, S0 + i, cfg)
        toks.append(_sample(logits[:, -1], temperature, generator, top_k,
                            top_p))
    return torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)


def make_generate_fn(cfg: TransformerConfig, max_new_tokens: int, *,
                     temperature: float = 0.0, top_k: int | None = None,
                     top_p: float | None = None,
                     max_len: int | None = None,
                     kv_quantized: bool = False):
    """A ``(params, prompt, generator=None) -> tokens`` closure over
    :func:`generate` (``generate.py:498``; the port has no jit, so it
    only binds the arguments)."""

    def fn(params, prompt, generator=None):
        return generate(params, prompt, cfg, max_new_tokens,
                        temperature=temperature, top_k=top_k, top_p=top_p,
                        generator=generator, max_len=max_len,
                        kv_quantized=kv_quantized)

    return fn


@torch.no_grad()
def prefill_chunked(params: dict, tokens, cache: dict,
                    cfg: TransformerConfig, *, chunk: int):
    """Prefill ``tokens`` (B, S), S divisible by ``chunk``, into
    ``cache`` one chunk at a time (``generate.py:516``): activation
    memory O(chunk) instead of O(S), and the cache fills as one
    whole-prompt prefill would (causal attention makes the two the same
    computation).  Returns (last_logits (B, 1, V), cache)."""
    tokens = _as_tokens(tokens, params["embed"].device)
    B, S = tokens.shape
    if S == 0:
        raise ValueError("cannot prefill an empty prompt (S == 0)")
    if S % chunk:
        raise ValueError(f"prompt length {S} not divisible by chunk "
                         f"{chunk}")
    for i in range(S // chunk):
        logits, cache = forward_with_cache(
            params, tokens[:, i * chunk:(i + 1) * chunk], cache, i * chunk,
            cfg, last_only=True)
    return logits, cache
