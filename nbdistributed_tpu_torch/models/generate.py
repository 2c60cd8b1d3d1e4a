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

**On a mesh** (:mod:`..parallel.mesh`), every rank runs the same call
on its own shard, as SPMD over processes: batch rows over ``dp``, heads
and FFN columns over ``tp`` (Megatron: one ``psum`` after ``wo`` and one
after ``w_down``; the column-split embedding and the vocab-split
lm_head gathered over ``tp``), and the cache's token axis over ``sp``.
The ``tp`` split is the training forward's (:func:`_decode_layout`
builds its :class:`.transformer.MeshLayout`): heads that ``tp`` does
not divide are gathered and attended whole on every ``tp`` rank.
A decode step runs the flash-decode kernel on each rank's (B/dp,
Hkv/tp, T/sp) cache slice at positions shifted by the slice's offset,
and the ``sp`` ranks merge by their lse (:func:`_flash_decode_on_mesh`);
a prefill or a speculative verify attends each slice with
:func:`_cached_attention` and merges the same way.  A rank writes only
the cache positions of its slice.
"""

from __future__ import annotations

import math

import torch

from ..observability.spans import maybe_span
from ..ops import flash_decode_attention
from ..ops._common import NEG_INF, resolve_device
from ..parallel.mesh import P, local_slice, shard_batch, spec_split
from ..parallel.tensor_parallel import int4_row_shard
from .moe import MoEConfig, _moe_mlp_block
from .quant import dequantize_weight, quantize_weight
from .transformer import (MeshLayout, TransformerConfig, _as_tokens,
                          _attn_out, _embed, _head, _mlp_block, _qkv,
                          _rms_norm, _rope, is_quantized, is_quantized4,
                          layer_params, param_shardings, tp_heads_split)


# ----------------------------------------------------------------------
# cache

def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int, *,
                  mesh=None, rules: dict | None = None,
                  quantized: bool = False, device=None) -> dict:
    """Zeroed (L, B, Hkv, max_len, Dh) K and V buffers on ``device``
    (None = the GPU); int8 with per-(token, kv-head) fp32 scales
    ``k_s``/``v_s`` (L, B, Hkv, max_len, 1) when ``quantized``.

    With ``mesh``, ``batch`` and ``max_len`` are the whole cache's and
    this rank allocates its own shard at its local shape (never a view
    of a whole buffer: the decode kernel takes contiguous caches), laid
    out by ``rules`` (default: :func:`kv_cache_shardings` on the axes the
    mesh has, the KV heads whole where ``tp`` does not divide the head
    counts).  An extent the rules do not divide raises a ValueError
    naming the axis."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    sshape = shape[:-1] + (1,)
    shapes = {"k": shape, "v": shape}
    if quantized:
        shapes.update(k_s=sshape, v_s=sshape)
    if mesh is not None:
        if rules is None:
            rules = kv_cache_shardings(
                dp_axis="dp" if "dp" in mesh.shape else None,
                tp_axis=kv_tp_axis(cfg, mesh),
                sp_axis="sp" if "sp" in mesh.shape else None,
                quantized=quantized)
        missing = set(shapes) - set(rules)
        if missing:
            hint = (" — a quantized cache needs scale specs too (see "
                    "kv_cache_shardings(quantized=True))"
                    if missing & {"k_s", "v_s"} else "")
            raise ValueError(f"cache sharding rules missing specs for "
                             f"{sorted(missing)}{hint}")
        shapes = {name: _local_shape(shp, rules[name], mesh, "kv cache")
                  for name, shp in shapes.items()}
    dtype = torch.int8 if quantized else cfg.dtype
    return {name: torch.zeros(shp, device=dev,
                              dtype=torch.float32 if name.endswith("_s")
                              else dtype)
            for name, shp in shapes.items()}


_CACHE_DIMS = ("layer", "batch", "kv-head", "token", "head-dim")


def _local_shape(shape, spec, mesh, what: str) -> tuple:
    """``shape`` divided by the shard counts of ``spec``'s entries on
    ``mesh``; an indivisible extent raises naming its axis."""
    out = list(shape)
    for d, entry in enumerate(spec):
        n, _ = spec_split(mesh, entry)
        if out[d] % n:
            raise ValueError(f"{what}: {_CACHE_DIMS[d]} extent {out[d]} "
                             f"does not divide over the {entry} axis of "
                             f"size {n}")
        out[d] //= n
    return tuple(out)


def kv_cache_shardings(dp_axis: str | None = "dp",
                       tp_axis: str | None = "tp",
                       sp_axis: str | None = None,
                       quantized: bool = False) -> dict:
    """The cache's specs (``generate.py:92``): batch over ``dp_axis``, KV
    heads over ``tp_axis``, and the token axis over ``sp_axis``
    (sequence-parallel decode: each shard holds T/n tokens and the
    shards merge by log-sum-exp).  The int8 scales share the layout."""
    spec = P(None, dp_axis, tp_axis, sp_axis, None)
    rules = {"k": spec, "v": spec}
    if quantized:
        rules["k_s"] = spec
        rules["v_s"] = spec
    return rules


def _quantize_kv(x):
    """(B, Hkv, S, D) -> (int8 same shape, scales (B, Hkv, S, 1) fp32)."""
    qw = quantize_weight(x, axis=-1)
    return qw["q8"], qw["s"]


def _dequantize_kv(q8, s):
    return dequantize_weight({"q8": q8, "s": s})


def _write_kv(buf, new, start, offset: int = 0, total: int | None = None
              ) -> None:
    """Write ``new`` (B, Hkv, S, X) into ``buf`` (B, Hkv, T, X) at token
    offset ``start`` — an int, a 0-d tensor, or a (B,) tensor of per-row
    offsets — as ``dynamic_update_slice`` places it: a negative start
    counts once from the end, then the start is clamped to [0, T - S].

    On a sequence-parallel mesh ``buf`` is the slice of a ``total``-token
    cache that starts at token ``offset``: the clamp is the whole
    cache's, and only the positions inside the slice are written."""
    T_loc, S = buf.shape[2], new.shape[2]
    T = T_loc if total is None else total
    if S > T:
        raise ValueError(f"cannot write {S} tokens into a cache of {T}")
    if not torch.is_tensor(start) or start.ndim == 0:
        s0 = int(start)
        s0 = min(max(s0 + T if s0 < 0 else s0, 0), T - S)
        lo, hi = max(s0, offset), min(s0 + S, offset + T_loc)
        if lo < hi:
            buf[:, :, lo - offset:hi - offset] = new[:, :, lo - s0:hi - s0]
        return
    first = start.to(torch.long)
    first = torch.clamp(torch.where(first < 0, first + T, first), 0, T - S)
    loc = first[:, None] + torch.arange(S, device=buf.device) - offset
    expand = (-1, buf.shape[1], -1, buf.shape[3])
    if T_loc == T:
        buf.scatter_(2, loc[:, None, :, None].expand(*expand), new)
        return
    # A row's S consecutive positions are S distinct slots mod T_loc
    # (S <= T_loc): the positions outside the slice rewrite the value
    # their slot holds, so no two writes of a row meet.
    if S > T_loc:
        raise ValueError(f"a per-row write of {S} tokens spans more than "
                         f"one sequence-parallel slice of {T_loc}")
    keep = ((loc >= 0) & (loc < T_loc))[:, None, :, None]
    idx = torch.remainder(loc, T_loc)[:, None, :, None].expand(*expand)
    buf.scatter_(2, idx, torch.where(keep, new, buf.gather(2, idx)))


def _cached_attention(q, kc, vc, positions, scale, window=None,
                      return_lse: bool = False):
    """GQA attention of S new queries against the whole cache
    (``generate.py:131``).  q: (B, S, H, Dh); kc/vc: (B, Hkv, T, Dh);
    positions: (B, S).  Keys ``t <= position`` (and inside the window)
    attend.  Returns (B, S, H*Dh) in q's dtype; with ``return_lse``,
    (o (B, S, H, Dh) fp32, lse (B, S, H) fp32) — a query that attends no
    key gets o = 0 and lse = NEG_INF, as the decode kernel gives."""
    B, S, H, Dh = q.shape
    Hkv, T = kc.shape[1], kc.shape[2]
    group = H // Hkv
    with maybe_span("attn/cached"):
        qg = (q.float() * scale).reshape(B, S, Hkv, group, Dh)
        s = torch.einsum("bskgd,bktd->bkgst", qg, kc.float())
        t_idx = torch.arange(T, device=q.device)
        mask = t_idx[None, None, :] <= positions[:, :, None]    # (B, S, T)
        if window is not None:
            mask = mask & (t_idx[None, None, :]
                           > positions[:, :, None] - window)
        s = s.masked_fill(~mask[:, None, None], NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgst,bktd->bskgd", p, vc.float())
        if not return_lse:
            return o.reshape(B, S, H * Dh).to(q.dtype)
        seen = mask.any(dim=-1)                                 # (B, S)
        lse = torch.logsumexp(s, dim=-1).permute(0, 3, 1, 2).reshape(
            B, S, H)
        lse = torch.where(seen[..., None], lse, NEG_INF)
        o = torch.where(seen[..., None, None, None], o, 0.0)
        return o.reshape(B, S, H, Dh), lse


def _sp_combine(o, lse, mesh, dtype):
    """Merge the ``sp`` ranks' partial attentions by their lse: ``o =
    Σ exp(lse_i − m)·o_i / Σ exp(lse_i − m)``, ``m = max_i lse_i`` — one
    ``pmax`` and ONE ``psum`` of ``[o·w, w]`` in fp32 (``generate.py:
    199-214``).  A rank whose slice held no key (lse = NEG_INF) weighs 0."""
    lse = lse[..., None]
    m = mesh.pmax(lse, "sp")
    w = torch.exp(lse - m)
    both = mesh.psum(torch.cat([o.float() * w, w], dim=-1), "sp")
    num, den = both[..., :-1], both[..., -1:]
    return (num / torch.clamp(den, min=1e-30)).to(dtype)


def _flash_decode_on_mesh(q, kc, vc, pos, mesh, scale, window=None,
                          k_s=None, v_s=None):
    """The flash-decode kernel on this rank's shard (``generate.py:158``):
    q (B/dp, H/tp, Dh) against the (B/dp, Hkv/tp, T/sp, Dh) cache slice.
    The GQA grouping survives the head split: q-head block
    [t·H/tp, (t+1)·H/tp) maps onto kv-head block [t·Hkv/tp, ...).
    Under ``sp`` the kernel runs at ``pos − i·T/sp`` (negative, or past
    the slice, where the slice holds none or all of a row's keys; the
    window's bound is offset-invariant) with its lse, and the slices
    merge by :func:`_sp_combine`.  pos: (B/dp,) global positions."""
    if mesh.size("sp") == 1:
        return flash_decode_attention(q, kc, vc, pos, scale=scale,
                                      window=window, k_s=k_s, v_s=v_s)
    pos_loc = pos - mesh.index("sp") * kc.shape[2]
    o, lse = flash_decode_attention(q, kc, vc, pos_loc, scale=scale,
                                    window=window, k_s=k_s, v_s=v_s,
                                    return_lse=True)
    return _sp_combine(o, lse, mesh, q.dtype)


def _dp_rows(x, mesh):
    """This rank's rows of a batch every rank holds whole."""
    return shard_batch(x, mesh) if "dp" in mesh.shape else x


def kv_tp_axis(cfg, mesh) -> str | None:
    """``"tp"`` where a cache's KV heads split over it: a mesh whose
    ``tp`` divides both head counts, so each rank holds whole GQA groups
    (``generate.py:221``); else None, and the heads stay whole."""
    split = tp_heads_split(cfg, mesh.size("tp"))
    return "tp" if "tp" in mesh.shape and split else None


def _decode_mesh(mesh, B: int, T: int | None = None):
    """The mesh a decode call runs on: ``mesh`` without ``dp`` where it
    does not divide the batch and without ``sp`` where it does not
    divide ``max_len`` — those dimensions are then held whole on the
    axis's ranks and computed replicated, as the JAX package's
    replicated einsum computes them (``generate.py:345-363``).  Heads
    that ``tp`` does not divide stay whole in the cache the same way
    (:func:`init_kv_cache`, :func:`forward_with_cache`)."""
    drop = [a for a, n in (("dp", B), ("sp", T))
            if n is not None and n % mesh.size(a)]
    return mesh.without(*drop) if drop else mesh


def _token_blocks(mesh, used) -> int:
    """How many blocks the dropless ``ep`` layer routes a call's tokens
    in: JAX splits the flattened tokens over ``dp`` wherever ``dp``
    divides them, so a call whose rows are whole on this rank
    (``used`` lacks ``dp``) routes them as ``dp`` blocks
    (``parallel.expert._dropless_ffn_ep`` keeps one block where they do
    not divide)."""
    if mesh is None or "dp" in used.shape:
        return 1
    return mesh.size("dp")


# The tensor-parallel split of each layer weight: output columns or
# contraction rows, and the full extent that tells a whole leaf from a
# shard (the layout read from the leaf's shape, as GSPMD reads it).
def _tp_extents(cfg):
    H, Hkv, Dh, F = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    return {"wq": ("cols", H * Dh), "wk": ("cols", Hkv * Dh),
            "wv": ("cols", Hkv * Dh), "w_gate": ("cols", F),
            "w_up": ("cols", F), "wo": ("rows", H * Dh),
            "w_down": ("rows", F)}


def _weight_dims(w) -> tuple[int, int]:
    """(d_in, d_out) of a plain, int8 or int4 weight."""
    if is_quantized(w):
        return w["q8"].shape[-2], w["q8"].shape[-1]
    if is_quantized4(w):
        return 2 * w["q4"].shape[-2], w["q4"].shape[-1]
    return w.shape[-2], w.shape[-1]


def _tp_shard(w, how: str, n: int, idx: int):
    """Shard ``idx`` of ``n`` of a whole weight: output columns (the
    scales with them) or contraction rows (an int8 leaf's per-column
    scales stay whole; an int4 leaf's groups are re-cut)."""
    if how == "cols":
        if isinstance(w, dict):
            return {k: local_slice(v, -1, n, idx) for k, v in w.items()}
        return local_slice(w, -1, n, idx)
    if is_quantized(w):
        return {"q8": local_slice(w["q8"], -2, n, idx), "s": w["s"]}
    if is_quantized4(w):
        return int4_row_shard(w, n, idx)
    return local_slice(w, -2, n, idx)


def _tp_local_layer(layer: dict, cfg, mesh) -> dict:
    """This rank's tp shard of a layer's weights: a leaf already split by
    :func:`.transformer.param_shardings` passes, a whole one is cut."""
    n, idx = mesh.size("tp"), mesh.index("tp")
    out = dict(layer)
    for name, (how, full) in _tp_extents(cfg).items():
        if name in layer:
            d_in, d_out = _weight_dims(layer[name])
            if (d_out if how == "cols" else d_in) == full:
                out[name] = _tp_shard(layer[name], how, n, idx)
    return out


def _decode_layout(params: dict, cfg, mesh, ep_axis: str):
    """The :class:`.transformer.MeshLayout` the cached forward runs on:
    Megatron's split of the layer products (a whole layer is cut per
    layer, :func:`_tp_local_layer`), and the embedding's and lm_head's
    ``tp`` split read from their shapes (whole, or cut by
    :func:`.transformer.param_shardings`)."""
    if mesh is None:
        return None
    rules = param_shardings(cfg)
    if params["embed"].shape[-1] == cfg.d_model:
        rules["embed"] = None
    if _weight_dims(params["lm_head"])[1] == cfg.vocab_size:
        rules["lm_head"] = None
    return MeshLayout(mesh, rules, ep_axis)


def _make_mlp_fn(cfg: TransformerConfig, token_mask=None, mesh=None,
                 ep_axis: str = "ep", token_blocks: int = 1, lay=None):
    """The per-layer feed-forward branch (``generate.py:231``): the
    dense SwiGLU (split over ``tp`` by ``lay``), or the MoE block for a
    :class:`.moe.MoEConfig`, with ``token_mask`` reaching its expert
    dispatch."""
    if isinstance(cfg, MoEConfig):
        return lambda x, layer: _moe_mlp_block(
            x, layer, cfg, mesh, ep_axis, token_mask=token_mask,
            token_blocks=token_blocks)[0]
    return lambda x, layer: _mlp_block(x, layer, cfg, lay=lay)


@torch.no_grad()
def forward_with_cache(params: dict, tokens, cache: dict, cache_len,
                       cfg: TransformerConfig, *, last_only: bool = False,
                       last_index=None, mesh=None, ep_axis: str = "ep",
                       row_mask=None, token_mask=None, token_blocks: int = 1):
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
    dense SwiGLU is per-token, so the masks reach only the MoE layer.

    ``mesh``: SPMD over the mesh's ranks (module docstring).  ``tokens``,
    ``cache_len``, the masks and the logits are this rank's rows over
    ``dp`` (``parallel.mesh.shard_batch``), the cache its
    :func:`init_kv_cache` shard; the parameters are split by
    :func:`.transformer.param_shardings` or whole (each rank then cuts
    its shard per layer).  Where ``tp`` does not divide the head counts
    the cache holds every head (:func:`init_kv_cache`): q, k and v are
    gathered over ``tp``, every head attended on every ``tp`` rank and
    this rank's columns of the output kept for ``wo``'s row split.
    MoE experts split over ``ep_axis``; the dropless ``ep`` layer routes
    the call's tokens as ``token_blocks`` blocks (:func:`_token_blocks`)."""
    device = params["embed"].device
    tokens = _as_tokens(tokens, device)
    B, S = tokens.shape
    Dh = cfg.head_dim
    if torch.is_tensor(cache_len) and cache_len.ndim == 1:
        offs = cache_len.to(device=device, dtype=torch.long)[:, None]
        start = offs[:, 0]
    else:
        offs = int(cache_len)
        start = offs
    positions = offs + torch.arange(S, device=device).expand(B, S)
    tp = mesh is not None and mesh.size("tp") > 1
    sp = mesh is not None and mesh.size("sp") > 1
    lay = _decode_layout(params, cfg, mesh, ep_axis)
    x = _embed(params, tokens, cfg, lay)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if token_mask is not None:
        token_mask = torch.as_tensor(token_mask, dtype=torch.bool,
                                     device=device)
    if row_mask is not None:
        rows = row_mask.to(device)[:, None].expand(B, S)
        token_mask = rows if token_mask is None else token_mask & rows
    mlp = _make_mlp_fn(cfg, token_mask, mesh, ep_axis, token_blocks, lay)
    quantized = "k_s" in cache
    window = cfg.sliding_window
    decode = S == 1 and cfg.use_flash
    if decode:   # the kernel's int32 positions, cast once for all layers
        pos32 = positions[:, 0].to(torch.int32).contiguous()
    # Under sp this rank's cache slice holds tokens [off, off + T_loc).
    T_loc = cache["k"].shape[3]
    off = mesh.index("sp") * T_loc if sp else 0
    T_all = T_loc * mesh.size("sp") if sp else None

    def write(buf, new):
        _write_kv(buf, new, start, off, T_all)

    for i in range(cfg.n_layers):
        layer = layer_params(params, i)
        if tp:
            layer = _tp_local_layer(layer, cfg, mesh)
        kc, vc = cache["k"][i], cache["v"][i]
        ks = cache["k_s"][i] if quantized else None
        vs = cache["v_s"][i] if quantized else None
        h = _rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q, k, v, local = _qkv(h, layer, cfg, lay)
        q = _rope(q.reshape(B, S, -1, Dh), positions, cfg.rope_theta)
        k = _rope(k.reshape(B, S, -1, Dh), positions, cfg.rope_theta)
        v = v.reshape(B, S, -1, Dh)
        kT, vT = k.transpose(1, 2), v.transpose(1, 2)   # heads-major
        if quantized:
            k8, k_sc = _quantize_kv(kT)
            v8, v_sc = _quantize_kv(vT)
            write(kc, k8)
            write(vc, v8)
            write(ks, k_sc)
            write(vs, v_sc)
        else:
            write(kc, kT.to(kc.dtype))
            write(vc, vT.to(vc.dtype))
        if decode and mesh is not None:
            o = _flash_decode_on_mesh(q[:, 0].contiguous(), kc, vc, pos32,
                                      mesh, scale, window, ks, vs)
        elif decode:
            o = flash_decode_attention(
                q[:, 0].contiguous(), kc, vc, pos32,
                scale=scale, window=window, k_s=ks, v_s=vs)
        else:
            if quantized:
                kc, vc = _dequantize_kv(kc, ks), _dequantize_kv(vc, vs)
            if sp:
                o = _sp_combine(*_cached_attention(
                    q, kc, vc, positions - off, scale, window=window,
                    return_lse=True), mesh, q.dtype)
            else:
                o = _cached_attention(q, kc, vc, positions, scale,
                                      window=window)
        x = mlp(_attn_out(x, o.reshape(B, S, -1), layer, lay, local), layer)
    if last_index is not None:
        idx = torch.as_tensor(last_index, dtype=torch.long, device=device)
        x = x.gather(1, idx.reshape(B, 1, 1).expand(B, 1, x.shape[-1]))
    elif last_only:
        x = x[:, -1:]
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _head(x, params, lay), cache


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
             max_len: int | None = None, mesh=None, ep_axis: str = "ep",
             kv_quantized: bool = False):
    """Generate ``max_new_tokens`` continuations of ``prompt`` (B, S0)
    on the parameters' device; returns (B, S0 + max_new_tokens) long.
    Greedy at ``temperature == 0``, else sampled from ``generator``.

    With ``mesh``, every rank passes the whole prompt and gets the whole
    result: each decodes its ``dp`` rows against its shard of the cache
    (:func:`init_kv_cache` on the mesh), and the rows are gathered over
    ``dp`` at the end.  A batch, head count or ``max_len`` that ``dp``,
    ``tp`` or ``sp`` does not divide is held whole on that axis's ranks
    (:func:`_decode_mesh`)."""
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
    fwd = {}
    if mesh is not None:
        dmesh = _decode_mesh(mesh, B, T)
        fwd = dict(mesh=dmesh, ep_axis=ep_axis,
                   token_blocks=_token_blocks(mesh, dmesh))
        prompt = _dp_rows(prompt, dmesh)
    cache = init_kv_cache(cfg, B, T, mesh=fwd.get("mesh"),
                          quantized=kv_quantized, device=device)
    logits, cache = forward_with_cache(params, prompt, cache, 0, cfg,
                                       last_only=True, **fwd)
    toks = [_sample(logits[:, -1], temperature, generator, top_k, top_p)]
    for i in range(max_new_tokens - 1):
        logits, cache = forward_with_cache(params, toks[-1][:, None],
                                           cache, S0 + i, cfg, **fwd)
        toks.append(_sample(logits[:, -1], temperature, generator, top_k,
                            top_p))
    out = torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)
    return out if mesh is None else fwd["mesh"].all_gather(out, "dp")


def make_generate_fn(cfg: TransformerConfig, max_new_tokens: int, *,
                     temperature: float = 0.0, top_k: int | None = None,
                     top_p: float | None = None,
                     max_len: int | None = None, mesh=None,
                     ep_axis: str = "ep", kv_quantized: bool = False):
    """A ``(params, prompt, generator=None) -> tokens`` closure over
    :func:`generate` (``generate.py:498``; the port has no jit, so it
    only binds the arguments)."""

    def fn(params, prompt, generator=None):
        return generate(params, prompt, cfg, max_new_tokens,
                        temperature=temperature, top_k=top_k, top_p=top_p,
                        generator=generator, max_len=max_len, mesh=mesh,
                        ep_axis=ep_axis, kv_quantized=kv_quantized)

    return fn


@torch.no_grad()
def prefill_chunked(params: dict, tokens, cache: dict,
                    cfg: TransformerConfig, *, chunk: int, mesh=None,
                    ep_axis: str = "ep"):
    """Prefill ``tokens`` (B, S), S divisible by ``chunk``, into
    ``cache`` one chunk at a time (``generate.py:516``): activation
    memory O(chunk) instead of O(S), and the cache fills as one
    whole-prompt prefill would (causal attention makes the two the same
    computation).  Returns (last_logits (B, 1, V), cache).  ``mesh``:
    as :func:`forward_with_cache` takes it (this rank's rows and shard)."""
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
            cfg, last_only=True, mesh=mesh, ep_axis=ep_axis)
    return logits, cache
