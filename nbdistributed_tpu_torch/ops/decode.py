"""Flash-decode: single-token attention against the heads-major KV
cache — the hand-written Hopper kernel (``csrc/flash_decode.cu``, the
cache's length split across blocks and the pieces merged by their lse)
and its plain PyTorch version (counterpart of
``nbdistributed_tpu/ops/decode.py``).

The plain version is ``_cached_attention`` (``models/generate.py:131``)
at S = 1, with the kernel's edges spelled out: the valid length is
``min(pos[b] + 1, T)``, the window's lower bound is taken on the
unclamped position, a row whose window lies past the valid keys
attends nothing (o = 0, lse = NEG_INF), and an int8 cache's per-token
scales commute through both products.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..observability.spans import maybe_span
from . import _build
from ._common import DTYPE_CODE, NEG_INF, check_contiguous, kernel_route
from .attention import _ptr, check_window

MAX_GROUP = 8  # query heads per kv head the kernel holds (csrc kMaxGroup)
CHUNK_KEYS = 128  # a split's chunk of T is a multiple of this (csrc kChunkKeys)
# Blocks the split aims for: four per SM of an H100 (132 SMs).
TARGET_BLOCKS = 4 * 132


def _decode_splits(bh: int, T: int) -> tuple[int, int]:
    """(nsplit, chunk): the kernel's grid is (``bh`` = B * Hkv, nsplit)
    and block i takes keys [i * chunk, (i + 1) * chunk) of the cache.
    Chosen from ``bh`` and T alone: ``pos`` lives on the card, and
    reading it here would stall the host-bound decode loop on a sync.
    chunk is a multiple of CHUNK_KEYS, and no chunk is empty:
    (nsplit - 1) * chunk < T <= nsplit * chunk."""
    tiles = -(-T // CHUNK_KEYS)
    want = max(1, min(tiles, -(-TARGET_BLOCKS // bh)))
    per = -(-tiles // want)
    return -(-tiles // per), per * CHUNK_KEYS


def decode_reference(q, kc, vc, pos, *, scale: float, window=None,
                     k_s=None, v_s=None):
    """(out (B, H, D) in q's dtype, lse (B, H) fp32) in plain PyTorch.
    q: (B, H, D); kc/vc: (B, Hkv, T, D); pos: (B,) int; k_s/v_s:
    (B, Hkv, T, 1) fp32 scales of an int8 cache, or None."""
    B, H, D = q.shape
    Hkv, T = kc.shape[1], kc.shape[2]
    group = H // Hkv
    qg = q.float().reshape(B, Hkv, group, D) * scale
    s = torch.einsum("bkgd,bktd->bkgt", qg, kc.float())
    if k_s is not None:
        s = s * k_s[..., 0][:, :, None, :]
    valid = pos.to(torch.int64) + 1
    t = torch.arange(T, device=q.device)
    keep = t[None, :] < torch.clamp(valid, max=T)[:, None]        # (B, T)
    if window is not None:
        keep = keep & (t[None, :] >= (valid - window)[:, None])
    keep = keep[:, None, None, :]
    s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * keep
    l = p.sum(dim=-1, keepdim=True)
    pv = p * v_s[..., 0][:, :, None, :] if v_s is not None else p
    o = torch.einsum("bkgt,bktd->bkgd", pv, vc.float())
    o = o / torch.clamp(l, min=1e-30)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full_like(l, NEG_INF))
    return o.reshape(B, H, D).to(q.dtype), lse.reshape(B, H)


# The C signature of nbd_flash_decode (csrc/flash_decode.cu): q, kc,
# vc, ks, vs, pos, out, lse, part; B, H, Hkv, T, D, q_dtype,
# cache_dtype, nsplit, chunk; scale; window; stream.
ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _decode_cuda(q, kc, vc, pos, *, scale, window, k_s, v_s, return_lse):
    B, H, D = q.shape
    Hkv, T = kc.shape[1], kc.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the decode kernel takes float32 or bfloat16 "
                        f"queries, got {q.dtype}")
    if k_s is None and kc.dtype != q.dtype:
        raise TypeError(f"cache dtype {kc.dtype} must match q's "
                        f"{q.dtype} (or be int8 with scales)")
    if k_s is not None and (kc.dtype != torch.int8
                            or k_s.dtype != torch.float32
                            or v_s.dtype != torch.float32):
        raise TypeError("scales need an int8 cache and float32 scales")
    if D not in (32, 64, 128):
        raise ValueError(f"the decode kernel takes head_dim 32, 64 or "
                         f"128, got {D}")
    if H // Hkv > MAX_GROUP:
        raise ValueError(f"the decode kernel holds at most {MAX_GROUP} "
                         f"query heads per kv head, got {H // Hkv}")
    pos = pos.to(torch.int32).contiguous()
    check_contiguous(q=q, kc=kc, vc=vc, k_s=k_s, v_s=v_s)
    out = torch.empty_like(q)
    lse = (torch.empty((B, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    # The partials of a split cache in one fp32 scratch: every chunk's
    # unnormalized o, then every chunk's (m, l); the kernel allocates
    # nothing.
    nsplit, chunk = _decode_splits(B * Hkv, T)
    part = (torch.empty(B * H * nsplit * (D + 2), dtype=torch.float32,
                        device=q.device) if nsplit > 1 else None)
    code = _build.bind("flash_decode", "nbd_flash_decode", ARGTYPES)(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), _ptr(k_s), _ptr(v_s),
        pos.data_ptr(), out.data_ptr(), _ptr(lse), _ptr(part),
        B, H, Hkv, T, D, DTYPE_CODE[q.dtype], DTYPE_CODE[kc.dtype],
        nsplit, chunk, float(scale), int(window or 0),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "nbd_flash_decode")
    flash_decode_attention.launches += 1
    return out, lse


def flash_decode_attention(q, kc, vc, pos, *, scale: float | None = None,
                           window: int | None = None, k_s=None, v_s=None,
                           return_lse: bool = False):
    """Fused decode attention (``ops/decode.py:244`` in the JAX package).

    q: (B, H, D) this step's queries; kc/vc: (B, Hkv, T, D) heads-major
    cache; pos: (B,) int — the position of the new token per row (slots
    ``t <= pos[b]`` attend); ``window`` keeps the last ``window``
    positions.  ``k_s``/``v_s`` (both or neither, (B, Hkv, T, 1) fp32)
    make the cache int8.  Returns (B, H, D), plus the (B, H) fp32 lse
    with ``return_lse``.  CUDA tensors launch the kernel, CPU tensors
    take :func:`decode_reference`; ``flash_decode_attention.launches``
    counts the kernel's launches (one per call: the C entry point
    launches the split kernel and, for a split cache, its combine)."""
    B, H, D = q.shape
    if kc.ndim != 4 or vc.shape != kc.shape or kc.shape[0] != B \
            or kc.shape[3] != D:
        raise ValueError(f"kc/vc must be (B, Hkv, T, {D}) matching q "
                         f"{tuple(q.shape)}; got {tuple(kc.shape)}, "
                         f"{tuple(vc.shape)}")
    Hkv, T = kc.shape[1], kc.shape[2]
    if H % Hkv:
        raise ValueError(f"n_heads {H} not divisible by n_kv_heads {Hkv}")
    if (k_s is None) != (v_s is None):
        raise ValueError("pass both k_s and v_s, or neither")
    if k_s is not None and (k_s.shape != (B, Hkv, T, 1)
                            or v_s.shape != (B, Hkv, T, 1)):
        raise ValueError(f"k_s/v_s must be ({B}, {Hkv}, {T}, 1)")
    if pos.shape != (B,):
        raise ValueError(f"pos must be ({B},), got {tuple(pos.shape)}")
    check_window(window, causal=True)
    if any(t.requires_grad for t in (q, kc, vc)):
        raise NotImplementedError("flash_decode_attention is inference-"
                                  "only")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    with maybe_span("attn/k4"):
        if kernel_route(q, kc, vc, pos, k_s, v_s) == "cpu":
            out, lse = decode_reference(q, kc, vc, pos, scale=scale,
                                        window=window, k_s=k_s, v_s=v_s)
        else:
            out, lse = _decode_cuda(q, kc, vc, pos, scale=scale,
                                    window=window, k_s=k_s, v_s=v_s,
                                    return_lse=return_lse)
    return (out, lse) if return_lse else out


flash_decode_attention.launches = 0
