"""Flash-attention forward: the hand-written Hopper kernel
(``csrc/flash_attention.cu``) and its plain PyTorch version
(counterpart of ``nbdistributed_tpu/ops/attention.py``).

* :func:`attention_reference` — exact attention in plain PyTorch
  (``attention.py:48``), the oracle and the ``use_flash=False`` path.
* :func:`flash_attention` / :func:`_flash_forward` — the flash forward
  (``attention.py:784`` / ``:338``): causal or not, GQA (query head
  ``h`` reads kv head ``h // group``), ragged Sq/Sk, a sliding window,
  packed-document ``segment_ids``, ``(q_off, k_off)`` offsets, and the
  fp32 per-row lse.  CUDA tensors launch the kernel; CPU tensors take
  :func:`_flash_forward_plain`, which computes the same function.

Forward only: the backward kernels come with training, so the wrapper
refuses inputs that require grad.  Layout: q (B, Sq, H, D), k/v
(B, Sk, Hkv, D), as in the JAX package.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ._common import DTYPE_CODE, NEG_INF, check_contiguous, kernel_route


def check_window(window, causal: bool) -> None:
    """The one window-argument validator (``attention.py:37``)."""
    if window is None:
        return
    if not causal:
        raise ValueError("sliding window implies causal attention")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _keep_mask(Sq, Sk, *, causal, window, q_off, k_off, segment_ids,
               kv_segment_ids, device):
    """Broadcastable bool mask of the (query, key) pairs that attend:
    (1, 1, Sq, Sk) for the band, (B, 1, Sq, Sk) with segments; None
    when every pair attends."""
    keep = None
    if causal:
        qi = torch.arange(Sq, device=device)[:, None] + q_off
        ki = torch.arange(Sk, device=device)[None, :] + k_off
        keep = ki <= qi
        if window is not None:
            keep = keep & (ki > qi - window)
        keep = keep[None, None]
    if segment_ids is not None:
        seg = (segment_ids[:, :, None] == kv_segment_ids[:, None, :])[:, None]
        keep = seg if keep is None else keep & seg
    return keep


def _logits(q, k, scale, keep):
    """fp32 masked logits (B, H, Sq, Sk), K expanded over the group."""
    group = q.shape[2] // k.shape[2]
    kf = k.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    return s


def _seg_pair(segment_ids, kv_segment_ids, Sq, Sk):
    if segment_ids is None:
        return None, None
    if kv_segment_ids is None:
        if Sq != Sk:
            raise ValueError("segment_ids with Sq != Sk needs explicit "
                             "kv_segment_ids")
        kv_segment_ids = segment_ids
    return segment_ids, kv_segment_ids


def attention_reference(q, k, v, *, causal: bool = True,
                        scale: float | None = None,
                        window: int | None = None,
                        segment_ids=None, kv_segment_ids=None):
    """Exact attention.  q: (B, Sq, H, D); k/v: (B, Sk, Hkv, D) with
    H % Hkv == 0.  Same contract as the JAX ``attention_reference``:
    probabilities are cast to v's dtype before the value product."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"n_heads {H} not divisible by n_kv_heads {Hkv}")
    check_window(window, causal)
    segment_ids, kv_segment_ids = _seg_pair(segment_ids, kv_segment_ids,
                                            Sq, Sk)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    keep = _keep_mask(Sq, Sk, causal=causal, window=window, q_off=0,
                      k_off=0, segment_ids=segment_ids,
                      kv_segment_ids=kv_segment_ids, device=q.device)
    probs = torch.softmax(_logits(q, k, scale, keep), dim=-1).to(v.dtype)
    vg = v.repeat_interleave(H // Hkv, dim=2)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vg)


def _flash_forward_plain(q, k, v, *, causal: bool, scale: float,
                         offsets=(0, 0), window=None, segment_ids=None,
                         kv_segment_ids=None):
    """The kernel's function in plain PyTorch: (out in q's dtype,
    lse (B, H, Sq) fp32).  Rows with no key to attend are undefined,
    as in the kernel and on the TPU."""
    Sq, Sk = q.shape[1], k.shape[1]
    q_off, k_off = offsets
    keep = _keep_mask(Sq, Sk, causal=causal, window=window, q_off=q_off,
                      k_off=k_off, segment_ids=segment_ids,
                      kv_segment_ids=kv_segment_ids, device=q.device)
    s = _logits(q, k, scale, keep)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    vg = v.float().repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vg)
    return out.to(q.dtype), lse


# The C signature of nbd_flash_attention_fwd (csrc/flash_attention.cu):
# q, k, v, o, lse, qseg, kseg; B, Sq, Sk, H, Hkv, D, dtype, causal;
# scale; window, q_off, k_off; stream.
ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_float]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _flash_forward_cuda(q, k, v, *, causal, scale, offsets, window,
                        segment_ids, kv_segment_ids):
    """Launch ``nbd_flash_attention_fwd`` on q's current stream."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the flash kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if D not in (32, 64, 128):
        raise ValueError(f"the flash kernel takes head_dim 32, 64 or "
                         f"128, got {D}")
    if segment_ids is not None:
        segment_ids = segment_ids.to(torch.int32).contiguous()
        kv_segment_ids = kv_segment_ids.to(torch.int32).contiguous()
    check_contiguous(q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    q_off, k_off = (int(x) for x in offsets)
    code = _build.bind("flash_attention", "nbd_flash_attention_fwd",
                       ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(),
        segment_ids.data_ptr() if segment_ids is not None else None,
        kv_segment_ids.data_ptr() if kv_segment_ids is not None else None,
        B, Sq, Sk, H, Hkv, D, DTYPE_CODE[q.dtype], int(causal),
        float(scale), int(window or 0), q_off, k_off,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "nbd_flash_attention_fwd")
    flash_attention.launches += 1
    return out, lse


def _flash_forward(q, k, v, *, causal: bool, scale: float, offsets=None,
                   window: int | None = None, segment_ids=None,
                   kv_segment_ids=None):
    """Returns (out (B, Sq, H, D), lse (B, H, Sq) fp32) — the
    counterpart of the JAX ``_flash_forward`` (whose lse is laid out
    (B*Hkv, group, Sq_pad)).  ``offsets``: (q_off, k_off) global
    positions of row 0 of q and of k/v, for chunk-of-a-sequence calls.
    CUDA tensors launch the kernel, CPU tensors take the plain
    version; anything else raises."""
    B, Sq, H, D = q.shape
    if k.ndim != 4 or v.shape != k.shape or k.shape[0] != B \
            or k.shape[3] != D:
        raise ValueError(f"k/v must be (B, Sk, Hkv, {D}) matching q "
                         f"{tuple(q.shape)}; got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"n_heads {H} not divisible by n_kv_heads "
                         f"{k.shape[2]}")
    check_window(window, causal)
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention is forward-only in this port: the backward "
            "kernels (ROADMAP queue B, K2/K3) come with training")
    segment_ids, kv_segment_ids = _seg_pair(segment_ids, kv_segment_ids,
                                            Sq, k.shape[1])
    offsets = (0, 0) if offsets is None else offsets
    args = dict(causal=causal, scale=scale, offsets=offsets,
                window=window, segment_ids=segment_ids,
                kv_segment_ids=kv_segment_ids)
    if kernel_route(q, k, v, segment_ids, kv_segment_ids) == "cpu":
        return _flash_forward_plain(q, k, v, **args)
    return _flash_forward_cuda(q, k, v, **args)


def flash_attention(q, k, v, causal: bool = True,
                    scale: float | None = None,
                    window: int | None = None, segment_ids=None):
    """Flash attention forward.  q: (B, Sq, H, D); k/v: (B, Sk, Hkv, D).
    ``window``: sliding window (causal only); ``segment_ids`` (B, S):
    packed-document masking (requires Sq == Sk).  Returns (B, Sq, H, D)
    in q's dtype.  ``flash_attention.launches`` counts kernel launches."""
    if segment_ids is not None and q.shape[1] != k.shape[1]:
        raise ValueError("segment_ids requires Sq == Sk (packed "
                         "self-attention)")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _flash_forward(q, k, v, causal=causal, scale=scale,
                          window=window, segment_ids=segment_ids)[0]


flash_attention.launches = 0
