"""Flash attention, forward and backward: the hand-written Hopper
kernels (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``)
and their plain PyTorch versions (counterpart of
``nbdistributed_tpu/ops/attention.py``).

* :func:`attention_reference` — exact attention in plain PyTorch
  (``attention.py:48``), the oracle and the ``use_flash=False`` path.
* :func:`flash_attention` / :func:`_flash_forward` — the flash forward
  (``attention.py:784`` / ``:338``): causal or not, GQA (query head
  ``h`` reads kv head ``h // group``), ragged Sq/Sk, a sliding window,
  packed-document ``segment_ids``, ``(q_off, k_off)`` offsets, and the
  fp32 per-row lse.
* :func:`_flash_backward` — the blockwise backward from the saved lse
  (``attention.py:613``): dQ (K2) and dK/dV (K3), same feature set.
  :func:`flash_attention` is differentiable through it
  (:class:`_FlashAttention`, the counterpart of the JAX ``custom_vjp``).

CUDA tensors launch the kernels; CPU tensors take the plain versions
(:func:`_flash_forward_plain`, :func:`_flash_backward_plain`), which
compute the same functions.  Layout: q (B, Sq, H, D), k/v
(B, Sk, Hkv, D), as in the JAX package.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..observability.spans import maybe_span
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


def _check_kernel_inputs(q, k, v) -> None:
    """What the CUDA kernels take: one dtype, fp32 or bf16, head_dim
    32, 64 or 128."""
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the flash kernels take float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.shape[-1] not in (32, 64, 128):
        raise ValueError(f"the flash kernels take head_dim 32, 64 or "
                         f"128, got {q.shape[-1]}")


def _kernel_segments(segment_ids, kv_segment_ids):
    if segment_ids is None:
        return None, None
    return (segment_ids.to(torch.int32).contiguous(),
            kv_segment_ids.to(torch.int32).contiguous())


def _ptr(t):
    return t.data_ptr() if t is not None else None


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
    _check_kernel_inputs(q, k, v)
    segment_ids, kv_segment_ids = _kernel_segments(segment_ids,
                                                   kv_segment_ids)
    check_contiguous(q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    q_off, k_off = (int(x) for x in offsets)
    code = _build.bind("flash_attention", "nbd_flash_attention_fwd",
                       ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _ptr(segment_ids), _ptr(kv_segment_ids),
        B, Sq, Sk, H, Hkv, D, DTYPE_CODE[q.dtype], int(causal),
        float(scale), int(window or 0), q_off, k_off,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "nbd_flash_attention_fwd")
    flash_attention.launches += 1
    return out, lse


def _check_qkv(q, k, v, causal, window) -> None:
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


def _flash_forward(q, k, v, *, causal: bool, scale: float, offsets=None,
                   window: int | None = None, segment_ids=None,
                   kv_segment_ids=None):
    """Returns (out (B, Sq, H, D), lse (B, H, Sq) fp32) — the
    counterpart of the JAX ``_flash_forward`` (whose lse is laid out
    (B*Hkv, group, Sq_pad)).  ``offsets``: (q_off, k_off) global
    positions of row 0 of q and of k/v, for chunk-of-a-sequence calls.
    CUDA tensors launch the kernel, CPU tensors take the plain
    version; anything else raises."""
    _check_qkv(q, k, v, causal, window)
    segment_ids, kv_segment_ids = _seg_pair(segment_ids, kv_segment_ids,
                                            q.shape[1], k.shape[1])
    offsets = (0, 0) if offsets is None else offsets
    args = dict(causal=causal, scale=scale, offsets=offsets,
                window=window, segment_ids=segment_ids,
                kv_segment_ids=kv_segment_ids)
    if kernel_route(q, k, v, segment_ids, kv_segment_ids) == "cpu":
        return _flash_forward_plain(q, k, v, **args)
    return _flash_forward_cuda(q, k, v, **args)


# ----------------------------------------------------------------------
# backward: K2 (dQ) and K3 (dK/dV) from the saved lse

def _flash_bwd_prep(out, g):
    """delta = rowsum(dO * O) in fp32 from O as stored, laid out
    (B, H, Sq) like the lse (``attention.py:599``; plain XLA there,
    one PyTorch reduction here)."""
    return (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _flash_backward_plain(q, k, v, out, lse, g, *, causal: bool,
                          scale: float, offsets=(0, 0), window=None,
                          segment_ids=None, kv_segment_ids=None,
                          delta=None):
    """The kernels' function in plain PyTorch, from the saved lse
    (``attention.py:430-440``): p = exp(s - lse) (0 where masked),
    dS = p * (dO.V - delta), dQ = scale * dS K, dK = scale * dS^T Q,
    dV = p^T dO, dK/dV summed over the GQA group, all in fp32 and cast
    once to q's / k's / v's dtype.  Not autograd of the reference.
    ``delta``: given (a ring hop's global one), ``out`` is not read."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    q_off, k_off = offsets
    keep = _keep_mask(Sq, Sk, causal=causal, window=window, q_off=q_off,
                      k_off=k_off, segment_ids=segment_ids,
                      kv_segment_ids=kv_segment_ids, device=q.device)
    p = torch.exp(_logits(q, k, scale, keep) - lse[..., None])
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    gf = g.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", gf,
                      v.float().repeat_interleave(group, dim=2))
    if delta is None:
        delta = _flash_bwd_prep(out, g)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds,
                      k.float().repeat_interleave(group, dim=2)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    dk = dk.reshape(B, Sk, Hkv, group, D).sum(3)
    dv = dv.reshape(B, Sk, Hkv, group, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# The C signatures of csrc/flash_attention_bwd.cu: q, k, v, dout, lse,
# delta, qseg, kseg, then dq (nbd_flash_attention_bwd_dq) or dk, dv
# (nbd_flash_attention_bwd_dkv); B, Sq, Sk, H, Hkv, D, dtype, causal;
# scale; window, q_off, k_off; stream.
_BWD_TAIL = ([ctypes.c_int] * 8 + [ctypes.c_float] + [ctypes.c_int] * 3
             + [ctypes.c_void_p])
DQ_ARGTYPES = [ctypes.c_void_p] * 9 + _BWD_TAIL
DKV_ARGTYPES = [ctypes.c_void_p] * 10 + _BWD_TAIL


def _bwd_launch(symbol, argtypes, q, k, v, g, lse, delta, outs, *, causal,
                scale, offsets, window, segment_ids, kv_segment_ids):
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    _check_kernel_inputs(q, k, v)
    if g.dtype != q.dtype or g.shape != q.shape:
        raise ValueError(f"grad_out must match q: {tuple(q.shape)} "
                         f"{q.dtype}; got {tuple(g.shape)} {g.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (B, H, Sq):
            raise ValueError(f"{name} must be (B, H, Sq) = {(B, H, Sq)} "
                             f"float32; got {tuple(t.shape)} {t.dtype}")
    check_contiguous(q=q, k=k, v=v, grad_out=g, lse=lse, delta=delta)
    segment_ids, kv_segment_ids = _kernel_segments(segment_ids,
                                                   kv_segment_ids)
    q_off, k_off = (int(x) for x in offsets)
    code = _build.bind("flash_attention_bwd", symbol, argtypes)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(segment_ids),
        _ptr(kv_segment_ids), *(t.data_ptr() for t in outs),
        B, Sq, Sk, H, Hkv, D, DTYPE_CODE[q.dtype], int(causal),
        float(scale), int(window or 0), q_off, k_off,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, symbol)


def flash_attention_bwd_dq(q, k, v, g, lse, delta, **args):
    """Launch K2 (``nbd_flash_attention_bwd_dq``): dQ (B, Sq, H, D) in
    q's dtype.  ``flash_attention_bwd_dq.launches`` counts launches."""
    dq = torch.empty_like(q)
    _bwd_launch("nbd_flash_attention_bwd_dq", DQ_ARGTYPES, q, k, v, g,
                lse, delta, (dq,), **args)
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, g, lse, delta, **args):
    """Launch K3 (``nbd_flash_attention_bwd_dkv``): (dK, dV), each
    (B, Sk, Hkv, D) in k's dtype, summed over the GQA group.
    ``flash_attention_bwd_dkv.launches`` counts launches."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("nbd_flash_attention_bwd_dkv", DKV_ARGTYPES, q, k, v, g,
                lse, delta, (dk, dv), **args)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def _flash_backward_cuda(q, k, v, out, lse, g, *, delta=None, **args):
    """delta (unless given: then ``out`` is not read), then K2, then K3,
    all on q's current stream."""
    if delta is None:
        delta = _flash_bwd_prep(out, g)
    dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, **args)
    dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta, **args)
    return dq, dk, dv


def _flash_backward_hop(q, k, v, g, lse, delta, *, causal: bool,
                        scale: float, offsets=(0, 0),
                        window: int | None = None, segment_ids=None,
                        kv_segment_ids=None):
    """(dq, dk, dv) of the keys ``k``/``v`` alone, from a saved lse and
    delta (B, H, Sq) that cover more keys than these: a ring hop's, whose
    lse and delta are the whole sequence's (the hops are independent
    given them, as the kernels' key tiles are).  CUDA tensors launch K2
    and K3; CPU tensors take :func:`_flash_backward_plain`; anything
    else raises."""
    _check_qkv(q, k, v, causal, window)
    segment_ids, kv_segment_ids = _seg_pair(segment_ids, kv_segment_ids,
                                            q.shape[1], k.shape[1])
    args = dict(causal=causal, scale=scale, offsets=offsets,
                window=window, segment_ids=segment_ids,
                kv_segment_ids=kv_segment_ids)
    if kernel_route(q, k, v, g, lse, delta, segment_ids,
                    kv_segment_ids) == "cpu":
        return _flash_backward_plain(q, k, v, None, lse, g, delta=delta,
                                     **args)
    return _flash_backward_cuda(q, k, v, None, lse, g, delta=delta, **args)


def _flash_backward(q, k, v, out, lse, g, *, causal: bool, scale: float,
                    offsets=None, window: int | None = None,
                    segment_ids=None, kv_segment_ids=None):
    """(dq, dk, dv) of the flash forward that returned (out, lse), for
    the output gradient ``g`` — the counterpart of the JAX
    ``_flash_backward``.  CUDA tensors launch K2 and K3, CPU tensors
    take :func:`_flash_backward_plain`; anything else raises."""
    _check_qkv(q, k, v, causal, window)
    segment_ids, kv_segment_ids = _seg_pair(segment_ids, kv_segment_ids,
                                            q.shape[1], k.shape[1])
    offsets = (0, 0) if offsets is None else offsets
    args = dict(causal=causal, scale=scale, offsets=offsets,
                window=window, segment_ids=segment_ids,
                kv_segment_ids=kv_segment_ids)
    with maybe_span("attn/k2k3"):
        if kernel_route(q, k, v, out, lse, g, segment_ids,
                        kv_segment_ids) == "cpu":
            return _flash_backward_plain(q, k, v, out, lse, g, **args)
        return _flash_backward_cuda(q, k, v, out, lse, g, **args)


class _FlashAttention(torch.autograd.Function):
    """The flash forward with K2/K3 as its backward (the JAX
    ``custom_vjp`` at ``attention.py:783``).  Saves q, k, v, out, the
    lse and the segment ids; the causal flag, scale, window and the
    integer segment ids get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, segment_ids):
        out, lse = _flash_forward(q, k, v, causal=causal, scale=scale,
                                  window=window, segment_ids=segment_ids)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.args = dict(causal=causal, scale=scale, window=window)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse, segment_ids = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, out, lse,
                                     grad_out.contiguous(),
                                     segment_ids=segment_ids, **ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = True,
                    scale: float | None = None,
                    window: int | None = None, segment_ids=None):
    """Flash attention.  q: (B, Sq, H, D); k/v: (B, Sk, Hkv, D).
    ``window``: sliding window (causal only); ``segment_ids`` (B, S):
    packed-document masking (requires Sq == Sk).  Returns (B, Sq, H, D)
    in q's dtype, differentiable in q, k and v.
    ``flash_attention.launches`` counts forward kernel launches."""
    if segment_ids is not None and q.shape[1] != k.shape[1]:
        raise ValueError("segment_ids requires Sq == Sk (packed "
                         "self-attention)")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    with maybe_span("attn/k1"):
        return _FlashAttention.apply(q, k, v, causal, scale, window,
                                     segment_ids)


flash_attention.launches = 0
