"""Symmetric int8 quantization (counterpart of
``nbdistributed_tpu/models/quant.py:44-58``).  This slice needs it for
the int8 KV cache only; int8/int4 weights come with a later slice."""

from __future__ import annotations

import torch


def quantize_weight(w, *, axis: int = -2) -> dict:
    """``{"q8": int8, "s": fp32}`` with ``w ≈ q8 * s``; ``axis`` is the
    axis reduced over when choosing scales (kept as size 1 in ``s``).
    Rounds half to even, as ``jnp.round`` does."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    s = torch.clamp(amax, min=1e-8) / 127.0
    q8 = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return {"q8": q8, "s": s}


def dequantize_weight(qw: dict, dtype=torch.float32):
    return (qw["q8"].float() * qw["s"]).to(dtype)
