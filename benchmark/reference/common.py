"""The pieces both references share: the precision of every product,
RMSNorm, rotary embedding and masked attention in query blocks."""

from __future__ import annotations

import contextlib

import torch

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """float32 products without TF32, restored on exit."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def fake_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to e4m3 with one scale per slice along ``dim`` (the
    amax of the slice maps to 448), returned in float32."""
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(FP8).float() / scale


class _MatmulFP8(torch.autograd.Function):
    """``a @ b`` with both operands in fp8 (rows of ``a``, columns of
    ``b`` scaled), and the backward's products in fp8 too."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return fake_fp8(a, -1) @ fake_fp8(b, -2)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = fake_fp8(g, -1) @ fake_fp8(b, -1).transpose(-1, -2)
        gb = fake_fp8(a, -2).transpose(-1, -2) @ fake_fp8(g, -2)
        return ga, gb


class Precision:
    """``mm(a, b)``: float32 (``"fp32"``) or both operands in fp8
    (``"fp8"``, the control)."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def mm(self, a, b):
        if self.name == "fp8":
            return _MatmulFP8.apply(a, b)
        return a @ b


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, pos, theta: float):
    """x (S, heads, Dh) float32, pos (S,): rotation of the two halves of
    each head by ``pos * theta ** (-i / half)``."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = (pos.double()[:, None] * inv[None]).float()
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attend_block(q, k, v, keep, prec: Precision):
    """q (Hkv, g, n, Dh), k/v (Hkv, m, Dh), keep (n, m) bool ->
    (n, Hkv * g * Dh): softmax attention of the block's queries."""
    Hkv, g, n, Dh = q.shape
    s = prec.mm(q.reshape(Hkv, g * n, Dh), k.transpose(1, 2))
    s = s.reshape(Hkv, g, n, -1) * Dh ** -0.5
    s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1).reshape(Hkv, g * n, -1)
    o = prec.mm(p, v).reshape(Hkv, g, n, Dh)
    return o.permute(2, 0, 1, 3).reshape(n, Hkv * g * Dh)


def attention(q, k, v, doc, window, prec: Precision, block: int = 1024,
              checkpointed: bool = False):
    """Causal GQA attention of one sequence, in blocks of ``block``
    queries.  q (S, H, Dh), k/v (S, Hkv, Dh) float32; ``doc`` (S,) the
    document of each position (a key attends only within its query's
    document), ``window`` (keys at most ``window - 1`` behind) or None.
    ``checkpointed``: each block is recomputed in the backward rather
    than kept."""
    S, H, Dh = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    qh = q.permute(1, 0, 2).reshape(Hkv, g, S, Dh)
    kh, vh = k.permute(1, 0, 2), v.permute(1, 0, 2)
    idx = torch.arange(S, device=q.device)
    outs = []
    for a in range(0, S, block):
        b = min(a + block, S)
        lo = 0 if window is None else max(0, a - window + 1)
        qi, ki = idx[a:b, None], idx[None, lo:b]
        keep = (ki <= qi) & (doc[lo:b][None] == doc[a:b, None])
        if window is not None:
            keep = keep & (ki > qi - window)
        args = (qh[:, :, a:b], kh[:, lo:b], vh[:, lo:b], keep, prec)
        if checkpointed:
            outs.append(torch.utils.checkpoint.checkpoint(
                attend_block, *args, use_reentrant=False))
        else:
            outs.append(attend_block(*args))
    return torch.cat(outs)
