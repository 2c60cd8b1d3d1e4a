"""Chunked-vocab softmax cross-entropy: the (N, V) logits never
materialize (counterpart of ``nbdistributed_tpu/ops/xent.py``).

The standard next-token loss computes ``logits = x @ W`` at (N, V) and
then ``log_softmax`` over V: fp32 buffers of N x V that dominate
training memory at LM scale.  Here the vocabulary is walked in chunks,
each under ``torch.utils.checkpoint``:

- forward: an online logsumexp (running max and rescaled sum) and the
  target logit, carried from chunk to chunk — one (N, chunk) block is
  live at a time;
- backward: each chunk's logits are recomputed from x and its slice of
  W, and its share of dx and dW is accumulated — again one block live.

Plain PyTorch, as the JAX version is plain jnp (no Pallas kernel).  The
last chunk is simply narrower when ``chunk`` does not divide V, so no
padded columns exist to mask.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def _chunk_step(x, w_chunk, col0, targets, m, s, tl):
    """One vocab chunk of the online logsumexp: (m, s, tl) updated."""
    logits = (x @ w_chunk).float()                      # (N, chunk)
    m2 = torch.maximum(m, logits.amax(dim=-1))
    s2 = s * torch.exp(m - m2) + torch.exp(logits - m2[:, None]).sum(-1)
    idx = targets - col0
    in_ch = (idx >= 0) & (idx < logits.shape[1])
    got = logits.gather(1, idx.clamp(0, logits.shape[1] - 1)[:, None])[:, 0]
    return m2, s2, torch.where(in_ch, got, tl)


def chunked_softmax_xent(x, W, targets, valid=None, chunk: int = 8192):
    """Mean NLL of ``targets`` under ``softmax(x @ W)`` without the
    (N, V) logits (``xent.py:38``).

    x: (N, D) activations; logits are computed in x's dtype and
    accumulated in fp32, as the standard path's ``(x @ W).float()``.
    W: (D, V).  targets: (N,) int.  valid: optional (N,) bool — rows
    left out of the mean (packed-document boundaries); the mean divides
    by the surviving count.  chunk: vocabulary columns per block."""
    N = x.shape[0]
    V = W.shape[1]
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    targets = targets.long()
    m = torch.full((N,), float("-inf"), dtype=torch.float32,
                   device=x.device)
    s = torch.zeros((N,), dtype=torch.float32, device=x.device)
    tl = torch.zeros((N,), dtype=torch.float32, device=x.device)
    for col0 in range(0, V, chunk):
        m, s, tl = checkpoint(_chunk_step, x, W[:, col0:col0 + chunk],
                              col0, targets, m, s, tl,
                              use_reentrant=False)
    nll = torch.log(s) + m - tl
    if valid is None:
        return nll.mean()
    keep = valid.to(nll.dtype)
    return (nll * keep).sum() / keep.sum().clamp(min=1)


def shifted_chunked_xent(hidden, W, tokens, segment_ids=None,
                         chunk: int = 8192):
    """Positions 0..S-2 of ``hidden`` (B, S, D) predict tokens[:, 1:],
    with packed-document boundary targets dropped as in
    ``shifted_xent`` (``xent.py:99``)."""
    B, S, D = hidden.shape
    x = hidden[:, :-1].reshape(B * (S - 1), D)
    targets = tokens[:, 1:].reshape(B * (S - 1))
    valid = None
    if segment_ids is not None:
        valid = (segment_ids[:, :-1] == segment_ids[:, 1:]).reshape(-1)
    return chunked_softmax_xent(x, W, targets, valid, chunk)
