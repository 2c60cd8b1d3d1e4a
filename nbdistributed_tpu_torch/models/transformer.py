"""Llama-family decoder-only transformer in PyTorch (counterpart of
``nbdistributed_tpu/models/transformer.py``).

Parameters are a plain dict of tensors in the JAX package's layer-
stacked layout (``transformer.py:157-179``), so they convert leaf by
leaf (:mod:`.convert`): ``{"embed" (V, D), "layers": {wq (L, D, H*Dh),
wk, wv (L, D, Hkv*Dh), wo (L, H*Dh, D), w_gate, w_up (L, D, F),
w_down (L, F, D), attn_norm, mlp_norm (L, D) fp32}, "final_norm" (D,)
fp32, "lm_head" (D, V)}``.  The forward is a Python loop over layers;
attention goes through the flash kernel (``cfg.use_flash``) or the
plain reference.  Every product goes through :func:`qlinear`, so a
tree with int8/int4 weight leaves (:mod:`.quant`) runs the same
forward.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint

from ..ops import attention_reference, flash_attention
from ..ops.xent import shifted_chunked_xent
from ..ops._common import resolve_device
from ..parallel.mesh import P
from ..utils import fan_in_normal


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    d_ff: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    use_flash: bool = True
    # Mistral-style sliding window: each position attends at most the
    # previous `sliding_window` tokens.  None = full causal.
    sliding_window: int | None = None
    # Recompute each layer in the backward pass (per-layer
    # torch.utils.checkpoint): activation memory O(S*D) per layer
    # instead of every layer's internals, for one extra forward.
    remat: bool = False
    # What a rematerialized layer keeps: None (recompute the whole
    # layer), "attn_only" / "mlp_only" (recompute that block only),
    # "dots" (save matmul outputs; later slice, ROADMAP A5).
    remat_policy: str | None = None
    # Chunked-vocab cross-entropy (ops/xent.py): the loss walks the
    # lm_head in blocks of this many vocab columns and never holds the
    # (B, S, V) logits.  None = the standard full-logits tail.
    ce_chunk: int | None = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def num_params(self) -> int:
        emb = self.vocab_size * self.d_model
        attn = (self.d_model * self.n_heads * self.head_dim
                + 2 * self.d_model * self.n_kv_heads * self.head_dim
                + self.n_heads * self.head_dim * self.d_model)
        mlp = 3 * self.d_model * self.d_ff
        norms = 2 * self.d_model
        return emb * 2 + self.n_layers * (attn + mlp + norms) + self.d_model


# Presets (transformer.py:105-140); caller kwargs override the defaults.
def tiny_config(**kw) -> TransformerConfig:
    return TransformerConfig(**{**dict(
        vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=384, max_seq_len=256), **kw})


def smol_135m_config(**kw) -> TransformerConfig:
    return TransformerConfig(**{**dict(
        vocab_size=49152, d_model=576, n_layers=30, n_heads=9,
        n_kv_heads=3, d_ff=1536, max_seq_len=2048), **kw})


def tinyllama_1b_config(**kw) -> TransformerConfig:
    return TransformerConfig(**{**dict(
        vocab_size=32000, d_model=2048, n_layers=22, n_heads=32,
        n_kv_heads=4, d_ff=5632, max_seq_len=2048), **kw})


def mistral_7b_config(**kw) -> TransformerConfig:
    return TransformerConfig(**{**dict(
        vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, d_ff=14336, max_seq_len=32768, sliding_window=4096,
        rope_theta=10000.0), **kw})


def llama2_7b_config(**kw) -> TransformerConfig:
    return TransformerConfig(**{**dict(
        vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
        n_kv_heads=32, d_ff=11008, max_seq_len=4096), **kw})


# ----------------------------------------------------------------------
# parameters

LAYER_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def layer_weight_dims(cfg: TransformerConfig) -> dict:
    """(d_in, d_out) of every per-layer weight matrix."""
    D, H, Hkv, Dh, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    return {"wq": (D, H * Dh), "wk": (D, Hkv * Dh), "wv": (D, Hkv * Dh),
            "wo": (H * Dh, D), "w_gate": (D, F), "w_up": (D, F),
            "w_down": (F, D)}


def init_params(cfg: TransformerConfig, seed: int = 0,
                device=None) -> dict:
    """Random layer-stacked parameters drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (None = the GPU).  Same
    distributions as the JAX ``init_params``; not the same numbers —
    tests hand both packages one set via :func:`.convert.params_from_jax`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    D, L = cfg.d_model, cfg.n_layers
    dims = layer_weight_dims(cfg)
    layers = {name: fan_in_normal(gen, (L,) + dims[name], dims[name][0],
                                  cfg.dtype) for name in LAYER_WEIGHTS}
    layers["attn_norm"] = torch.ones((L, D), dtype=torch.float32,
                                     device=dev)
    layers["mlp_norm"] = torch.ones((L, D), dtype=torch.float32,
                                    device=dev)
    return {
        "embed": fan_in_normal(gen, (cfg.vocab_size, D), 1.0, cfg.dtype),
        "layers": layers,
        "final_norm": torch.ones((D,), dtype=torch.float32, device=dev),
        "lm_head": fan_in_normal(gen, (D, cfg.vocab_size), D, cfg.dtype),
    }


def param_shardings(cfg: TransformerConfig) -> dict:
    """Megatron-style tensor-parallel rules over the mesh axis ``tp``
    (``transformer.py:182``): columns of wq/wk/wv/w_gate/w_up, rows of
    wo/w_down, so each block ends in one all-reduce over ``tp``; the
    embedding's columns and the lm_head's vocab columns are split too,
    and gathered over ``tp`` where they are used."""
    return {
        "embed": P(None, "tp"),
        "layers": {
            "attn_norm": P(None, None),
            "wq": P(None, None, "tp"),
            "wk": P(None, None, "tp"),
            "wv": P(None, None, "tp"),
            "wo": P(None, "tp", None),
            "mlp_norm": P(None, None),
            "w_gate": P(None, None, "tp"),
            "w_up": P(None, None, "tp"),
            "w_down": P(None, "tp", None),
        },
        "final_norm": P(None),
        "lm_head": P(None, "tp"),
    }


def _slice_layer(t, i: int):
    return ({k: _slice_layer(v, i) for k, v in t.items()}
            if isinstance(t, dict) else t[i])


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked per-layer tensors (views).  A
    nested subtree (a quantized leaf ``{"q8", "s"}`` or ``{"q4", "s"}``,
    the MoE ``moe`` group, quantized experts inside it) is sliced leaf
    by leaf."""
    return _slice_layer(params["layers"], i)


# ----------------------------------------------------------------------
# forward

def is_quantized(leaf) -> bool:
    """True for an int8 weight-only quantized leaf ``{"q8", "s"}``
    (:mod:`.quant`; ``transformer.py:243``)."""
    return isinstance(leaf, dict) and "q8" in leaf and "s" in leaf


def is_quantized4(leaf) -> bool:
    """True for a nibble-packed int4 leaf ``{"q4", "s"}``."""
    return isinstance(leaf, dict) and "q4" in leaf and "s" in leaf


def _pack_nibbles(q):
    """(..., d_in, d_out) int values in [-7, 7] -> (..., d_in/2, d_out)
    uint8; row 2k rides the low nibble, row 2k+1 the high
    (``transformer.py:260``)."""
    q = q.to(torch.int32)
    lo = q[..., 0::2, :] & 0xF
    hi = q[..., 1::2, :] & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def _unpack_nibbles(packed, dtype):
    """Inverse of :func:`_pack_nibbles`, sign-extended in int32 (the
    uint8 array has no negative values to extend)."""
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = (((p >> 4) & 0xF) ^ 8) - 8
    q = torch.stack([lo, hi], dim=-2)         # (..., d_in/2, 2, d_out)
    return q.reshape(*packed.shape[:-2], packed.shape[-2] * 2,
                     packed.shape[-1]).to(dtype)


def _qlinear4(x, w):
    """``x @ W`` for a nibble-packed int4 leaf with grouped scales
    (``transformer.py:278``): the grouped scales do not commute with the
    whole product, so it runs as G batched (group x d_out) products in
    ``x.dtype`` whose partials are scaled and summed in fp32."""
    q4, s = w["q4"], w["s"]
    if q4.ndim != 2:
        raise ValueError(
            f"qlinear on a stacked int4 leaf (q4 shape "
            f"{tuple(q4.shape)}): expected a 2D (d_in/2, d_out) "
            f"weight — index the leading {q4.ndim - 2} dim(s) and apply "
            f"qlinear per slice")
    d_in, d_out = q4.shape[-2] * 2, q4.shape[-1]
    G = s.shape[-3]
    group = d_in // G
    qg = _unpack_nibbles(q4, x.dtype).reshape(G, group, d_out)
    xg = x.reshape(*x.shape[:-1], G, group)
    y = torch.einsum("...gk,gko->...go", xg, qg).float()
    y = torch.einsum("...go,go->...o", y, s.reshape(G, d_out).float())
    return y.to(x.dtype)


def qlinear(x, w):
    """``x @ w`` where ``w`` is a plain weight, an int8 leaf ``{"q8",
    "s"}`` or an int4 leaf ``{"q4", "s"}`` (``transformer.py:312``).
    int8: per-output-channel scales commute with the product, so it
    runs ``x @ q8.to(x.dtype)`` (int8 magnitudes are exact in bf16) and
    rescales the columns in fp32.  The cast materializes the weight in
    ``x.dtype`` on every call: PyTorch does not fuse it into the
    product's operand read as XLA does."""
    if is_quantized(w):
        y = x @ w["q8"].to(x.dtype)
        return (y.float() * w["s"]).to(x.dtype)
    if is_quantized4(w):
        return _qlinear4(x, w)
    return x @ w


def _rms_norm(x, weight, eps):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight).to(x.dtype)


def _rope(x, positions, theta):
    """Rotary embedding.  x: (B, S, H, D); positions: (B, S)."""
    D = x.shape[-1]
    half = D // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exps)
    angles = positions[:, :, None].float() * freqs         # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _attention_block(x, layer, cfg: TransformerConfig, positions,
                     segment_ids=None):
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = _rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    q = _rope(qlinear(h, layer["wq"]).reshape(B, S, H, Dh), positions,
              cfg.rope_theta)
    k = _rope(qlinear(h, layer["wk"]).reshape(B, S, Hkv, Dh), positions,
              cfg.rope_theta)
    v = qlinear(h, layer["wv"]).reshape(B, S, Hkv, Dh)
    if cfg.use_flash:
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            True, None, cfg.sliding_window, segment_ids)
    else:
        o = attention_reference(q, k, v, causal=True,
                                window=cfg.sliding_window,
                                segment_ids=segment_ids)
    return x + qlinear(o.reshape(B, S, H * Dh), layer["wo"])


def _mlp_block(x, layer, cfg: TransformerConfig, reduce=None):
    """The SwiGLU residual block; ``reduce`` sums a row-split
    ``w_down``'s partial products over the tensor-parallel ranks."""
    h = _rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    gated = (torch.nn.functional.silu(qlinear(h, layer["w_gate"]))
             * qlinear(h, layer["w_up"]))
    y = qlinear(gated, layer["w_down"])
    return x + (y if reduce is None else reduce(y))


def _as_tokens(tokens, device) -> torch.Tensor:
    return torch.as_tensor(tokens, dtype=torch.long, device=device)


def make_layer_fn(cfg: TransformerConfig, positions, segment_ids=None):
    """The per-layer recipe (attention block + MLP block, optionally
    rematerialized with ``torch.utils.checkpoint(use_reentrant=False)``)
    — ``transformer.py:438``.  Returns ``one_layer(x, layer) -> x``."""

    def one_layer(x, layer):
        x = _attention_block(x, layer, cfg, positions, segment_ids)
        return _mlp_block(x, layer, cfg)

    # Validate the policy BEFORE the remat gate: a config carrying a
    # policy but remat=False (or an unknown policy string) must fail
    # loudly, not silently train with full activation memory.
    policy = cfg.remat_policy
    if policy not in (None, "dots", "attn_only", "mlp_only"):
        raise ValueError(f"unknown remat_policy {policy!r} "
                         f"(None, 'dots', 'attn_only' or 'mlp_only')")
    if policy is not None and not cfg.remat:
        raise ValueError("remat_policy is set but remat=False — the "
                         "policy would be silently ignored; set "
                         "remat=True (or drop the policy)")
    if not cfg.remat:
        return one_layer
    if policy == "dots":
        raise NotImplementedError(
            "remat_policy='dots' (save matmul outputs, recompute the "
            "rest) is not ported yet: ROADMAP A5")

    def remat(fn):
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)

    if policy == "attn_only":
        # Recompute the attention block (the flash kernel re-runs off
        # its saved lse); the MLP's d_ff-wide activations stay saved.
        attn = remat(lambda x, layer: _attention_block(
            x, layer, cfg, positions, segment_ids))
        return lambda x, layer: _mlp_block(attn(x, layer), layer, cfg)
    if policy == "mlp_only":
        mlp = remat(lambda x, layer: _mlp_block(x, layer, cfg))
        return lambda x, layer: mlp(_attention_block(
            x, layer, cfg, positions, segment_ids), layer)
    return remat(one_layer)


def forward_hidden(params: dict, tokens, cfg: TransformerConfig,
                   positions=None, *, segment_ids=None):
    """tokens: (B, S) int -> final-norm hidden states (B, S, D) in
    ``cfg.dtype``, on the parameters' device.  Differentiable in the
    parameters."""
    device = params["embed"].device
    tokens = _as_tokens(tokens, device)
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=device).expand(B, S)
    else:
        positions = _as_tokens(positions, device)
    if segment_ids is not None:
        segment_ids = _as_tokens(segment_ids, device)
    x = params["embed"][tokens].to(cfg.dtype)
    one_layer = make_layer_fn(cfg, positions, segment_ids)
    for i in range(cfg.n_layers):
        x = one_layer(x, layer_params(params, i))
    return _rms_norm(x, params["final_norm"], cfg.norm_eps)


def forward(params: dict, tokens, cfg: TransformerConfig, positions=None,
            *, segment_ids=None):
    """tokens: (B, S) int -> logits (B, S, vocab) fp32.  Runs where the
    parameters live (:func:`init_params` puts them on the GPU unless
    asked for the CPU)."""
    x = forward_hidden(params, tokens, cfg, positions,
                       segment_ids=segment_ids)
    return qlinear(x, params["lm_head"]).float()


# ----------------------------------------------------------------------
# loss

def shifted_xent(logits, tokens, segment_ids=None):
    """Next-token cross-entropy of logits (B, S, V) from a full-S
    forward: positions 0..S-2 predict tokens[:, 1:] (``transformer.py
    :532``).  With ``segment_ids`` the boundary targets (seg[i] !=
    seg[i+1]) drop and the mean runs over the rest."""
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:, None].long())
    if segment_ids is None:
        return nll.mean()
    keep = (segment_ids[:, :-1] == segment_ids[:, 1:])[..., None]
    return (torch.where(keep, nll, 0.0).sum()
            / keep.sum().clamp(min=1))


def packed_positions(segment_ids):
    """Within-document positions of a packed batch: position restarts
    at 0 at every document boundary.  segment_ids (B, S) non-decreasing
    per row -> (B, S) long."""
    seg = torch.as_tensor(segment_ids)
    pos = torch.arange(seg.shape[1], device=seg.device)[None]
    is_start = torch.cat([torch.ones_like(seg[:, :1], dtype=torch.bool),
                          seg[:, 1:] != seg[:, :-1]], dim=1)
    seg_start = torch.cummax(torch.where(is_start, pos, 0), dim=1).values
    return pos - seg_start


def loss_fn(params: dict, batch: dict, cfg: TransformerConfig):
    """Next-token cross-entropy of ``batch["tokens"]`` (B, S): the
    forward runs on all S tokens and the logits are shifted
    (``transformer.py:593``).  ``batch["segments"]`` (optional, (B, S)):
    packed documents — attention stays inside each document, RoPE
    positions restart per document, boundary targets drop.  With
    ``cfg.ce_chunk`` the loss takes the chunked-vocab tail and the
    (B, S, V) logits never exist."""
    device = params["embed"].device
    tokens = _as_tokens(batch["tokens"], device)
    seg = batch.get("segments")
    positions = None
    if seg is not None:
        seg = _as_tokens(seg, device)
        positions = packed_positions(seg)
    if cfg.ce_chunk is not None:
        hidden = forward_hidden(params, tokens, cfg, positions,
                                segment_ids=seg)
        return shifted_chunked_xent(hidden, params["lm_head"], tokens,
                                    segment_ids=seg, chunk=cfg.ce_chunk)
    logits = forward(params, tokens, cfg, positions, segment_ids=seg)
    return shifted_xent(logits, tokens, segment_ids=seg)


# ----------------------------------------------------------------------
# training step

def named_param_leaves(tree: dict, prefix: str = "") -> list:
    """``(path, tensor)`` for each tensor of a nested dict, in sorted-key
    order (the JAX pytree order); paths join keys with ``/``."""
    out = []
    for key in sorted(tree):
        leaf, name = tree[key], f"{prefix}{key}"
        out += (named_param_leaves(leaf, name + "/")
                if isinstance(leaf, dict) else [(name, leaf)])
    return out


def param_leaves(tree: dict) -> list:
    """The tensors of a nested dict, in sorted-key order (the JAX
    pytree order)."""
    return [leaf for _, leaf in named_param_leaves(tree)]


@torch.no_grad()
def _apply_update(p, u) -> None:
    """p <- (fp32(p) + u) cast once to p's dtype, in place."""
    p.copy_((p.float() + u).to(p.dtype))


def apply_optimizer_updates(params: dict, updates: dict) -> None:
    """Add ``updates`` (same tree) to ``params`` in place with fp32
    accumulation, casting back to each leaf's storage dtype — the one
    mixed-precision update convention (``transformer.py:656``)."""
    for p, u in zip(param_leaves(params), param_leaves(updates)):
        _apply_update(p, u.float())


class AdamW(torch.optim.Optimizer):
    """``optax.adamw`` in ``torch.optim`` form: the same defaults (b1
    0.9, b2 0.999, eps 1e-8, weight_decay 1e-4, where ``torch.optim.
    AdamW`` has 1e-2) and the same update
    ``u = -lr * (m_hat / (sqrt(v_hat) + eps) + weight_decay * p)``.

    Mixed precision as in the JAX package: the moments are kept in the
    leaf's dtype, as optax keeps them with ``mu_dtype=None``; each
    leaf's update is computed in fp32 from its grad and moments, added
    to the fp32 value of the leaf and cast once to the leaf's dtype
    (``apply_optimizer_updates``).  A bf16 leaf is therefore never
    stepped in bf16 arithmetic.  Leaves are updated in place."""

    def __init__(self, params, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4):
        if lr <= 0:
            raise ValueError(f"lr must be > 0, got {lr}")
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            lr, b1, b2 = group["lr"], group["b1"], group["b2"]
            eps, wd = group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                st["step"] += 1
                t = st["step"]
                g = p.grad.float()
                mu = st["mu"].float() * b1 + (1 - b1) * g
                nu = st["nu"].float() * b2 + (1 - b2) * (g * g)
                # Stored in the leaf's dtype, then used as stored.
                mu = st["mu"].copy_(mu).float()
                nu = st["nu"].copy_(nu).float()
                mu_hat = mu / (1 - b1 ** t)
                nu_hat = nu / (1 - b2 ** t)
                u = mu_hat / (nu_hat.sqrt() + eps) + wd * p.float()
                _apply_update(p, -lr * u)


def _trainable(optimizer) -> list:
    leaves = [p for g in optimizer.param_groups for p in g["params"]]
    for p in leaves:
        if not p.is_leaf:
            raise ValueError("the optimizer's parameters must be leaf "
                             "tensors")
        p.requires_grad_(True)
    return leaves


def _optimizer_step(optimizer, loss_of):
    """Returns ``step(*args) -> loss``: clear the grads of the
    optimizer's leaves, ``loss_of(*args)``, its gradients by autograd
    and one ``optimizer`` step.  The loss comes back detached."""
    leaves = _trainable(optimizer)

    def step(*args):
        for p in leaves:
            p.grad = None
        loss = loss_of(*args)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_train_step(cfg: TransformerConfig, optimizer):
    """Returns ``step(params, batch) -> loss``: :func:`loss_fn`, its
    gradients by autograd (through K2/K3 when ``cfg.use_flash``) and
    one ``optimizer`` step, which updates ``params`` in place (the
    counterpart of ``transformer.py:665``, whose step returns new
    params and optimizer state instead).  ``optimizer`` holds the
    leaves of ``params`` (e.g. ``AdamW(param_leaves(params), lr)``);
    they are made to require grad.  The loss comes back detached."""
    return _optimizer_step(optimizer,
                           lambda params, batch: loss_fn(params, batch, cfg))


def num_tokens_per_step(batch_shape) -> int:
    return math.prod(batch_shape)
