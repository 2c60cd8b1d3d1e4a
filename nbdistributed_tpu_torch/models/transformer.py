"""Llama-family decoder-only transformer in PyTorch (counterpart of
``nbdistributed_tpu/models/transformer.py``).

Parameters are a plain dict of tensors in the JAX package's layer-
stacked layout (``transformer.py:157-179``), so they convert leaf by
leaf (:mod:`.convert`): ``{"embed" (V, D), "layers": {wq (L, D, H*Dh),
wk, wv (L, D, Hkv*Dh), wo (L, H*Dh, D), w_gate, w_up (L, D, F),
w_down (L, F, D), attn_norm, mlp_norm (L, D) fp32}, "final_norm" (D,)
fp32, "lm_head" (D, V)}``.  The forward is a Python loop over layers;
attention goes through the flash kernel (``cfg.use_flash``) or the
plain reference.  Remat, sequence parallelism, shardings, the loss and
int8/int4 weights belong to later slices (ROADMAP).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import attention_reference, flash_attention
from ..ops._common import resolve_device
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


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked per-layer tensors (views)."""
    return {name: t[i] for name, t in params["layers"].items()}


# ----------------------------------------------------------------------
# forward

def qlinear(x, w):
    """``x @ w`` for a dense weight (``transformer.py:312``); the
    int8/int4 weight leaves come with a later slice."""
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


def _mlp_block(x, layer, cfg: TransformerConfig):
    h = _rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    gated = (torch.nn.functional.silu(qlinear(h, layer["w_gate"]))
             * qlinear(h, layer["w_up"]))
    return x + qlinear(gated, layer["w_down"])


def _as_tokens(tokens, device) -> torch.Tensor:
    return torch.as_tensor(tokens, dtype=torch.long, device=device)


@torch.no_grad()
def forward_hidden(params: dict, tokens, cfg: TransformerConfig,
                   positions=None, *, segment_ids=None):
    """tokens: (B, S) int -> final-norm hidden states (B, S, D) in
    ``cfg.dtype``, on the parameters' device."""
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
    for i in range(cfg.n_layers):
        layer = layer_params(params, i)
        x = _attention_block(x, layer, cfg, positions, segment_ids)
        x = _mlp_block(x, layer, cfg)
    return _rms_norm(x, params["final_norm"], cfg.norm_eps)


def forward(params: dict, tokens, cfg: TransformerConfig, positions=None,
            *, segment_ids=None):
    """tokens: (B, S) int -> logits (B, S, vocab) fp32.  Runs where the
    parameters live (:func:`init_params` puts them on the GPU unless
    asked for the CPU)."""
    x = forward_hidden(params, tokens, cfg, positions,
                       segment_ids=segment_ids)
    return qlinear(x, params["lm_head"]).float()
