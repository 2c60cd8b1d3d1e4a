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

**On a mesh** (``mesh=``, ``rules=``; :mod:`..parallel.mesh`) every
rank runs the same forward on its shard of the tree and its rows of the
batch, issuing the collectives that GSPMD inserts in the JAX package.
The rules say how each leaf was cut (:func:`param_shardings`,
:func:`fsdp_param_shardings`): a leaf's ``tp`` entry splits its
product (columns of wq/wk/wv/w_gate/w_up and rows of wo/w_down, with
Megatron's ``f`` before and ``g`` after), and any other axis in its
spec (``dp`` under FSDP) is gathered just before use, inside the remat
region, so the recompute gathers again.  Attention takes its local
heads to the kernel when ``tp`` divides both head counts, and otherwise
gathers q, k and v over ``tp``, attends every head on every ``tp`` rank
and keeps this rank's columns of the output for ``wo``'s row split.
The loss on a mesh is this rank's: its mean over ``dp`` is the loss of
the whole batch, packed documents included (:func:`loss_fn`).

**Sequence parallelism** (``sp=``, :class:`SeqParallel`): each rank of
the ``sp`` axis holds one chunk of every row's sequence, and attention,
the one operation that mixes positions, runs as the ring
(:mod:`..parallel.ring`) or Ulysses (:mod:`..parallel.ulysses`) over
that axis; everything else is position-wise on the chunk.  It composes
with ``mesh=``/``rules=`` (dp rows, tp heads).  ``sp`` splits the batch
as ``dp`` does: the loss on a rank is its share of the whole batch's
mean times the number of ranks that split it, so its mean over ``dp``
and ``sp`` is the whole batch's loss, and the train step takes the mean
of the gradients over both.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..observability.spans import maybe_span
from ..ops import attention_reference, flash_attention
from ..ops.xent import chunked_softmax_xent, shifted_chunked_xent
from ..ops._common import resolve_device
from ..parallel.mesh import P, _spec_axes, local_slice
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
    # "dots" (save the layer's matrix products, recompute the rest).
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


def fsdp_param_shardings(cfg: TransformerConfig, dp_axis: str = "dp",
                         tp_axis: str | None = None) -> dict:
    """FSDP rules (``transformer.py:204``): every large weight split over
    ``dp_axis`` on the axis opposite to Megatron's (the contraction rows
    of the column-split weights, the output columns of wo/w_down), the
    embedding's and lm_head's first axis too; the forward gathers each
    over ``dp`` just before use and its gradient comes back
    reduce-scattered.  With ``tp_axis`` the Megatron split applies on
    the other axis at once (HSDP).  Norms stay whole."""
    row, col = dp_axis, tp_axis
    return {
        "embed": P(dp_axis, col),
        "layers": {
            "attn_norm": P(None, None),
            "wq": P(None, row, col),
            "wk": P(None, row, col),
            "wv": P(None, row, col),
            "wo": P(None, col, row),
            "mlp_norm": P(None, None),
            "w_gate": P(None, row, col),
            "w_up": P(None, row, col),
            "w_down": P(None, col, row),
        },
        "final_norm": P(None),
        "lm_head": P(dp_axis, col),
    }


def _slice_layer(t, i: int):
    return ({k: _slice_layer(v, i) for k, v in t.items()}
            if isinstance(t, dict) else t[i])


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked per-layer tensors (views).  A
    nested subtree (a quantized leaf ``{"q8", "s"}`` or ``{"q4", "s"}``,
    the MoE ``moe`` group, quantized experts inside it) is sliced leaf
    by leaf.  For the paths that need no gradient (the cached
    generation under ``no_grad``).  The training forwards take
    :func:`layer_slices` instead: the backward of each ``t[i]`` here is
    a zero-filled tensor the size of the whole stacked leaf, added into
    its gradient, so slicing every layer this way writes, reads and adds
    all L layers' gradient L times a backward."""
    return _slice_layer(params["layers"], i)


def _unbind_layers(t):
    """A stacked (sub)tree cut into its per-layer trees, each tensor once
    by ``torch.unbind``: a tuple of views for a tensor, a list of dicts
    for a dict."""
    if not isinstance(t, dict):
        return torch.unbind(t, 0)
    parts = {k: _unbind_layers(v) for k, v in t.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def layer_slices(params: dict) -> list:
    """Every layer's :func:`layer_params` at once: the L per-layer trees
    (views), each stacked tensor cut once by ``torch.unbind``.  The
    training forwards (``forward_hidden``, ``moe_forward_hidden``, a
    pipeline stage) cut once per forward so that the backward assembles
    each stacked leaf's gradient once, one read and one write of the
    leaf (``UnbindBackward0`` stacks the L slices' gradients), where a
    per-layer select costs a whole-leaf fill and add per layer."""
    return _unbind_layers(params["layers"])


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


class MeshLayout:
    """This rank's tree on a mesh, read from its rule tree (module
    docstring): the ``tp`` split of each layer product, and the axes of
    each leaf's spec other than ``keep`` (``tp`` and ``ep_axis``, which
    the model computes split), which the forward gathers over before
    using the leaf.  ``rules=None`` is a tree held whole on every
    rank."""

    def __init__(self, mesh, rules, ep_axis: str = "ep"):
        self.mesh, self.rules = mesh, rules
        self.keep = ("tp", ep_axis)
        self.tp = "tp" if mesh.size("tp") > 1 else None
        layers = (rules or {}).get("layers", {})
        self.kinds = {name: self._kind(layers.get(name))
                      for name in LAYER_WEIGHTS}

    def _kind(self, spec):
        """``"col"`` or ``"row"``: a stacked weight's output columns or
        contraction rows split over ``tp``; None if neither."""
        if self.tp is None or spec is None or len(spec) < 3:
            return None
        if self.tp in _spec_axes(spec[-1]):
            return "col"
        return "row" if self.tp in _spec_axes(spec[-2]) else None

    def spec(self, name: str):
        return None if self.rules is None else self.rules.get(name)

    def gather(self, x, spec):
        """``x`` gathered over the axes of ``spec`` it must not stay cut
        on, differentiably (the backward reduce-scatters)."""
        if spec is None:
            return x
        if isinstance(spec, dict):
            return {k: self.gather(x[k], spec.get(k)) for k in x}
        for dim, entry in enumerate(spec):
            axes = [a for a in _spec_axes(entry) if self.mesh.size(a) > 1]
            gathered = [a for a in axes if a not in self.keep]
            if gathered and len(gathered) != len(axes):
                raise NotImplementedError(
                    f"spec entry {entry!r} mixes gathered and split axes")
            for a in reversed(gathered):
                x = self.mesh.gather_sum(x, a, dim)
        return x

    def layer(self, layer: dict) -> dict:
        """Layer slices (views of the stacked leaves) with their gathered
        axes gathered: the rules' entries past the layer axis."""
        specs = (self.rules or {}).get("layers")
        if not specs:
            return layer
        return {k: self.gather(v, _drop_layer_axis(specs.get(k)))
                for k, v in layer.items()}

    def split_by(self, name: str) -> bool:
        """Whether a top-level leaf's last axis is split over ``tp``
        (the embedding's ``d_model``, the lm_head's vocabulary)."""
        spec = self.spec(name)
        return (self.tp is not None and spec is not None
                and len(spec) == 2 and self.tp in _spec_axes(spec[-1]))


def _drop_layer_axis(spec):
    if spec is None:
        return None
    if isinstance(spec, dict):
        return {k: _drop_layer_axis(v) for k, v in spec.items()}
    if spec and _spec_axes(spec[0]):
        raise NotImplementedError(f"a spec {spec!r} that splits the "
                                  f"stacked layer axis")
    return P(*spec[1:])


def _tp_linear(x, w, kind, lay, split: bool = False, col_in=None):
    """``x @ w`` for a product of ``kind`` on the ``tp`` axis: returns
    (y, whether y is this rank's columns).  ``x`` is replicated, or
    (``split``) this rank's columns of a column-split product's output;
    ``col_in`` is ``lay.mesh.copy_to(x)`` when the caller shares one
    ``f`` between several column-split products of ``x``."""
    m, tp = lay.mesh, lay.tp
    if kind == "row":
        if not split:
            x = m.scatter_to(x, tp, -1)
        return m.reduce_from(qlinear(x, w), tp), False
    if split:
        x = m.gather_from(x, tp, -1)
    if kind == "col":
        return qlinear(m.copy_to(x, tp) if col_in is None else col_in,
                       w), True
    return qlinear(x, w), False


def tp_heads_split(cfg: TransformerConfig, n_tp: int) -> bool:
    """Whether ``n_tp`` tensor-parallel ranks take the heads split: it
    divides both head counts, so each rank holds whole GQA groups."""
    return cfg.n_heads % n_tp == 0 and cfg.n_kv_heads % n_tp == 0


def _qkv(h, layer, cfg: TransformerConfig, lay: MeshLayout | None):
    """q, k, v (B, S, heads * Dh) of the normed input ``h``, and whether
    they are this rank's heads.  Over ``tp`` (module docstring) the
    column-split products give local heads where ``tp`` divides both
    head counts (:func:`tp_heads_split`); otherwise q, k and v are
    gathered over ``tp`` and every rank attends every head.  Shared by
    the training forward and the cached decode path."""
    if lay is None or lay.tp is None:
        return (*(qlinear(h, layer[n]) for n in ("wq", "wk", "wv")),
                False)
    kinds = [lay.kinds[n] for n in ("wq", "wk", "wv")]
    col_in = lay.mesh.copy_to(h, lay.tp) if "col" in kinds else None
    (q, sq), (k, sk), (v, sv) = (
        _tp_linear(h, layer[n], kd, lay, col_in=col_in)
        for n, kd in zip(("wq", "wk", "wv"), kinds))
    if sq and sk and sv and tp_heads_split(cfg, lay.mesh.size(lay.tp)):
        return q, k, v, True
    q, k, v = (lay.mesh.gather_from(t, lay.tp, -1) if st else t
               for t, st in ((q, sq), (k, sk), (v, sv)))
    return q, k, v, False


def _attn_out(x, o, layer, lay: MeshLayout | None, local: bool):
    """The residual ``x + o @ wo``; over ``tp`` a row-split ``wo`` takes
    this rank's columns of ``o`` (all of them when ``local``) and its
    partial products are summed (Megatron's ``g``)."""
    if lay is None or lay.tp is None:
        return x + qlinear(o, layer["wo"])
    return x + _tp_linear(o, layer["wo"], lay.kinds["wo"], lay, local)[0]


@dataclasses.dataclass(frozen=True)
class SeqParallel:
    """Route the model's attention through sequence parallelism
    (``transformer.py:347``): the ring (``method="ring"``, any head
    count) or Ulysses (``method="ulysses"``, per-``tp``-shard head
    counts divisible by the axis size) over ``mesh``'s ``axis``.
    ``dp_axis`` / ``tp_axis`` name the axes the rows and heads ride,
    each used only if the mesh has it.  ``use_flash=None`` follows
    ``cfg.use_flash``.  Zigzag ring training stays a library-level tool
    (it would permute the loss's next-token shift too).

    In the port the model takes this rank's chunk of the sequence
    (:meth:`chunk`): rank ``i`` of the axis holds positions ``[i*C,
    (i+1)*C)`` of every row."""
    mesh: Any
    axis: str = "sp"
    method: str = "ring"
    use_flash: bool | None = None
    dp_axis: str | None = "dp"
    tp_axis: str | None = "tp"

    def __post_init__(self):
        if self.method not in ("ring", "ulysses"):
            raise ValueError(f"unknown SeqParallel method "
                             f"{self.method!r}; use 'ring' or 'ulysses'")

    def _resolved_axes(self):
        """(batch_axis, head_axis), dropping names absent from mesh."""
        names = set(self.mesh.shape)
        return (self.dp_axis if self.dp_axis in names else None,
                self.tp_axis if self.tp_axis in names else None)

    def chunk(self, x, dim: int = 1):
        """This rank's chunk of ``x``'s sequence dimension ``dim``."""
        return local_slice(x, dim, self.mesh.size(self.axis),
                           self.mesh.index(self.axis), "sequence dimension")

    def positions(self, B: int, C: int, device):
        """The global positions (B, C) of this rank's chunk of C."""
        p = self.mesh.index(self.axis) * C + torch.arange(C, device=device)
        return p.expand(B, C)

    def tp_head(self) -> bool:
        """Whether the mesh has a tp axis of size > 1: the lm_head is
        then vocab-split and the loss keeps the standard tail
        (``transformer.py:612-631``)."""
        return self.tp_axis is not None and self.mesh.size(self.tp_axis) > 1


def _sp_attention(q, k, v, cfg, sp: SeqParallel, segment_ids, local: bool):
    """The ring or Ulysses over ``sp``'s axis on this rank's chunk (and
    its tp heads when ``local``)."""
    from ..parallel.ring import ring_attention
    from ..parallel.ulysses import ulysses_attention
    flash = cfg.use_flash if sp.use_flash is None else sp.use_flash
    batch_axis, head_axis = sp._resolved_axes()
    fn = ulysses_attention if sp.method == "ulysses" else ring_attention
    return fn(q, k, v, sp.mesh, axis=sp.axis, causal=True, use_flash=flash,
              batch_axis=batch_axis, head_axis=head_axis if local else None,
              window=cfg.sliding_window, segment_ids=segment_ids)


def _attention_block(x, layer, cfg: TransformerConfig, positions,
                     segment_ids=None, lay: MeshLayout | None = None,
                     sp: SeqParallel | None = None):
    B, S, _ = x.shape
    Dh = cfg.head_dim
    h = _rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    q, k, v, local = _qkv(h, layer, cfg, lay)
    q = _rope(q.reshape(B, S, -1, Dh), positions, cfg.rope_theta)
    k = _rope(k.reshape(B, S, -1, Dh), positions, cfg.rope_theta)
    v = v.reshape(B, S, -1, Dh)
    with _unsaved():
        if sp is not None:
            o = _sp_attention(q, k, v, cfg, sp, segment_ids, local)
        elif cfg.use_flash:
            o = flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), True, None,
                                cfg.sliding_window, segment_ids)
        else:
            o = attention_reference(q, k, v, causal=True,
                                    window=cfg.sliding_window,
                                    segment_ids=segment_ids)
    return _attn_out(x, o.reshape(B, S, -1), layer, lay, local)


def _mlp_block(x, layer, cfg: TransformerConfig,
               lay: MeshLayout | None = None):
    """The SwiGLU residual block; ``lay`` splits it over ``tp`` by the
    rules (a row-split ``w_down``'s partial products summed)."""
    h = _rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    if lay is not None and lay.tp is not None:
        kg, ku, kd = (lay.kinds[n] for n in ("w_gate", "w_up", "w_down"))
        col_in = lay.mesh.copy_to(h, lay.tp) if "col" in (kg, ku) else None
        a, split = _tp_linear(h, layer["w_gate"], kg, lay, col_in=col_in)
        b, _ = _tp_linear(h, layer["w_up"], ku, lay, col_in=col_in)
        return x + _tp_linear(torch.nn.functional.silu(a) * b,
                              layer["w_down"], kd, lay, split)[0]
    gated = (torch.nn.functional.silu(qlinear(h, layer["w_gate"]))
             * qlinear(h, layer["w_up"]))
    return x + qlinear(gated, layer["w_down"])


# remat_policy="dots" (``transformer.py:462``, ``checkpoint_dots``): a
# layer's matrix products are saved and everything else recomputed.
# JAX saves every dot_general, and its flash kernel, a pallas_call, is
# no dot, so attention re-runs; here the products of attention's plain
# version are einsums too, so attention runs in a scope whose products
# are recomputed, and the CPU and the card keep the same residuals.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)
_scope = threading.local()


@contextlib.contextmanager
def _unsaved():
    """Products inside are recomputed under ``"dots"``."""
    depth = getattr(_scope, "depth", 0)
    _scope.depth = depth + 1
    try:
        yield
    finally:
        _scope.depth = depth


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS and not getattr(_scope, "depth", 0):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _as_tokens(tokens, device) -> torch.Tensor:
    return torch.as_tensor(tokens, dtype=torch.long, device=device)


def make_layer_fn(cfg: TransformerConfig, positions, segment_ids=None,
                  lay: MeshLayout | None = None,
                  sp: SeqParallel | None = None):
    """The per-layer recipe (attention block + MLP block, optionally
    rematerialized with ``torch.utils.checkpoint(use_reentrant=False)``)
    — ``transformer.py:438``.  Returns ``one_layer(x, layer) -> x``.
    ``cfg.remat_policy="dots"`` keeps the outputs of the layer's matrix
    products and recomputes the rest, attention included
    (:func:`_dots_policy`).  ``lay``: on a mesh, each block gathers its
    leaves' gathered axes (:meth:`MeshLayout.layer`) inside its remat
    region.  ``sp``: attention runs sequence-parallel (the recompute
    runs the ring again)."""

    def attn_block(x, layer):
        if lay is not None:
            layer = lay.layer({k: layer[k] for k in
                               ("attn_norm", "wq", "wk", "wv", "wo")})
        return _attention_block(x, layer, cfg, positions, segment_ids, lay,
                                sp)

    def mlp_block(x, layer):
        if lay is not None:
            layer = lay.layer({k: layer[k] for k in
                               ("mlp_norm", "w_gate", "w_up", "w_down")})
        return _mlp_block(x, layer, cfg, lay=lay)

    def one_layer(x, layer):
        return mlp_block(attn_block(x, layer), layer)

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
        saved = functools.partial(create_selective_checkpoint_contexts,
                                  _dots_policy)
        return lambda *args: checkpoint(one_layer, *args,
                                        use_reentrant=False,
                                        context_fn=saved)

    def remat(fn):
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)

    if policy == "attn_only":
        # Recompute the attention block (the flash kernel re-runs off
        # its saved lse); the MLP's d_ff-wide activations stay saved.
        attn = remat(attn_block)
        return lambda x, layer: mlp_block(attn(x, layer), layer)
    if policy == "mlp_only":
        mlp = remat(mlp_block)
        return lambda x, layer: mlp(attn_block(x, layer), layer)
    return remat(one_layer)


def _embed(params: dict, tokens, cfg: TransformerConfig,
           lay: MeshLayout | None = None):
    """The embedding rows of ``tokens`` in ``cfg.dtype``; on a mesh the
    table's gathered axes are gathered first and a ``d_model`` split
    over ``tp`` is gathered after the lookup."""
    if lay is None:
        return params["embed"][tokens].to(cfg.dtype)
    x = lay.gather(params["embed"], lay.spec("embed"))[tokens].to(cfg.dtype)
    return lay.mesh.gather_from(x, lay.tp, -1) if lay.split_by("embed") \
        else x


def _head(x, params: dict, lay: MeshLayout | None = None):
    """Logits (..., V) fp32 of final-norm hidden states ``x``; on a mesh
    a vocabulary split over ``tp`` is gathered (each rank's columns from
    its ``f``-fed shard)."""
    if lay is None:
        return qlinear(x, params["lm_head"]).float()
    w = lay.gather(params["lm_head"], lay.spec("lm_head"))
    if not lay.split_by("lm_head"):
        return qlinear(x, w).float()
    logits = qlinear(lay.mesh.copy_to(x, lay.tp), w).float()
    return lay.mesh.gather_from(logits, lay.tp, -1)


def _layout(mesh, rules, ep_axis: str = "ep") -> MeshLayout | None:
    return None if mesh is None else MeshLayout(mesh, rules, ep_axis)


def _sp_mesh(mesh, sp: SeqParallel | None):
    """The mesh a forward runs on: ``sp``'s when no other is given."""
    if sp is None or mesh is None:
        return mesh if sp is None else sp.mesh
    if mesh is not sp.mesh:
        raise ValueError("mesh= and sp.mesh must be the same mesh")
    return mesh


def _model_inputs(tokens, positions, segment_ids, device, sp):
    """tokens, positions and segment ids as long tensors on ``device``;
    positions default to ``arange(S)``, or under ``sp`` to the chunk's
    global positions."""
    tokens = _as_tokens(tokens, device)
    B, S = tokens.shape
    if positions is not None:
        positions = _as_tokens(positions, device)
    elif sp is not None:
        positions = sp.positions(B, S, device)
    else:
        positions = torch.arange(S, device=device).expand(B, S)
    if segment_ids is not None:
        segment_ids = _as_tokens(segment_ids, device)
    return tokens, positions, segment_ids


def forward_hidden(params: dict, tokens, cfg: TransformerConfig,
                   positions=None, *, segment_ids=None, mesh=None,
                   rules=None, sp: SeqParallel | None = None):
    """tokens: (B, S) int -> final-norm hidden states (B, S, D) in
    ``cfg.dtype``, on the parameters' device.  Differentiable in the
    parameters.  ``mesh``/``rules``: this rank's rows of the batch and
    its shard of a tree cut by ``rules`` (module docstring).  ``sp``:
    ``tokens`` (and ``positions``, ``segment_ids``) are this rank's
    chunk of the sequence; positions default to the chunk's global
    ones."""
    mesh = _sp_mesh(mesh, sp)
    lay = _layout(mesh, rules)
    device = params["embed"].device
    tokens, positions, segment_ids = _model_inputs(tokens, positions,
                                                   segment_ids, device, sp)
    x = _embed(params, tokens, cfg, lay)
    one_layer = make_layer_fn(cfg, positions, segment_ids, lay, sp)
    for layer in layer_slices(params):
        x = one_layer(x, layer)
    norm = params["final_norm"] if lay is None else \
        lay.gather(params["final_norm"], lay.spec("final_norm"))
    return _rms_norm(x, norm, cfg.norm_eps)


def forward(params: dict, tokens, cfg: TransformerConfig, positions=None,
            *, segment_ids=None, mesh=None, rules=None,
            sp: SeqParallel | None = None):
    """tokens: (B, S) int -> logits (B, S, vocab) fp32.  Runs where the
    parameters live (:func:`init_params` puts them on the GPU unless
    asked for the CPU).  On a mesh: this rank's rows, every vocabulary
    column; with ``sp``, this rank's chunk of the sequence."""
    x = forward_hidden(params, tokens, cfg, positions,
                       segment_ids=segment_ids, mesh=mesh, rules=rules, sp=sp)
    return _head(x, params, _layout(_sp_mesh(mesh, sp), rules))


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


def dp_loss_scale(segment_ids, mesh, dp_axis: str = "dp"):
    """The factor that turns this rank's mean over its kept targets into
    its loss on a mesh: ``n_dp · kept / Σ_dp kept``, so the mean of the
    ranks' losses over ``dp_axis`` is the mean over every kept target of
    the batch (``shifted_xent``'s, ``transformer.py:532``), however the
    packed documents fall.  1 (no collective) without segments, where
    every rank keeps the same count."""
    n = 1 if mesh is None else mesh.size(dp_axis)
    if segment_ids is None or n == 1:
        return 1.0
    kept = (segment_ids[:, :-1] == segment_ids[:, 1:]).sum().float()
    total = mesh.psum(kept, dp_axis)
    return n * kept.clamp(min=1) / total.clamp(min=1)


def _chunked_tail(cfg, params, lay: MeshLayout | None,
                  sp: SeqParallel | None = None) -> bool:
    """Whether the chunked-vocab tail runs: ``cfg.ce_chunk`` on a plain
    lm_head, not split over ``tp`` — a vocab-split head takes the
    standard tail with a warning, or silently under an ``sp`` whose mesh
    has a tp axis (``transformer.py:612-631``)."""
    head = params["lm_head"]
    if (cfg.ce_chunk is None or is_quantized(head)
            or is_quantized4(head) or (sp is not None and sp.tp_head())):
        return False
    if lay is not None and lay.split_by("lm_head"):
        import warnings
        warnings.warn(
            "ce_chunk ignored: lm_head is vocab-sharded (plain tensor "
            "parallelism); using the standard tp-sharded tail instead",
            stacklevel=3)
        return False
    return True


def _sp_inputs(batch: dict, sp: SeqParallel, device) -> dict:
    """This rank's chunk of a batch of whole rows under ``sp``: the
    packed positions and the next-token targets are computed on the whole
    row, then cut — so a document that starts on an earlier rank
    restarts RoPE there, and a chunk's last position predicts the next
    chunk's first token.  Returns tokens, positions, segments (or None),
    targets and keep (the targets that count: not the row's last
    position, not a document boundary), each (B, C), and ``kept``, the
    count of kept targets of the whole rows."""
    tokens = _as_tokens(batch["tokens"], device)
    seg = batch.get("segments") if isinstance(batch, dict) else None
    B, S = tokens.shape
    keep = torch.ones((B, S), dtype=torch.bool, device=device)
    keep[:, -1] = False
    if seg is not None:
        seg = _as_tokens(seg, device)
        positions = packed_positions(seg)
        keep[:, :-1] = seg[:, :-1] == seg[:, 1:]
    else:
        positions = torch.arange(S, device=device).expand(B, S)
    targets = torch.roll(tokens, -1, dims=1)
    return dict(tokens=sp.chunk(tokens), positions=sp.chunk(positions),
                segments=None if seg is None else sp.chunk(seg),
                targets=sp.chunk(targets), keep=sp.chunk(keep),
                kept=keep.sum())


def _sp_xent(nll_sum, kept, sp: SeqParallel, mesh, dp_axis: str):
    """This rank's loss under ``sp`` (module docstring): its chunk's
    summed NLL over the kept targets of every rank's rows, times the
    number of ranks splitting the batch (``dp_axis`` and ``sp``), so the
    mean over those ranks is the whole batch's mean however the
    documents fall."""
    total = mesh.psum(kept.float(), dp_axis)
    n = mesh.size(dp_axis) * mesh.size(sp.axis)
    return n * nll_sum / total.clamp(min=1)


def _sp_nll_sum(hidden, params, lay, inp, chunk=None) -> torch.Tensor:
    """Σ NLL over the chunk's kept targets: by the chunked-vocab tail
    in blocks of ``chunk`` columns, or (None) by the standard one."""
    keep = inp["keep"]
    if chunk is not None:
        head = params["lm_head"] if lay is None else \
            lay.gather(params["lm_head"], lay.spec("lm_head"))
        D = hidden.shape[-1]
        mean = chunked_softmax_xent(hidden.reshape(-1, D), head,
                                    inp["targets"].reshape(-1),
                                    keep.reshape(-1), chunk)
        return mean * keep.sum().clamp(min=1)
    logp = torch.log_softmax(_head(hidden, params, lay), dim=-1)
    nll = -logp.gather(-1, inp["targets"][..., None])[..., 0]
    return torch.where(keep, nll, 0.0).sum()


def loss_fn(params: dict, batch: dict, cfg: TransformerConfig, *,
            mesh=None, rules=None, dp_axis: str = "dp",
            sp: SeqParallel | None = None):
    """Next-token cross-entropy of ``batch["tokens"]`` (B, S): the
    forward runs on all S tokens and the logits are shifted
    (``transformer.py:593``).  ``batch["segments"]`` (optional, (B, S)):
    packed documents — attention stays inside each document, RoPE
    positions restart per document, boundary targets drop.  With
    ``cfg.ce_chunk`` the loss takes the chunked-vocab tail and the
    (B, S, V) logits never exist.

    ``mesh``/``rules``: ``batch`` is this rank's rows over ``dp_axis``
    (``parallel.mesh.shard_batch``) and ``params`` its shard of a tree
    cut by ``rules``.  The result is this rank's loss, as in DDP: its
    mean over ``dp_axis`` is the whole batch's loss
    (:func:`dp_loss_scale`), and the mean of the ranks' gradients the
    whole batch's; the train step takes the same ``dp_axis``.

    ``sp`` (:class:`SeqParallel`): ``batch`` holds whole rows (this
    rank's over ``dp_axis``); this rank forwards its chunk of them
    (:func:`_sp_inputs`) and returns its share of the batch's mean times
    the ranks over ``dp_axis`` and ``sp`` (:func:`_sp_xent`)."""
    mesh = _sp_mesh(mesh, sp)
    lay = _layout(mesh, rules)
    device = params["embed"].device
    if sp is not None:
        inp = _sp_inputs(batch, sp, device)
        hidden = forward_hidden(params, inp["tokens"], cfg, inp["positions"],
                                segment_ids=inp["segments"], mesh=mesh,
                                rules=rules, sp=sp)
        chunk = (cfg.ce_chunk if _chunked_tail(cfg, params, lay, sp)
                 else None)
        return _sp_xent(_sp_nll_sum(hidden, params, lay, inp, chunk),
                       inp["kept"], sp, mesh, dp_axis)
    tokens = _as_tokens(batch["tokens"], device)
    seg = batch.get("segments")
    positions = None
    if seg is not None:
        seg = _as_tokens(seg, device)
        positions = packed_positions(seg)
    hidden = forward_hidden(params, tokens, cfg, positions, segment_ids=seg,
                            mesh=mesh, rules=rules)
    scale = dp_loss_scale(seg, mesh, dp_axis)
    if _chunked_tail(cfg, params, lay):
        head = params["lm_head"] if lay is None else \
            lay.gather(params["lm_head"], lay.spec("lm_head"))
        return scale * shifted_chunked_xent(hidden, head, tokens,
                                            segment_ids=seg,
                                            chunk=cfg.ce_chunk)
    return scale * shifted_xent(_head(hidden, params, lay), tokens,
                                segment_ids=seg)


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
    stepped in bf16 arithmetic.  Leaves are updated in place, in slices
    of ``CHUNK`` elements: every operation is elementwise, so the
    numbers are the whole leaf's, and the fp32 temporaries stay one
    slice's size (a Mixtral expert leaf is 0.9 GB in fp32)."""

    CHUNK = 1 << 24

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
                for p_, g_, mu_, nu_ in _slices(
                        self.CHUNK, p, p.grad, st["mu"], st["nu"]):
                    g = g_.float()
                    mu = mu_.float() * b1 + (1 - b1) * g
                    nu = nu_.float() * b2 + (1 - b2) * (g * g)
                    # Stored in the leaf's dtype, then used as stored.
                    mu = mu_.copy_(mu).float()
                    nu = nu_.copy_(nu).float()
                    mu_hat = mu / (1 - b1 ** t)
                    nu_hat = nu / (1 - b2 ** t)
                    u = mu_hat / (nu_hat.sqrt() + eps) + wd * p_.float()
                    _apply_update(p_, -lr * u)


def _slices(n: int, *ts):
    """Matching flat slices of ``n`` elements of same-shaped tensors
    (views, so writes land in the tensors); the tensors whole if any of
    them is not contiguous."""
    if not all(t.is_contiguous() for t in ts):
        return [ts]
    flat = [t.view(-1) for t in ts]
    return zip(*(f.split(n) for f in flat))


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
        with maybe_span("train/forward"):
            loss = loss_of(*args)
        with maybe_span("train/backward"):
            loss.backward()
        with maybe_span("train/optimizer"):
            optimizer.step()
        return loss.detach()

    return step


def make_train_step(cfg: TransformerConfig, optimizer,
                    sp: SeqParallel | None = None, *, rules=None):
    """Returns ``step(params, batch) -> loss``: :func:`loss_fn`, its
    gradients by autograd (through K2/K3 when ``cfg.use_flash``) and
    one ``optimizer`` step, which updates ``params`` in place (the
    counterpart of ``transformer.py:665``, whose step returns new
    params and optimizer state instead).  ``optimizer`` holds the
    leaves of ``params`` (e.g. ``AdamW(param_leaves(params), lr)``);
    they are made to require grad.  The loss comes back detached.

    ``sp``: attention runs sequence-parallel on ``sp.mesh``; ``params``
    is this rank's shard of a tree cut by ``rules`` (None: whole),
    ``batch`` its rows over ``sp``'s dp axis, whole rows
    (``parallel.mesh.shard_batch``), and the step is
    :func:`..parallel.tensor_parallel.make_tp_train_step` reducing over
    that dp axis and ``sp.axis``; the loss returned is the batch's."""
    if sp is None:
        if rules is not None:
            raise ValueError("rules= cuts a tree over a mesh: give sp=, or "
                             "use parallel.tensor_parallel."
                             "make_tp_train_step")
        return _optimizer_step(
            optimizer, lambda params, batch: loss_fn(params, batch, cfg))
    from ..parallel.tensor_parallel import make_tp_train_step
    dp = sp._resolved_axes()[0] or "dp"
    return make_tp_train_step(
        lambda params, batch: loss_fn(params, batch, cfg, rules=rules,
                                      dp_axis=dp, sp=sp),
        optimizer, sp.mesh, rules, dp_axis=dp, sp_axis=sp.axis)


def num_tokens_per_step(batch_shape) -> int:
    return math.prod(batch_shape)
