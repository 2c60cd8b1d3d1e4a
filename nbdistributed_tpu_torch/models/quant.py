"""Weight-only int8 / int4 quantization for inference (counterpart of
``nbdistributed_tpu/models/quant.py``, dense family on one device).

* int8: symmetric per-output-channel scales, ``W ≈ q8 * s`` with
  ``s[o] = max|W[:, o]| / 127``; a targeted weight becomes
  ``{"q8": int8 (..., d_in, d_out), "s": fp32 (..., 1, d_out)}``.  The
  same quantizer serves the int8 KV cache (``axis=-1``).
* int4: per-(group, output-channel) scales over ``group`` contraction
  rows, two weights per byte along the contraction axis:
  ``{"q4": uint8 (..., d_in/2, d_out), "s": fp32 (..., G, 1, d_out)}``
  with ``G = d_in // group``.

The model's products dispatch on the leaf kind in
:func:`.transformer.qlinear` (the MoE experts' in
``parallel/expert.py``), so one forward serves plain and quantized
trees.  :func:`quantized_shardings`, :func:`quantized_shardings4` and
:func:`quantized_moe_shardings` map a tree's mesh rules onto its
quantized leaves (``parallel/tensor_parallel.apply_shardings`` places
them; an int4 leaf split on its rows gets its scales re-cut there).
"""

from __future__ import annotations

import torch

from ..parallel.mesh import P
from .lora import ATTN_TARGETS
from .transformer import (_pack_nibbles, _unpack_nibbles, is_quantized,
                          is_quantized4)

# Weights worth quantizing: all the big products.  Norm gains stay
# fp32; the embedding is a gather and stays in the model dtype.
DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
EXPERT_TARGETS = ("w_gate", "w_up", "w_down")


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


def quantize_weight4(w, *, group: int = 64) -> dict:
    """Symmetric per-(group, output-channel) int4 quantization
    (``quant.py:84``)."""
    wf = w.float()
    d_in = wf.shape[-2]
    if d_in % group or group % 2:
        raise ValueError(f"group {group} must be even and divide "
                         f"d_in {d_in}")
    wg = wf.reshape(*wf.shape[:-2], d_in // group, group, wf.shape[-1])
    amax = wg.abs().amax(dim=-2, keepdim=True)
    s = torch.clamp(amax, min=1e-8) / 7.0
    q = torch.clamp(torch.round(wg / s), -7, 7).to(torch.int32)
    return {"q4": _pack_nibbles(q.reshape(wf.shape)), "s": s}


def dequantize_weight4(qw: dict, dtype=torch.float32):
    q = _unpack_nibbles(qw["q4"], torch.float32)
    s = qw["s"]
    G, d_in = s.shape[-3], q.shape[-2]
    wg = q.reshape(*q.shape[:-2], G, d_in // G, q.shape[-1]) * s
    return wg.reshape(*q.shape[:-2], d_in, q.shape[-1]).to(dtype)


def _map_targets(tree: dict, leaf_fn, targets,
                 include_lm_head: bool) -> dict:
    """Apply ``leaf_fn`` to the targeted ``layers`` weights (and
    optionally ``lm_head``); everything else passes through by
    reference (``quant.py:137``)."""
    layers = dict(tree["layers"])
    for name in targets:
        if name not in layers:
            raise ValueError(f"unknown quantization target {name!r}; "
                             f"layer weights: {sorted(tree['layers'])}")
        layers[name] = leaf_fn(layers[name])
    out = dict(tree)
    out["layers"] = layers
    if include_lm_head:
        out["lm_head"] = leaf_fn(tree["lm_head"])
    return out


def _q_spec(spec: P) -> dict:
    """Specs of an int8 leaf: ``q8`` keeps the weight's; ``s`` ((...,
    1, d_out)) keeps the leading and output entries, its size-1
    contraction entry whole (``quant.py:171``)."""
    return {"q8": spec, "s": P(*spec[:-2], None, spec[-1])}


def _q_spec4(spec: P) -> dict:
    """Specs of an int4 leaf: the packed array keeps the weight's (the
    packing halves the contraction extent, not its split); the grouped
    scales ((..., G, 1, d_out)) keep the output entry and stay whole
    over the contraction, which G need not divide (``quant.py:120``)."""
    return {"q4": spec, "s": P(*spec[:-2], None, None, spec[-1])}


def quantized_shardings(rules: dict, targets=DEFAULT_TARGETS,
                        quantize_lm_head: bool = True) -> dict:
    """A tree's rules mapped onto its :func:`quantize_params` form;
    ``targets``/``quantize_lm_head`` must be the ones quantized."""
    return _map_targets(rules, _q_spec, targets, quantize_lm_head)


def quantized_shardings4(rules: dict, targets=DEFAULT_TARGETS,
                         quantize_lm_head: bool = True) -> dict:
    """The rules of a :func:`quantize_params4` tree."""
    return _map_targets(rules, _q_spec4, targets, quantize_lm_head)


def quantize_params(params: dict, targets=DEFAULT_TARGETS,
                    quantize_lm_head: bool = True) -> dict:
    """Params with the targeted per-layer weights (and optionally
    ``lm_head``) replaced by int8 ``{"q8", "s"}`` leaves."""
    return _map_targets(params, quantize_weight, targets, quantize_lm_head)


def quantize_params4(params: dict, targets=DEFAULT_TARGETS,
                     quantize_lm_head: bool = True,
                     group: int = 64) -> dict:
    """The int4 variant of :func:`quantize_params` (``{"q4", "s"}``
    leaves)."""
    return _map_targets(params,
                        lambda w: quantize_weight4(w, group=group),
                        targets, quantize_lm_head)


def quantize_moe_params(params: dict, quantize_lm_head: bool = True) -> dict:
    """MoE variant (``quant.py:184``): the attention projections and the
    expert SwiGLU weights go int8, the router stays fp32."""
    out = quantize_params(params, targets=ATTN_TARGETS,
                          quantize_lm_head=quantize_lm_head)
    moe = dict(out["layers"]["moe"])
    for name in EXPERT_TARGETS:
        moe[name] = quantize_weight(moe[name])
    out["layers"]["moe"] = moe
    return out


def quantized_moe_shardings(rules: dict,
                            quantize_lm_head: bool = True) -> dict:
    """The rules of a :func:`quantize_moe_params` tree (``quant.py:200``):
    the attention weights' and the experts' leaves mapped as
    :func:`quantized_shardings` maps them."""
    out = quantized_shardings(rules, targets=ATTN_TARGETS,
                              quantize_lm_head=quantize_lm_head)
    moe = dict(out["layers"]["moe"])
    for name in EXPERT_TARGETS:
        moe[name] = _q_spec(moe[name])
    out["layers"] = {**out["layers"], "moe": moe}
    return out


def quantization_error(params: dict, qparams: dict) -> dict:
    """Relative Frobenius error of each quantized weight
    (``quant.py:214``), keyed by its name: a nested group's weights as
    ``"moe.w_gate"``, the head as ``"lm_head"``."""

    def rel(w, qw):
        deq = (dequantize_weight4(qw) if is_quantized4(qw)
               else dequantize_weight(qw))
        wf = w.float()
        return float(torch.linalg.norm(deq - wf) / torch.linalg.norm(wf))

    report = {}

    def walk(prefix, ref, tree):
        for name, leaf in tree.items():
            if is_quantized(leaf) or is_quantized4(leaf):
                report[prefix + name] = rel(ref[name], leaf)
            elif isinstance(leaf, dict):
                walk(prefix + name + ".", ref[name], leaf)

    walk("", params["layers"], qparams["layers"])
    head = qparams.get("lm_head")
    if is_quantized(head) or is_quantized4(head):
        report["lm_head"] = rel(params["lm_head"], head)
    return report
