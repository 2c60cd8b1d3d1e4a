"""Mixture-of-experts routing and the SwiGLU expert layer on one device
(counterpart of ``nbdistributed_tpu/parallel/expert.py``).

Routing is the GShard/Switch recipe with a fixed per-expert capacity C:
softmax over the router's fp32 logits, a normalized top-k, and a
choice-major priority (every token's first choice outranks any token's
second), so over-capacity tokens drop and pass through the residual.
Three dispatch modes reach the ``(E, C, D)`` capacity buffer or skip it:

* ``"dense"``: one-hot dispatch/combine einsums (the oracle; no host
  read, deterministic on the GPU);
* ``"sparse"``: a stable sort of the (token, choice) pairs by expert,
  rows moved by gather and scatter-add — the same drops, bit for bit;
* ``"dropless"``: no capacity; the SwiGLU runs as one product per
  expert over its contiguous segment of the sorted rows.  The segment
  sizes are read on the host once per layer call
  (``_dropless_ffn.host_reads`` counts the reads).

Every op here is a PyTorch op, as every op of the JAX module is an XLA
op (``jax.lax.ragged_dot`` included): there is no Pallas kernel to
port.  One-hots are built by comparison (``jax.nn.one_hot`` gives a zero
row for an index out of range, where ``torch.nn.functional.one_hot``
raises), and the top-k is a stable sort, so tied probabilities pick the
lowest expert index as ``jax.lax.top_k`` does.  Expert parallelism over
an ``ep`` mesh axis waits for the process group (ROADMAP A5a, then A2).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import fan_in_normal

_MESH_TODO = ("expert parallelism over an ep mesh axis needs the port's "
              "process group (ROADMAP A5a, then A2)")


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int,
                    n_experts: int, dtype=torch.bfloat16) -> dict:
    """Router + stacked SwiGLU expert weights (leading E axis), drawn
    from ``generator`` on its device: the router fp32 ``N(0, 0.02²)``,
    the experts fan-in normal in ``dtype`` (``expert.py:29``)."""
    E, D, Fd = n_experts, d_model, d_ff
    router = torch.randn((D, E), generator=generator,
                         device=generator.device, dtype=torch.float32) * 0.02
    return {"router": router,
            "w_gate": fan_in_normal(generator, (E, D, Fd), D, dtype),
            "w_up": fan_in_normal(generator, (E, D, Fd), D, dtype),
            "w_down": fan_in_normal(generator, (E, Fd, D), Fd, dtype)}


def moe_param_shardings(*args, **kwargs):
    raise NotImplementedError(f"moe_param_shardings: {_MESH_TODO}")


def compute_capacity(num_tokens: int, n_experts: int, top_k: int,
                     capacity_factor: float) -> int:
    """Per-expert token capacity C, a multiple of 8 and at least 8."""
    cap = int(capacity_factor * top_k * num_tokens / n_experts)
    return max(8, -(-cap // 8) * 8)


def _one_hot(idx, n: int):
    """``jax.nn.one_hot`` in fp32: an index outside [0, n) gives a zero
    row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def top_k_routing(logits, top_k: int):
    """Normalized top-k gates.  logits (T, E) -> gates (T, k) fp32,
    expert_idx (T, k) long, probs (T, E) fp32.  A stable descending
    sort breaks ties toward the lower expert index."""
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, expert_idx = vals[:, :top_k], idx[:, :top_k]
    return gates / gates.sum(dim=-1, keepdim=True), expert_idx, probs


def make_dispatch(gates, expert_idx, n_experts: int, capacity: int,
                  token_mask=None):
    """Dense dispatch (T, E, C) {0, 1} and combine (T, E, C) = dispatch ·
    gate (``expert.py:81``).  A (token, choice)'s slot is its cumulative
    count in choice-major order; a slot at or past ``capacity`` drops.
    Tokens masked out by ``token_mask`` (T,) bool take no slot."""
    T, k = expert_idx.shape
    onehot = _one_hot(expert_idx, n_experts)                    # (T, k, E)
    if token_mask is not None:
        onehot = onehot * token_mask.float()[:, None, None]
    flat = onehot.transpose(0, 1).reshape(k * T, n_experts)
    pos = torch.cumsum(flat, dim=0) - flat                      # (k*T, E)
    pos = pos.reshape(k, T, n_experts).transpose(0, 1)          # (T, k, E)
    keep = onehot * (pos < capacity)
    slot = _one_hot(pos.long(), capacity) * keep[..., None]     # (T,k,E,C)
    return slot.sum(dim=1), (slot * gates[:, :, None, None]).sum(dim=1)


def load_balance_loss(probs, expert_idx, n_experts: int, token_mask=None):
    """Switch auxiliary loss ``E · Σ_e f_e · P_e`` over the first choices
    and the mean router probabilities, masked tokens excluded from both
    means (``expert.py:110``)."""
    first = _one_hot(expert_idx[:, 0], n_experts)
    if token_mask is None:
        f, p = first.mean(dim=0), probs.mean(dim=0)
    else:
        m = token_mask.float()[:, None]
        n = torch.clamp(m.sum(), min=1.0)
        f, p = (first * m).sum(dim=0) / n, (probs * m).sum(dim=0) / n
    return n_experts * (f * p).sum()


def _route_sort(expert_idx, E: int, token_mask=None):
    """The (T, k) choices flattened choice-major, masked tokens relabeled
    to the sentinel expert E, stable-sorted by expert.  Returns (order,
    e_sorted, tok, counts): the argsort, the sorted expert ids, each
    sorted row's token and the per-expert counts, sentinel bin last
    (counted on the device, without ``bincount``'s host read)."""
    T, k = expert_idx.shape
    flat_e = expert_idx.transpose(0, 1).reshape(-1)
    if token_mask is not None:
        flat_e = torch.where(token_mask.repeat(k), flat_e, E)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.zeros(E + 1, dtype=torch.long, device=flat_e.device)
    counts.index_add_(0, flat_e, torch.ones_like(flat_e))
    return order, flat_e[order], order % T, counts


def sparse_slots(expert_idx, E: int, C: int, token_mask=None):
    """Sort/segment routing with :func:`make_dispatch`'s priority and
    drops (``expert.py:351``).  Returns, in sorted order: ``slot`` (kT,)
    into the flat (E*C,) buffer (E*C for dropped and masked entries),
    ``tok``, ``keep`` and ``order``."""
    order, e_sorted, tok, counts = _route_sort(expert_idx, E, token_mask)
    starts = torch.cumsum(counts, dim=0) - counts
    pos = torch.arange(e_sorted.shape[0], device=e_sorted.device) \
        - starts[e_sorted]
    keep = (pos < C) & (e_sorted < E)
    slot = torch.where(keep, e_sorted * C + pos, E * C)
    return slot, tok, keep, order


def _segment_linear(xs, w, sizes):
    """``jax.lax.ragged_dot``: the rows of each expert's contiguous
    segment times that expert's weight (plain or int8 leaf)."""
    from ..models.transformer import _slice_layer, qlinear
    return torch.cat([qlinear(part, _slice_layer(w, e))
                      for e, part in enumerate(torch.split(xs, sizes))])


def _dropless_ffn(xt, params, gates, expert_idx, E: int, token_mask=None):
    """MegaBlocks-style dropless experts (``expert.py:176``): every routed
    (token, choice) is computed, one product per expert over its segment
    of the sorted rows.  The segment sizes are read on the host once
    (counted in ``_dropless_ffn.host_reads``); masked tokens sort past
    every real segment and are never computed."""
    T, D = xt.shape
    order, e_sorted, tok, counts = _route_sort(expert_idx, E, token_mask)
    sizes = counts[:E].tolist()
    _dropless_ffn.host_reads += 1
    n = sum(sizes)
    tok, order = tok[:n], order[:n]
    xs = xt[tok]
    h = (F.silu(_segment_linear(xs, params["w_gate"], sizes))
         * _segment_linear(xs, params["w_up"], sizes))
    rows = _segment_linear(h, params["w_down"], sizes)          # (n, D)
    g = gates.transpose(0, 1).reshape(-1)[order].to(xt.dtype)
    return torch.zeros((T, D), dtype=xt.dtype, device=xt.device).index_add(
        0, tok, rows * g[:, None])


_dropless_ffn.host_reads = 0


def _dropless_ffn_ep(*args, **kwargs):
    raise NotImplementedError(f"_dropless_ffn_ep: {_MESH_TODO}")


def moe_ffn(x, params: dict, *, top_k: int = 2,
            capacity_factor: float = 1.25, mesh=None, ep_axis: str = "ep",
            dispatch_mode: str = "dense", token_mask=None,
            capacity: int | None = None):
    """Mixture-of-experts SwiGLU feed-forward (``expert.py:377``).

    x (..., D) -> (same shape, aux scalar fp32).  ``dispatch_mode`` is
    ``"dense"``, ``"sparse"`` or ``"dropless"`` (module docstring).
    ``token_mask`` (bool, ``x.shape[:-1]``): masked tokens give zero
    output, take no capacity slot and leave the aux loss alone; C still
    counts every row of ``x``, masked or not.  ``capacity`` overrides
    the ``capacity_factor`` formula.  Differentiable in ``x`` and the
    parameters: gradients reach the gates and the router probabilities,
    never the routing indices."""
    if dispatch_mode not in ("dense", "sparse", "dropless"):
        raise ValueError(f"unknown dispatch_mode {dispatch_mode!r}")
    if mesh is not None:
        raise NotImplementedError(f"mesh: {_MESH_TODO}")
    # The expert products are batched over E: ``qlinear`` takes the
    # plain (E, d_in, d_out) weights and int8 leaves, whose per-(expert,
    # output-channel) scales commute with the product.
    from ..models.transformer import qlinear
    orig_shape = x.shape
    D = orig_shape[-1]
    xt = x.reshape(-1, D)
    T = xt.shape[0]
    E = params["router"].shape[-1]
    C = (capacity if capacity is not None
         else compute_capacity(T, E, top_k, capacity_factor))
    mask_t = None if token_mask is None else token_mask.reshape(-1)

    logits = xt.float() @ params["router"]
    gates, expert_idx, probs = top_k_routing(logits, top_k)
    aux = load_balance_loss(probs, expert_idx, E, token_mask=mask_t)

    if dispatch_mode == "dropless":
        y = _dropless_ffn(xt, params, gates, expert_idx, E,
                          token_mask=mask_t)
        return y.reshape(orig_shape), aux

    if dispatch_mode == "sparse":
        slot, tok, keep, order = sparse_slots(expert_idx, E, C,
                                              token_mask=mask_t)
        # Row E*C is the trash row of dropped and masked entries.
        buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=x.device)
        xe = buf.index_copy(0, slot, xt[tok])[:E * C].reshape(E, C, D)
    else:
        dispatch, combine = make_dispatch(gates, expert_idx, E, C,
                                          token_mask=mask_t)
        xe = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), xt)
    h = (F.silu(qlinear(xe, params["w_gate"]))
         * qlinear(xe, params["w_up"]))
    ye = qlinear(h, params["w_down"])                           # (E, C, D)
    if dispatch_mode == "sparse":
        g = torch.where(keep, gates.transpose(0, 1).reshape(-1)[order],
                        0.0).to(x.dtype)
        # Dropped entries read the zero row past the buffer.
        rows = torch.cat([ye.reshape(E * C, D),
                          ye.new_zeros((1, D))])[slot]
        y = torch.zeros((T, D), dtype=x.dtype, device=x.device).index_add(
            0, tok, rows * g[:, None])
    else:
        y = torch.einsum("tec,ecd->td", combine.to(x.dtype), ye)
    return y.reshape(orig_shape), aux
