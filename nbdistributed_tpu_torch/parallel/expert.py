"""Mixture-of-experts routing and the SwiGLU expert layer (counterpart
of ``nbdistributed_tpu/parallel/expert.py``).

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
lowest expert index as ``jax.lax.top_k`` does.

**On a mesh** (:mod:`.mesh`), ``x`` holds this rank's block of the
tokens, split over ``token_axes`` (default ``dp``) and replicated over
the rest, and the experts are split over ``ep``
(:func:`moe_param_shardings`): each rank computes its E/ep experts'
share and one ``psum`` over ``ep`` sums them.  The ``dense`` and
``sparse`` modes route every token of the batch together, as the JAX
layer does (capacity and priority are global), so a token-split batch
is gathered first and each rank keeps its own rows of the result.
``dropless`` over ``ep`` is the hierarchical shard-capacity path
(:func:`_dropless_ffn_ep`): routing on each rank's own token block,
its experts' rows cut at a pooled shard capacity.

Under sequence parallelism (``seq_axis``) ``x`` is this rank's chunk
(B, C, D) of its rows' sequences.  The tokens JAX routes together are
those of the flattened ``b*S + s`` order, which a chunk is not part of
contiguously: ``dense`` and ``sparse`` gather the whole rows over the
axis (capacity and priority stay the batch's), and dropless over
``ep`` routes JAX's token blocks, the flattened rows cut over the axis
(a rank's chunk when it holds one row; otherwise the rows are gathered,
the block routed and the output gathered back).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import fan_in_normal
from .mesh import P, local_slice, spec_split


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


def moe_param_shardings(ep_axis: str = "ep", tp_axis: str | None = None,
                        leading=()) -> dict:
    """Rules for :func:`init_moe_params` trees (``expert.py:49``): the
    experts split over ``ep_axis`` (their ffn dim over ``tp_axis`` too,
    if given), the router whole; ``leading`` prefixes the entries of
    extra leading axes (the models' (n_layers,))."""
    lead = tuple(leading)
    return {"router": P(*lead, None, None),
            "w_gate": P(*lead, ep_axis, None, tp_axis),
            "w_up": P(*lead, ep_axis, None, tp_axis),
            "w_down": P(*lead, ep_axis, tp_axis, None)}


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


def _local_experts(params: dict, E: int, mesh, ep_axis: str):
    """(w_gate, w_up, w_down, first expert, E_loc) of this rank's
    experts on the ``ep`` axis.  A tree split by
    :func:`moe_param_shardings` already holds them; a whole tree is cut
    here (the layout read from the leaf's shape, as GSPMD reads it from
    the array's)."""
    from ..models.transformer import _slice_layer
    n_ep = mesh.size(ep_axis)
    if E % n_ep:
        raise ValueError(f"n_experts {E} not divisible by ep axis "
                         f"size {n_ep}")
    E_loc, lo = E // n_ep, mesh.index(ep_axis) * (E // n_ep)
    ws = []
    for name in ("w_gate", "w_up", "w_down"):
        w = params[name]
        n = (w["q8"] if isinstance(w, dict) else w).shape[0]
        if n == E and n_ep > 1:
            w = _slice_layer(w, slice(lo, lo + E_loc))
        elif n != E_loc:
            raise ValueError(f"{name} holds {n} experts; the {ep_axis} "
                             f"axis gives this rank {E_loc} of {E}")
        ws.append(w)
    return (*ws, lo, E_loc)


def _dropless_ffn_ep(xt, params, logits, top_k: int, E: int, mesh,
                     ep_axis: str, capacity_factor: float,
                     token_mask=None, capacity: int | None = None,
                     blocks: int = 1):
    """Expert-parallel dropless (``expert.py:207``): this rank routes its
    own token block ``xt`` (T_loc, D) by its router ``logits``, takes
    the rows routed to its E/ep experts — contiguous in the expert-
    sorted order — up to a pooled shard capacity ``Cs =
    compute_capacity(T_loc, ep, k, cf)`` (an explicit per-expert
    ``capacity`` pools to ``E_loc * capacity``), capped at ``k *
    T_loc``, runs each local expert over its segment, and one ``psum``
    over ``ep`` combines the shards.  Rows past ``Cs`` are the sorted
    tail of the shard's segment, and drop.  ``blocks`` > 1 routes the
    tokens as that many contiguous blocks, each with its own ``Cs`` (a
    rank holding the rows of several ``dp`` shards routes them as the
    JAX layer's token shards).  The segment sizes are read on the host
    once per block (``_dropless_ffn.host_reads``).

    Differentiable: the gates and the expert inputs enter through
    Megatron's ``f`` over ``ep`` (each rank's experts give only their
    share of their cotangents) and the combine is its ``g``."""
    T, D = xt.shape
    k = top_k
    wg, wu, wd, lo, E_loc = _local_experts(params, E, mesh, ep_axis)
    n_ep = mesh.size(ep_axis)
    if blocks < 1 or T % blocks:
        blocks = 1
    Tb = T // blocks
    Cs = (E_loc * capacity if capacity is not None
          else compute_capacity(Tb, n_ep, k, capacity_factor))
    Cs = min(Cs, k * Tb)
    xe = mesh.copy_to(xt, ep_axis)
    ys = []
    for b in range(blocks):
        rows = slice(b * Tb, (b + 1) * Tb)
        gates, expert_idx, _ = top_k_routing(logits[rows], k)
        gates = mesh.copy_to(gates, ep_axis)
        mask = None if token_mask is None else token_mask[rows]
        order, _, tok, counts = _route_sort(expert_idx, E, mask)
        cnt = counts[:E].tolist()
        _dropless_ffn.host_reads += 1
        start = sum(cnt[:lo])
        sizes, off = [], 0
        for n_e in cnt[lo:lo + E_loc]:
            sizes.append(min(off + n_e, Cs) - min(off, Cs))
            off += n_e
        n = sum(sizes)
        tok = tok[start:start + n]
        xs = xe[rows][tok]
        h = (F.silu(_segment_linear(xs, wg, sizes))
             * _segment_linear(xs, wu, sizes))
        out = _segment_linear(h, wd, sizes)
        g = gates.transpose(0, 1).reshape(-1)[order[start:start + n]]
        ys.append(torch.zeros((Tb, D), dtype=xt.dtype,
                              device=xt.device).index_add(
            0, tok, out * g.to(xt.dtype)[:, None]))
    return mesh.reduce_from(torch.cat(ys) if blocks > 1 else ys[0], ep_axis)


def _token_block(mesh, token_axes: tuple, ep_axis: str):
    """(axes, n, idx): the mesh axes of size > 1 the tokens are split
    over (``ep`` never), their shard count and this rank's shard."""
    axes = tuple(a for a in token_axes
                 if mesh.size(a) > 1 and a != ep_axis)
    n, idx = spec_split(mesh, axes) if axes else (1, 0)
    return axes, n, idx


def _gather_tokens(x, mesh, axes: tuple):
    """Every rank's token block along dim 0, major axis first; the
    backward sums each block's cotangents back to its rank."""
    for a in reversed(axes):
        x = mesh.gather_sum(x, a, 0)
    return x


def _aux_over_blocks(probs, first, E: int, mask, mesh, axes: tuple):
    """:func:`load_balance_loss` over the tokens of every block: the
    per-expert sums and the token count psummed over ``axes``
    (differentiably: every rank's loss takes the whole aux term)."""
    m = (torch.ones(probs.shape[0], device=probs.device) if mask is None
         else mask.float())
    stats = torch.cat([(_one_hot(first, E) * m[:, None]).sum(dim=0),
                       (probs * m[:, None]).sum(dim=0), m.sum()[None]])
    for a in axes:
        stats = mesh.psum_split(stats, a)
    n = torch.clamp(stats[-1], min=1.0)
    return E * ((stats[:E] / n) * (stats[E:2 * E] / n)).sum()


def _seq_block(x, mesh, axis: str):
    """JAX's token block of this rank's rows (B, C, D) under sequence
    parallelism: the rows gathered whole over ``axis``, flattened in
    ``b*S + s`` order and cut into the axis's shards."""
    n, idx = mesh.size(axis), mesh.index(axis)
    rows = mesh.gather_sum(x, axis, 1)
    return local_slice(rows.reshape(-1, x.shape[-1]), 0, n, idx)


def _seq_unblock(y, mesh, axis: str, shape):
    """Inverse of :func:`_seq_block`: this rank's chunk ``shape`` of
    the blocks' outputs."""
    n, idx = mesh.size(axis), mesh.index(axis)
    rows = mesh.gather_sum(y, axis, 0).reshape(shape[0], -1, shape[-1])
    return local_slice(rows, 1, n, idx)


def moe_ffn(x, params: dict, *, top_k: int = 2,
            capacity_factor: float = 1.25, mesh=None, ep_axis: str = "ep",
            dispatch_mode: str = "dense", token_mask=None,
            capacity: int | None = None, token_axes: tuple = ("dp",),
            token_blocks: int = 1, seq_axis: str | None = None):
    """Mixture-of-experts SwiGLU feed-forward (``expert.py:377``).

    x (..., D) -> (same shape, aux scalar fp32).  ``dispatch_mode`` is
    ``"dense"``, ``"sparse"`` or ``"dropless"`` (module docstring).
    ``token_mask`` (bool, ``x.shape[:-1]``): masked tokens give zero
    output, take no capacity slot and leave the aux loss alone; C still
    counts every row of ``x``, masked or not.  ``capacity`` overrides
    the ``capacity_factor`` formula.  Differentiable in ``x`` and the
    parameters: gradients reach the gates and the router probabilities,
    never the routing indices.

    ``mesh``: ``x`` is this rank's block of the tokens over
    ``token_axes`` (module docstring); with an ``ep_axis`` in the mesh
    the experts split over it and one ``psum`` over ``ep`` combines
    them: Megatron's ``g``, with its ``f`` on the expert inputs and the
    gates, so the router and everything before the block see the whole
    cotangent on every ``ep`` rank.  ``token_blocks``: the dropless
    ``ep`` path routes ``x``'s tokens as that many blocks
    (:func:`_dropless_ffn_ep`).  ``seq_axis``: ``x`` (B, C, D) is this
    rank's sequence chunk over that axis (module docstring)."""
    if dispatch_mode not in ("dense", "sparse", "dropless"):
        raise ValueError(f"unknown dispatch_mode {dispatch_mode!r}")
    # The expert products are batched over E: ``qlinear`` takes the
    # plain (E, d_in, d_out) weights and int8 leaves, whose per-(expert,
    # output-channel) scales commute with the product.
    from ..models.transformer import qlinear
    orig_shape = x.shape
    D = orig_shape[-1]
    xt = x.reshape(-1, D)
    E = params["router"].shape[-1]
    mask_t = None if token_mask is None else token_mask.reshape(-1)
    axes, _, idx = (_token_block(mesh, token_axes, ep_axis)
                    if mesh is not None else ((), 1, 0))
    ep = mesh is not None and ep_axis in mesh.shape
    seq = mesh is not None and mesh.size(seq_axis) > 1
    if seq and (x.ndim != 3 or token_mask is not None):
        raise ValueError("seq_axis takes x (B, C, D) without a token_mask")

    if dispatch_mode == "dropless" and mesh is not None:
        # Routing is per token, so each rank routes its own block; the
        # aux loss needs every block's statistics.
        logits = xt.float() @ params["router"]
        probs = torch.softmax(logits, dim=-1)
        aux = _aux_over_blocks(probs, torch.argmax(probs, dim=-1), E,
                               mask_t, mesh, axes + ((seq_axis,) if seq
                                                     else ()))
        if ep:
            regather = seq and x.shape[0] > 1
            xb = _seq_block(x, mesh, seq_axis) if regather else xt
            lb = xb.float() @ params["router"] if regather else logits
            y = _dropless_ffn_ep(xb, params, lb, top_k, E, mesh,
                                 ep_axis, capacity_factor,
                                 token_mask=mask_t, capacity=capacity,
                                 blocks=token_blocks)
            if regather:
                y = _seq_unblock(y, mesh, seq_axis, orig_shape)
        else:
            gates, expert_idx, _ = top_k_routing(logits, top_k)
            y = _dropless_ffn(xt, params, gates, expert_idx, E,
                              token_mask=mask_t)
        return y.reshape(orig_shape), aux

    # Capacity and priority are the whole batch's: a token-split batch
    # is gathered, and each rank keeps its own rows of the result.
    chunk_shape = orig_shape
    if seq:
        x = mesh.gather_sum(x, seq_axis, 1)
        orig_shape, xt = x.shape, x.reshape(-1, D)
    T_own = xt.shape[0]
    xg = _gather_tokens(xt, mesh, axes)
    mg = mask_t
    if axes and mask_t is not None:
        mg = _gather_tokens(mask_t.to(torch.uint8), mesh, axes).bool()
    T = xg.shape[0]
    C = (capacity if capacity is not None
         else compute_capacity(T, E, top_k, capacity_factor))
    logits = xg.float() @ params["router"]
    gates, expert_idx, probs = top_k_routing(logits, top_k)
    aux = load_balance_loss(probs, expert_idx, E, token_mask=mg)

    if dispatch_mode == "dropless":
        y = _dropless_ffn(xt, params, gates, expert_idx, E,
                          token_mask=mask_t)
        return y.reshape(orig_shape), aux

    # This rank's experts [lo, lo + E_loc): all of them off an ep axis.
    if ep:
        wg, wu, wd, lo, E_loc = _local_experts(params, E, mesh, ep_axis)
        xg = mesh.copy_to(xg, ep_axis)
        gates = mesh.copy_to(gates, ep_axis)
    else:
        wg, wu, wd, lo, E_loc = (params["w_gate"], params["w_up"],
                                 params["w_down"], 0, E)
    rows = slice(idx * T_own, (idx + 1) * T_own)
    if dispatch_mode == "sparse":
        slot, tok, keep, order = sparse_slots(expert_idx, E, C,
                                              token_mask=mg)
        local = slot - lo * C
        mine = keep & (local >= 0) & (local < E_loc * C)
        # Row E_loc*C is the trash row of dropped, masked and other
        # ranks' entries.
        local = torch.where(mine, local, E_loc * C)
        buf = torch.zeros((E_loc * C + 1, D), dtype=x.dtype,
                          device=x.device)
        xe = buf.index_copy(0, local, xg[tok])[:E_loc * C].reshape(
            E_loc, C, D)
    else:
        dispatch, combine = make_dispatch(gates, expert_idx, E, C,
                                          token_mask=mg)
        xe = torch.einsum("tec,td->ecd",
                          dispatch[:, lo:lo + E_loc].to(x.dtype), xg)
    h = F.silu(qlinear(xe, wg)) * qlinear(xe, wu)
    ye = qlinear(h, wd)                                   # (E_loc, C, D)
    if dispatch_mode == "sparse":
        g = torch.where(mine, gates.transpose(0, 1).reshape(-1)[order],
                        0.0).to(x.dtype)
        # Trash entries read the zero row past the buffer.
        picked = torch.cat([ye.reshape(E_loc * C, D),
                            ye.new_zeros((1, D))])[local]
        y = torch.zeros((T, D), dtype=x.dtype, device=x.device).index_add(
            0, tok, picked * g[:, None])[rows]
    else:
        y = torch.einsum("tec,ecd->td",
                         combine[rows, lo:lo + E_loc].to(x.dtype), ye)
    if ep:
        y = mesh.reduce_from(y, ep_axis)
    y = y.reshape(orig_shape)
    if seq:
        y = local_slice(y, 1, mesh.size(seq_axis), mesh.index(seq_axis))
    return y.reshape(chunk_shape), aux
