"""Ring attention: exact attention over sequence-sharded inputs
(counterpart of ``nbdistributed_tpu/parallel/ring.py``).

Every rank of the ``sp`` axis holds one chunk of the sequence: its
queries stay put, and the K/V chunks travel around the ring by
:meth:`..parallel.mesh.Mesh.ppermute`, each visiting chunk folded into
an online-softmax accumulator, so no rank ever holds the (S, S) scores.
The functions take this rank's local views, as the JAX package's inner
functions do inside ``shard_map``: q (B, C, H, D), k/v (B, C, Hkv, D)
and the segment ids (B, C) of this rank's chunk (and of its rows and
heads, where a ``dp`` or ``tp`` axis splits those: the ring never mixes
them).  K/V travel at ``Hkv`` heads; GQA is never expanded.

Two inner paths, as in JAX:

* ``use_flash=False``: the grouped online softmax in plain PyTorch,
  differentiated by autograd through the ring's ``ppermute``;
* ``use_flash=True``: every hop is one flash forward (K1 on CUDA
  tensors) at the hop's global ``(q_off, k_off)`` offsets, the hops
  folded by their lse.  The backward (:class:`_RingFlash`) computes
  delta once, then runs K2 and K3 once per hop from the *global* lse
  and delta; the fp32 dK/dV accumulators ride the ring with their
  chunk and land home.  ``schedule="zigzag"`` is the load-balanced
  causal schedule (:class:`_RingFlashZigzag`): four half-pair launches
  per hop in each direction.

CPU tensors take the kernels' plain versions (the ops' route); a CUDA
tensor launches the kernels or raises.  A sliding window prunes the
ring to the hops that can see a key (:func:`hop_plan`), K/V jumping
across the skipped ones in one ``ppermute``.
"""

from __future__ import annotations

import math

import torch

from ..ops._common import NEG_INF
from ..ops.attention import (_flash_backward_hop, _flash_bwd_prep,
                             _flash_forward, check_window)


def ring_attention(q, k, v, mesh, *, axis: str = "sp", causal: bool = True,
                   scale: float | None = None, use_flash: bool = False,
                   schedule: str = "plain", batch_axis: str | None = None,
                   head_axis: str | None = None, window: int | None = None,
                   segment_ids=None):
    """Exact (causal) attention of this rank's chunk over the whole
    sequence sharded on ``mesh``'s ``axis`` (``ring.py:84``).

    q: (B, C, H, D), k/v: (B, C, Hkv, D) — this rank's chunk, rank ``i``
    of the axis holding global positions ``[i*C, (i+1)*C)`` (zigzag:
    the two half-chunks of :func:`zigzag_order`); returns this rank's
    output chunk.  ``H % Hkv == 0``.  ``schedule="zigzag"`` needs
    ``causal``, ``use_flash`` and S divisible by 2n.  ``batch_axis`` /
    ``head_axis`` name the mesh axes this rank's rows and heads are
    split over (dp/tp composition); the ring never mixes them, so they
    are only checked to be axes of the mesh.  ``segment_ids`` (B, C):
    packed documents; the key side's ids ride the ring with K/V.
    Differentiable in q, k and v."""
    H, D = q.shape[2], q.shape[-1]
    Hkv = k.shape[2]
    if H % Hkv:
        raise ValueError(f"n_heads {H} not divisible by n_kv_heads {Hkv}")
    for name, ax in (("batch_axis", batch_axis), ("head_axis", head_axis)):
        if ax is not None and ax not in mesh.shape:
            raise ValueError(f"{name} {ax!r} is not an axis of the mesh "
                             f"{mesh.shape}")
    if v.shape[2] != Hkv:
        raise ValueError(f"k/v head counts differ: {Hkv} vs {v.shape[2]}")
    if schedule not in ("plain", "zigzag"):
        raise ValueError(f"unknown schedule {schedule!r}")
    n = mesh.size(axis)
    if schedule == "zigzag":
        if not causal:
            raise ValueError("zigzag is a causal-balance schedule; "
                             "use schedule='plain' for non-causal")
        if not use_flash:
            raise ValueError(
                "zigzag requires use_flash=True: only the flash path "
                "skips masked blocks (a masked einsum computes them "
                "anyway, so zigzag would buy nothing)")
        if q.shape[1] % 2:
            raise ValueError(f"zigzag needs S divisible by 2n={2 * n}, "
                             f"got S={q.shape[1] * n}")
    check_window(window, causal)
    if segment_ids is not None:
        if tuple(segment_ids.shape) != tuple(q.shape[:2]):
            raise ValueError(
                f"segment_ids shape {tuple(segment_ids.shape)} != (B, S) "
                f"{tuple(q.shape[:2])}")
        if q.shape[1] != k.shape[1]:
            raise ValueError("segment_ids requires Sq == Sk")
        segment_ids = segment_ids.to(torch.int32).contiguous()
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if schedule == "zigzag":
        return _RingFlashZigzag.apply(q, k, v, segment_ids, mesh, axis,
                                      scale, window)
    if use_flash:
        return _RingFlash.apply(q, k, v, segment_ids, mesh, axis, causal,
                                scale, window)
    return _ring_inner(q, k, v, segment_ids, mesh=mesh, axis=axis,
                       causal=causal, scale=scale, window=window)


def zigzag_order(S: int, n: int):
    """Permutation putting a (B, S, ...) sequence into zigzag layout:
    position p of the reordered sequence holds original index
    ``order[p]``; rank d of n contiguous chunks then holds the original
    chunks d and 2n-1-d (``ring.py:174``)."""
    if S % (2 * n):
        raise ValueError(f"S={S} not divisible by 2n={2 * n}")
    C = S // (2 * n)
    idx = []
    for d in range(n):
        idx.extend(range(d * C, (d + 1) * C))
        idx.extend(range((2 * n - 1 - d) * C, (2 * n - d) * C))
    return torch.tensor(idx, dtype=torch.long)


def zigzag_shard(x, n: int, axis: int = 1):
    """``x``'s sequence axis in zigzag layout (once, on the whole data,
    before each rank takes its chunk)."""
    x = torch.as_tensor(x)
    return x.index_select(axis, zigzag_order(x.shape[axis], n).to(x.device))


def zigzag_unshard(x, n: int, axis: int = 1):
    """Inverse of :func:`zigzag_shard`."""
    x = torch.as_tensor(x)
    order = zigzag_order(x.shape[axis], n)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(len(order))
    return x.index_select(axis, inv.to(x.device))


def _intervals_touch(q_ivals, k_ivals, window: int) -> bool:
    """Whether any (query, key) pair drawn from the half-open global
    intervals is visible under causal + window (``ki <= qi`` and
    ``ki > qi - window``)."""
    for q0, q1 in q_ivals:
        for k0, k1 in k_ivals:
            if k0 <= q1 - 1 and k1 - 1 >= q0 - window + 1:
                return True
    return False


def hop_plan(n: int, s_local: int, window: int | None,
             schedule: str = "plain", *, sk_local: int | None = None):
    """The ring steps that can contribute under a sliding window
    (``ring.py:217``): step ``s`` gives rank ``my`` the K/V chunk of
    rank ``(my - s) % n``, and is in the plan iff any rank sees a key
    there (every rank runs the same steps).  ``range(n)`` without a
    window; a prefix of ``1 + ceil((w-1)/C)`` steps with one (plain),
    a prefix and a suffix (zigzag).  ``sk_local``: the per-rank K length
    when it differs from the Q length (plain schedule only)."""
    if window is None:
        return tuple(range(n))
    sk_local = s_local if sk_local is None else sk_local
    steps = []
    for s in range(n):
        for my in range(n):
            src = (my - s) % n
            if schedule == "zigzag":
                C = s_local // 2
                q_iv = [(my * C, (my + 1) * C),
                        ((2 * n - 1 - my) * C, (2 * n - my) * C)]
                k_iv = [(src * C, (src + 1) * C),
                        ((2 * n - 1 - src) * C, (2 * n - src) * C)]
            else:
                q_iv = [(my * s_local, (my + 1) * s_local)]
                k_iv = [(src * sk_local, (src + 1) * sk_local)]
            if _intervals_touch(q_iv, k_iv, window):
                steps.append(s)
                break
    return tuple(steps)


def _run_hops(plan, mesh, axis: str, fold, carry, riders, home: int = 0):
    """Run ``carry, riders = fold(carry, riders, src)`` at each step of
    ``plan`` with the ``riders`` (K/V, their segment ids, gradient
    accumulators) moved between steps (``ring.py:270``): from step ``s``
    to the plan's next step ``s'`` by one ``ppermute`` of ``s' - s``
    (the neighbour ring when the plan is full; a pruned plan jumps each
    gap in one).  The riders the fold only reads are posted before the
    fold and waited for after it, so the hop overlaps the fold; the
    ``home`` trailing riders (dK/dV) are what the fold adds to, so they
    go after it, the last time by ``-plan[-1]``, which stands them on
    their own rank again."""
    n, my = mesh.size(axis), mesh.index(axis)
    riders = tuple(riders)
    ahead = len(riders) - home
    for i, s in enumerate(plan):       # plan[0] is 0: the diagonal
        nxt = plan[i + 1] - s if i + 1 < len(plan) else None
        posted = ([mesh.ppermute_start(x, axis, nxt)
                   for x in riders[:ahead]] if nxt is not None else [])
        carry, riders = fold(carry, riders, (my - s) % n)
        back = riders[ahead:]
        if back and (nxt is not None or s):
            shift = nxt if nxt is not None else -s
            sent = [mesh.ppermute_start(x, axis, shift) for x in back]
            back = tuple(h.wait() for h in sent)
        riders = (tuple(h.wait() for h in posted) if posted
                  else riders[:ahead]) + back
    return carry, riders


def _ring_inner(q, k, v, seg=None, *, mesh, axis: str, causal: bool,
                scale: float, window: int | None = None):
    """The grouped online-softmax ring in plain PyTorch
    (``ring.py:305``), differentiated by autograd."""
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    n, my = mesh.size(axis), mesh.index(axis)
    dev = q.device
    qf = (q.float() * scale).reshape(B, Sq, Hkv, g, Dh)
    acc = torch.zeros((B, Sq, Hkv, g, Dh), dtype=torch.float32, device=dev)
    m = torch.full((B, Hkv, g, Sq, 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, Hkv, g, Sq, 1), dtype=torch.float32, device=dev)

    def fold(carry, riders, src):
        acc, m, l = carry
        k_cur, v_cur = riders[0], riders[1]
        Sk = k_cur.shape[1]
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, k_cur.float())
        if causal or seg is not None:
            keep = torch.ones((1, Sq, Sk), dtype=torch.bool, device=dev)
            if causal:
                qi = my * Sq + torch.arange(Sq, device=dev)[:, None]
                ki = src * Sk + torch.arange(Sk, device=dev)[None, :]
                ck = ki <= qi
                if window is not None:
                    ck = ck & (ki > qi - window)
                keep = keep & ck[None]
            if seg is not None:
                keep = keep & (seg[:, :, None] == riders[2][:, None, :])
            s = torch.where(keep[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)                       # (B,Hkv,g,Sq,Sk)
        corr = torch.exp(m - m_new)                    # (B,Hkv,g,Sq,1)
        l_new = l * corr + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bkgqs,bskd->bqkgd", p, v_cur.float())
        return (acc * corr.permute(0, 3, 1, 2, 4) + pv, m_new, l_new), riders

    plan = hop_plan(n, Sq, window if causal else None, sk_local=k.shape[1])
    riders = (k, v) if seg is None else (k, v, seg)
    (acc, m, l), _ = _run_hops(plan, mesh, axis, fold, (acc, m, l), riders)
    out = acc / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


# ----------------------------------------------------------------------
# the flash path: K1 per hop forward, K2 and K3 per hop backward

def _fold_hop(O, L, o_j, lse_j):
    """Fold a hop's (o_j, lse_j) into the running (O, L) (``ring.py:
    393``).  The lse is (B, H, Sq) here, so JAX's fold-layout reshape
    becomes a transpose.  A fully masked hop's lse (~ -1e30 from the
    plain version, ~ -6.9e29 from K1) gets a weight of exactly 0 once L
    is finite, which the diagonal hop, folded first, makes it."""
    L_new = torch.logaddexp(L, lse_j)
    w_old = torch.exp(L - L_new).transpose(1, 2)[..., None]
    w_j = torch.exp(lse_j - L_new).transpose(1, 2)[..., None]
    return O * w_old + o_j.float() * w_j, L_new


def _hop(tensor, ki: int, C: int):
    """Half-chunk ``ki`` of a zigzag rider, contiguous for the kernels."""
    return tensor[:, ki * C:(ki + 1) * C].contiguous()


class _RingFlash(torch.autograd.Function):
    """The flash ring (``ring.py:413`` ``_make_ring_flash``): forward one
    flash launch per hop folded by lse; backward delta once, then K2
    and K3 per hop from the global lse and delta, the fp32 dK/dV riding
    home with their chunk."""

    @staticmethod
    def forward(ctx, q, k, v, seg, mesh, axis, causal, scale, window):
        B, Sq, H, D = q.shape
        Sk = k.shape[1]
        my = mesh.index(axis)
        O = torch.zeros((B, Sq, H, D), dtype=torch.float32, device=q.device)
        L = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32,
                       device=q.device)

        def fold(carry, riders, src):
            o_j, lse_j = _flash_forward(
                q, riders[0], riders[1], causal=causal, scale=scale,
                offsets=(my * Sq, src * Sk), window=window,
                segment_ids=seg,
                kv_segment_ids=riders[2] if seg is not None else None)
            return _fold_hop(*carry, o_j, lse_j), riders

        plan = hop_plan(mesh.size(axis), Sq, window if causal else None,
                        sk_local=Sk)
        riders = (k, v) if seg is None else (k, v, seg)
        (O, L), _ = _run_hops(plan, mesh, axis, fold, (O, L), riders)
        out = O.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, L, seg)
        ctx.args = (mesh, axis, causal, scale, window, plan)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, L, seg = ctx.saved_tensors
        mesh, axis, causal, scale, window, plan = ctx.args
        Sq, Sk = q.shape[1], k.shape[1]
        my = mesh.index(axis)
        g = g.contiguous()
        delta = _flash_bwd_prep(out, g)       # hop-invariant: once

        def fold(dq, riders, src):
            kv = riders[:-2]
            dq_j, dk_j, dv_j = _flash_backward_hop(
                q, kv[0], kv[1], g, L, delta, causal=causal, scale=scale,
                offsets=(my * Sq, src * Sk), window=window, segment_ids=seg,
                kv_segment_ids=kv[2] if seg is not None else None)
            return dq + dq_j.float(), kv + (riders[-2] + dk_j.float(),
                                            riders[-1] + dv_j.float())

        zeros = lambda t: torch.zeros(t.shape, dtype=torch.float32,  # noqa: E731
                                      device=t.device)
        riders = ((k, v) if seg is None else (k, v, seg)) + (zeros(k),
                                                             zeros(v))
        dq, riders = _run_hops(plan, mesh, axis, fold, zeros(q), riders,
                               home=2)
        return (dq.to(q.dtype), riders[-2].to(k.dtype),
                riders[-1].to(v.dtype), None, None, None, None, None, None)


class _RingFlashZigzag(torch.autograd.Function):
    """The zigzag causal ring (``ring.py:517``): this rank holds the
    half-chunks ``my`` and ``2n-1-my``; every hop runs the four
    half-pair launches at their global offsets (the kernels skip the
    masked pairs' tiles), forward and backward, the dK/dV
    half-accumulators riding home."""

    @staticmethod
    def _offs(idx, n, C):
        return (idx * C, (2 * n - 1 - idx) * C)

    @staticmethod
    def forward(ctx, q, k, v, seg, mesh, axis, scale, window):
        B, Sq, H, D = q.shape
        n, my = mesh.size(axis), mesh.index(axis)
        C = Sq // 2
        q_offs = _RingFlashZigzag._offs(my, n, C)
        qh = (_hop(q, 0, C), _hop(q, 1, C))
        qsegh = (None, None) if seg is None else (_hop(seg, 0, C),
                                                  _hop(seg, 1, C))
        carry = []
        for _ in range(2):
            carry += [torch.zeros((B, C, H, D), dtype=torch.float32,
                                  device=q.device),
                      torch.full((B, H, C), NEG_INF, dtype=torch.float32,
                                 device=q.device)]

        def fold(carry, riders, src):
            carry = list(carry)
            k_offs = _RingFlashZigzag._offs(src, n, C)
            # (qa, ka) is qa's diagonal and (qb, ka) lies wholly before
            # qb, so both halves' L are real after the first step.
            for qi in range(2):
                for ki in range(2):
                    o_j, lse_j = _flash_forward(
                        qh[qi], _hop(riders[0], ki, C),
                        _hop(riders[1], ki, C), causal=True, scale=scale,
                        offsets=(q_offs[qi], k_offs[ki]), window=window,
                        segment_ids=qsegh[qi],
                        kv_segment_ids=(None if seg is None
                                        else _hop(riders[2], ki, C)))
                    carry[2 * qi:2 * qi + 2] = _fold_hop(
                        carry[2 * qi], carry[2 * qi + 1], o_j, lse_j)
            return tuple(carry), riders

        plan = hop_plan(n, Sq, window, "zigzag")
        riders = (k, v) if seg is None else (k, v, seg)
        (Oa, La, Ob, Lb), _ = _run_hops(plan, mesh, axis, fold,
                                        tuple(carry), riders)
        out = torch.cat([Oa, Ob], dim=1).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, La, Lb, seg)
        ctx.args = (mesh, axis, scale, window, plan)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, La, Lb, seg = ctx.saved_tensors
        mesh, axis, scale, window, plan = ctx.args
        n, my = mesh.size(axis), mesh.index(axis)
        C = q.shape[1] // 2
        q_offs = _RingFlashZigzag._offs(my, n, C)
        g = g.contiguous()
        qh = (_hop(q, 0, C), _hop(q, 1, C))
        gh = (_hop(g, 0, C), _hop(g, 1, C))
        deltas = tuple(_flash_bwd_prep(_hop(out, h, C), gh[h])
                       for h in range(2))
        Ls = (La, Lb)
        qsegh = (None, None) if seg is None else (_hop(seg, 0, C),
                                                  _hop(seg, 1, C))

        def fold(dqs, riders, src):
            dqs = list(dqs)
            kv = riders[:-2]
            dk, dv = riders[-2], riders[-1]
            k_offs = _RingFlashZigzag._offs(src, n, C)
            for qi in range(2):
                for ki in range(2):
                    dq_j, dk_j, dv_j = _flash_backward_hop(
                        qh[qi], _hop(kv[0], ki, C), _hop(kv[1], ki, C),
                        gh[qi], Ls[qi], deltas[qi], causal=True,
                        scale=scale, offsets=(q_offs[qi], k_offs[ki]),
                        window=window, segment_ids=qsegh[qi],
                        kv_segment_ids=(None if seg is None
                                        else _hop(kv[2], ki, C)))
                    dqs[qi] = dqs[qi] + dq_j.float()
                    dk[:, ki * C:(ki + 1) * C] += dk_j.float()
                    dv[:, ki * C:(ki + 1) * C] += dv_j.float()
            return tuple(dqs), kv + (dk, dv)

        zeros = lambda shape: torch.zeros(shape, dtype=torch.float32,  # noqa: E731
                                          device=q.device)
        riders = ((k, v) if seg is None else (k, v, seg)) + (
            zeros(k.shape), zeros(v.shape))
        (dqa, dqb), riders = _run_hops(
            plan, mesh, axis, fold, (zeros(qh[0].shape), zeros(qh[1].shape)),
            riders, home=2)
        dq = torch.cat([dqa, dqb], dim=1)
        return (dq.to(q.dtype), riders[-2].to(k.dtype),
                riders[-1].to(v.dtype), None, None, None, None, None)
