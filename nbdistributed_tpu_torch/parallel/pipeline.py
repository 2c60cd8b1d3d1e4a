"""Pipeline parallelism: the GPipe and 1F1B microbatch schedules over a
mesh axis (counterpart of ``nbdistributed_tpu/parallel/pipeline.py``).

Stages are the ranks of the ``pp`` axis, and each holds only its own
slice of the stage-stacked parameters (:func:`shard_stage_params`: every
leaf ``(1, ...)``, the block ``shard_map`` hands a JAX stage).  JAX runs
a schedule as one ``lax.scan`` under ``shard_map``: every device
computes every tick, and ``jnp.where`` discards the warm-up and drain
slots, because one traced program cannot diverge.  The port runs it
SPMD over processes: every rank runs the same tick loop, and stage
``s`` computes only the slots JAX keeps (it forwards microbatch
``t - s`` at tick ``t`` and, in 1F1B, backwards microbatch
``t - 2(S-1) + s``), so the results are JAX's and the masked work is
not done.  Activations move stage to stage by JAX's partial permutation
``[(i, i+1)]`` and cotangents by its inverse
(:meth:`.mesh.Mesh.ppermute_start`): a tick posts its sends after its
compute, the next tick's compute runs while they travel, and each
received tensor is waited for where it is used.  Every rank posts the
same hops in the same order, forward and backward; a rank that neither
sends nor receives at a tick posts nothing.

With one layer a stage and no stage remat, a rank launches per step:
GPipe (:func:`pipeline_forward` through autograd) the stage forward
once and its backward once per microbatch; 1F1B the forward twice per
microbatch (the forward sub-step and the recompute its backward runs
from the saved input) and the backward once, except on the last stage,
whose forward and backward of a microbatch fall in the same tick and
share one forward.

The output of :func:`pipeline_forward` and the loss and tail gradients
of the 1F1B schedule are replicated on every rank of the axis (a
broadcast from the stage that holds them, where JAX sums zeros from the
other stages); stage gradients stay each rank's own slice.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .mesh import P, _tree_map, local_slice


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def _rebuild(tree, leaves):
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def shard_stage_params(stage_params, mesh, axis: str = "pp"):
    """This rank's ``(1, ...)`` slice of stage-stacked parameters (every
    leaf carries a leading ``n_stages`` axis): ``apply_shardings`` with
    ``P(axis)`` on every leaf (``pipeline.py:34``)."""
    from .tensor_parallel import apply_shardings
    return _tree_map(lambda a: apply_shardings(a, mesh, P(axis)),
                     stage_params)


def _microbatches(x, n_micro: int):
    batch = x.shape[0]
    if batch % n_micro:
        raise ValueError(
            f"batch {batch} not divisible by {n_micro} microbatches")
    return x.reshape(n_micro, batch // n_micro, *x.shape[1:])


def _fwd_pairs(S: int, M: int, t: int) -> list:
    """The forward hops of tick ``t``: each stage that forwarded a
    microbatch sends it on."""
    return [(i, i + 1) for i in range(S - 1) if 0 <= t - i < M]


def _drain(posted) -> None:
    if posted is not None:
        posted._complete()


class _GPipe:
    """One :func:`pipeline_forward` on this rank: the forward tick loop,
    keeping each microbatch's graph (the stage's input and output) for
    the backward's reverse tick loop."""

    def __init__(self, stage_fn, tree, mesh, axis, n_micro):
        self.stage_fn, self.tree = stage_fn, tree
        self.mesh, self.axis, self.M = mesh, axis, n_micro
        self.S, self.s = mesh.size(axis), mesh.index(axis)

    def forward(self, x, leaves, grad: bool):
        S, s, M, mesh = self.S, self.s, self.M, self.mesh
        xs = _microbatches(x, M)
        self.ps = [p.detach().requires_grad_(p.requires_grad and grad)
                   for p in leaves]
        with torch.set_grad_enabled(grad):
            local = _tree_map(lambda a: a[0], _rebuild(self.tree, self.ps))
        self.x_grad = grad and x.requires_grad
        need_dx = grad and (s > 0 or x.requires_grad)
        self.graphs, outs, post = [None] * M, [None] * M, None
        for t in range(M + S - 1):
            m, y = t - s, None
            if 0 <= m < M:
                x_in = xs[m] if s == 0 else post.wait()
                with torch.set_grad_enabled(grad):
                    xi = x_in.detach().requires_grad_(need_dx)
                    y = self.stage_fn(local, xi)
                if grad:
                    self.graphs[m] = (xi if need_dx else None, y)
                outs[m] = y.detach() if s == S - 1 else y[:0].detach()
            _drain(post)
            post = mesh.ppermute_start(y.detach() if y is not None
                                       else xs[0], self.axis,
                                       pairs=_fwd_pairs(S, M, t))
        _drain(post)
        out = torch.cat(outs, dim=0)
        if s != S - 1:
            out = out.new_empty((x.shape[0],) + out.shape[1:])
        return mesh.broadcast(out, self.axis, S - 1)

    def backward(self, g):
        """(dx replicated over the axis or None, a gradient per leaf)."""
        S, s, M, mesh = self.S, self.s, self.M, self.mesh
        gs = _microbatches(g, M)
        dps = [None] * len(self.ps)
        dxs, post = [None] * M, None
        for t in reversed(range(M + S - 1)):
            m, dx = t - s, None
            if 0 <= m < M:
                dy = gs[m] if s == S - 1 else post.wait()
                (xi, y), self.graphs[m] = self.graphs[m], None
                dx, dps = _vjp(y, dy, xi, self.ps, dps)
                if s == 0:
                    dxs[m] = dx
            _drain(post)
            pairs = [(i, i - 1) for i in range(1, S) if 0 <= t - i < M]
            post = mesh.ppermute_start(dx if dx is not None else gs[0],
                                       self.axis, pairs=pairs)
        _drain(post)
        dps = [torch.zeros_like(p) if d is None else d
               for p, d in zip(self.ps, dps)]
        if not self.x_grad:
            return None, dps
        full = torch.cat(dxs, dim=0) if s == 0 else torch.empty_like(g)
        return mesh.broadcast(full, self.axis, 0), dps


def _vjp(y, cot, xi, ps, acc):
    """``torch.autograd.grad`` of ``y`` at ``cot`` to ``xi`` (None: not
    wanted) and to the leaves ``ps`` that require grad, each leaf's
    added to its entry of ``acc``; returns (dx, acc)."""
    want = [p for p in ps if p.requires_grad]
    ins = ([xi] if xi is not None else []) + want
    grads = list(torch.autograd.grad(y, ins, cot.to(y.dtype),
                                     allow_unused=True))
    dx = grads.pop(0) if xi is not None else None
    it = iter(grads)
    out = []
    for p, a in zip(ps, acc):
        d = next(it) if p.requires_grad else None
        out.append(a if d is None else d if a is None else a + d)
    return dx, out


class _GPipeFn(torch.autograd.Function):
    """The whole GPipe schedule as one autograd node.  Autograd through
    per-tick sends would call a send's backward only where its received
    value was used (a stage's last hop, or stage 0's zeros), so ranks
    would post different hops; here every rank runs the reverse tick
    loop itself."""

    @staticmethod
    def forward(ctx, run, x, *leaves):
        ctx.run = run
        return run.forward(x, leaves, grad=True)

    @staticmethod
    def backward(ctx, g):
        run, ctx.run = ctx.run, None
        dx, dps = run.backward(g.contiguous())
        return (None, dx, *dps)


def pipeline_forward(stage_fn, stage_params, x, mesh, *, axis: str = "pp",
                     n_microbatches: int | None = None):
    """Run ``x`` through ``n_stages`` sequential applications of
    ``stage_fn``, pipelined over the ``axis`` mesh axis (GPipe,
    ``pipeline.py:42``).

    ``stage_fn(params_one_stage, activation) -> activation`` keeps the
    activation's shape and dtype; ``stage_params`` is this rank's slice
    (:func:`shard_stage_params`); ``x`` the whole batch, the same on
    every rank, its leading dim divisible by ``n_microbatches``
    (default: the number of stages).  Returns the output batch on every
    rank of the axis.  Differentiable in ``x`` and the stage leaves
    through one autograd node (:class:`_GPipeFn`); each microbatch's
    graph is kept, so checkpoint ``stage_fn`` (``make_pipeline_loss(
    remat=True)``) to keep only its input."""
    S = mesh.size(axis)
    M = n_microbatches if n_microbatches is not None else S
    _microbatches(x, M)
    leaves = _leaves(stage_params)
    run = _GPipe(stage_fn, stage_params, mesh, axis, M)
    if torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in leaves)):
        return _GPipeFn.apply(run, x, *leaves)
    return run.forward(x, leaves, grad=False)


def make_pipeline_1f1b(stage_fn, loss_tail, mesh, *, axis: str = "pp",
                       n_microbatches: int | None = None,
                       batch_axis: str | None = None):
    """One-forward-one-backward (1F1B, PipeDream-flush) training
    schedule (``pipeline.py:102``): ``(stage_params, x, batch) ->
    (loss, stage_grads)``.  Stage ``s`` forwards microbatch ``t - s``
    and backwards microbatch ``t - 2(S-1) + s`` at tick ``t``,
    recomputing the stage from its saved input; a saved input lives
    ``2(S-1-s)`` ticks, so at most ``2S - 1`` are held whatever the
    number of microbatches: activation memory O(S), not GPipe's O(M).
    ``loss_tail(y_micro, batch_micro) -> scalar`` is a per-microbatch
    loss whose whole-batch value is the mean over microbatches.  The
    machinery is :func:`make_pipeline_1f1b_full` with an empty tail."""
    full = make_pipeline_1f1b_full(
        stage_fn, lambda tp, y, b: loss_tail(y, b), mesh, axis=axis,
        n_microbatches=n_microbatches, batch_axis=batch_axis)

    def plain_loss_and_grads(stage_params, x, batch):
        loss, stage_grads, _tail, _dx = full({}, stage_params, x, batch)
        return loss, stage_grads

    return plain_loss_and_grads


def make_pipeline_1f1b_full(stage_fn, tail_fn, mesh, *,
                            axis: str = "pp",
                            n_microbatches: int | None = None,
                            dx_sink=None, dx_init=None,
                            batch_axis: str | None = None):
    """The general 1F1B machinery (``pipeline.py:163``): returns
    ``(tail_params, stage_params, x, batch) -> (loss, stage_grads,
    tail_grads, dx_acc)``.

    ``tail_fn(tail_params, y_micro, batch_micro) -> scalar`` is the
    per-microbatch loss head, run on the last stage; its gradients and
    the loss come back on every rank.  ``dx_sink(acc, dx_micro,
    batch_micro) -> acc`` (with ``dx_init()`` building the accumulator)
    folds each microbatch's input cotangent as it leaves stage 0's
    backward, e.g. an embedding scatter-add, so no O(M) buffer of them
    exists; ``dx_acc`` is None without a sink.  ``x`` and ``batch``
    (any pytree with a leading batch dim) are whole, the same on every
    rank.  ``batch_axis``: a ``dp`` axis the microbatch rows are split
    over (dp x pp): each dp group pipelines its rows, and the loss and
    every gradient are means over the groups."""
    if (dx_sink is None) != (dx_init is None):
        raise ValueError("pass both dx_sink and dx_init, or neither")

    def loss_and_grads(tail_params, stage_params, x, batch):
        S, s = mesh.size(axis), mesh.index(axis)
        M = n_microbatches if n_microbatches is not None else S
        B = x.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by {M} "
                             f"microbatches")
        xs = x.reshape(M, B // M, *x.shape[1:])
        bt = _tree_map(lambda a: torch.as_tensor(a).reshape(
            M, B // M, *a.shape[1:]), batch)
        if batch_axis is not None:
            d = mesh.size(batch_axis)
            if (B // M) % d:
                raise ValueError(
                    f"per-microbatch rows {B // M} (batch {B} / "
                    f"{M} microbatches) not divisible by "
                    f"{batch_axis}={d} — shard_map would fail with an "
                    f"opaque sharding error")
            mine = mesh.index(batch_axis)
            xs = local_slice(xs, 1, d, mine)
            bt = _tree_map(lambda a: local_slice(a, 1, d, mine), bt)
        ps = [p.detach().requires_grad_() for p in _leaves(stage_params)]
        tps = [p.detach().requires_grad_() for p in _leaves(tail_params)]
        with torch.enable_grad():
            local = _tree_map(lambda a: a[0], _rebuild(stage_params, ps))
        tp = _rebuild(tail_params, tps)
        g_stage, g_tail = [None] * len(ps), [None] * len(tps)
        dxa = dx_init() if dx_init is not None else None
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        last = s == S - 1
        need_dx = s > 0 or dx_sink is not None
        A = 2 * S - 1           # in-flight saved inputs: O(S), not O(M)
        buf = [None] * A
        f_post = b_post = None
        tmpl = xs[0]
        for t in range(M + 2 * (S - 1)):
            # ---- forward sub-step: stage s runs microbatch t - s and
            # saves its input; the last stage's backward takes it in
            # this same tick.
            m_f, y = t - s, None
            if 0 <= m_f < M:
                x_in = xs[m_f] if s == 0 else f_post.wait()
                buf[t % A] = x_in
                if not last:
                    with torch.no_grad():
                        y = stage_fn(local, x_in)
            _drain(f_post)
            f_post = mesh.ppermute_start(y if y is not None else tmpl, axis,
                                         pairs=_fwd_pairs(S, M, t))
            # ---- backward sub-step: microbatch t - 2(S-1) + s from its
            # saved input (recompute, then the vjp at the cotangent the
            # next stage sent, or at the loss head's on the last).
            m_b, dx = t - 2 * (S - 1) + s, None
            if 0 <= m_b < M:
                slot = (m_b + s) % A
                x_sav, buf[slot] = buf[slot], None
                bt_m = _tree_map(lambda a: a[m_b], bt)
                with torch.enable_grad():
                    xi = x_sav.detach().requires_grad_(need_dx)
                    y_b = stage_fn(local, xi)
                    if last:
                        loss_m = tail_fn(tp, y_b, bt_m)
                        loss = loss + loss_m.detach().float() / M
                        cot = torch.full_like(loss_m, 1.0 / M)
                        dx, g_all = _vjp(loss_m, cot, xi if need_dx else None,
                                         ps + tps, g_stage + g_tail)
                        g_stage, g_tail = g_all[:len(ps)], g_all[len(ps):]
                    else:
                        dx, g_stage = _vjp(y_b, b_post.wait(),
                                           xi if need_dx else None, ps,
                                           g_stage)
                if s == 0 and dx_sink is not None:
                    dxa = dx_sink(dxa, dx, bt_m)
            _drain(b_post)
            pairs = [(i, i - 1) for i in range(1, S)
                     if 0 <= t - 2 * (S - 1) + i < M]
            b_post = mesh.ppermute_start(dx if dx is not None else tmpl,
                                         axis, pairs=pairs)
        _drain(f_post)
        _drain(b_post)
        g_stage = [torch.zeros_like(p) if g is None else g.to(p.dtype)
                   for p, g in zip(ps, g_stage)]
        g_tail = [torch.zeros_like(p) if g is None else g.to(p.dtype)
                  for p, g in zip(tps, g_tail)]
        # Loss and tail gradients live on the last stage, the dx
        # accumulator on stage 0: every rank of the axis gets them.
        loss = mesh.broadcast(loss, axis, S - 1)
        g_tail = [mesh.broadcast(g, axis, S - 1) for g in g_tail]
        if dxa is not None:
            dxa = _tree_map(lambda a: mesh.broadcast(a, axis, 0), dxa)
        if batch_axis is not None and mesh.size(batch_axis) > 1:
            d = mesh.size(batch_axis)
            mean = lambda a: mesh.psum(a, batch_axis) / d  # noqa: E731
            loss = mean(loss)
            g_stage = [mean(g) for g in g_stage]
            g_tail = [mean(g) for g in g_tail]
            if dxa is not None:
                dxa = _tree_map(mean, dxa)
        return (loss, _rebuild(stage_params, g_stage),
                _rebuild(tail_params, g_tail), dxa)

    return loss_and_grads


def make_pipeline_loss(stage_fn, loss_tail, mesh, *, axis: str = "pp",
                       n_microbatches: int | None = None,
                       remat: bool = False):
    """``loss(stage_params, x, batch) = loss_tail(pipeline_forward(...),
    batch)``, differentiable end to end (``pipeline.py:327``).
    ``remat=True`` checkpoints each stage application
    (``torch.utils.checkpoint``), so the GPipe backward keeps M
    microbatch inputs per stage instead of their internals: between
    plain GPipe (O(M) residuals) and :func:`make_pipeline_1f1b` (O(S)
    inputs)."""
    fn = stage_fn
    if remat:
        def fn(p, h):
            return checkpoint(stage_fn, p, h, use_reentrant=False)

    def loss(stage_params, x, batch):
        y = pipeline_forward(fn, stage_params, x, mesh, axis=axis,
                             n_microbatches=n_microbatches)
        return loss_tail(y, batch)

    return loss
