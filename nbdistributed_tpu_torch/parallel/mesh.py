"""Named-axis meshes over the ``torch.distributed`` process group
(counterpart of ``nbdistributed_tpu/parallel/mesh.py``).

JAX runs a mesh from one controller: one program over every device,
with GSPMD inserting the collectives.  The port runs it SPMD over
processes, as a user of ``torch.distributed`` writes it cell by cell:
every rank runs the same code, holds only its own shard, and issues
the collectives explicitly over one process group per axis slice.

A :class:`Mesh` lays the world's ranks out in the order the axes are
given (layout-major: the last axis varies fastest, as JAX's
``np.asarray(devices).reshape(sizes)``), knows this rank's coordinate on
each axis, and holds, per axis of size > 1, the group of the ranks that
share every other coordinate with this one.  The groups take the world
group's backend: NCCL in a GPU worker, gloo on the CPU.  On a gloo
group the mesh path keeps to the collectives gloo runs on CUDA tensors
(``all_reduce``, ``all_gather``, ``broadcast``), so one card can host
several ranks (NCCL refuses two ranks on one device).  The two
collectives gloo does not run on CUDA tensors, the ring's
:meth:`Mesh.ppermute` (``send``/``recv`` take a raw pointer) and
Ulysses' :meth:`Mesh.all_to_all`, go through host memory there: the
tensor is copied to the CPU, moved by gloo's CPU ``batch_isend_irecv``
or ``all_to_all_single`` and copied back, so each rank moves only its
own bytes (an all-gather would move n times as many).

:class:`P` is the port's partition spec: one entry per dimension, an
axis name, a tuple of axis names or ``None``, as JAX's
``PartitionSpec`` reads.

**Training on a mesh** differentiates through the collectives.  The
forward-only :meth:`Mesh.psum`, :meth:`Mesh.all_gather` and
:meth:`Mesh.pmax` clone and reduce in place, which autograd cannot see
through; the methods below are ``torch.autograd.Function``s with the
transposes GSPMD derives in the JAX package:

- over an axis the loss is replicated on (``tp``, ``ep``): Megatron's
  ``g`` (:meth:`Mesh.reduce_from`: all-reduce, backward identity) after
  a row-split product, its ``f`` (:meth:`Mesh.copy_to`: identity,
  backward all-reduce) before a column-split product, a tiled gather
  whose backward keeps this rank's slice (:meth:`Mesh.gather_from`)
  and its transpose (:meth:`Mesh.scatter_to`);
- over an axis that splits the batch (``dp``), where each rank's loss
  is its own rows': a gather whose backward sums the cotangents over
  the axis and keeps this rank's slice, a reduce-scatter
  (:meth:`Mesh.gather_sum`, FSDP's parameter gather), and a psum whose
  backward psums too (:meth:`Mesh.psum_split`).

A reduce-scatter (:meth:`Mesh.reduce_scatter`) is ``reduce_scatter_
tensor`` on an NCCL group, and an all-reduce and a slice on gloo.

Two more are linear maps whose transpose is another of their kind, so
they hold on any axis: :meth:`Mesh.ppermute` (a ring shift or JAX's
partial ``(src, dst)`` pairs; the backward runs the inverted pairs) and
the tiled :meth:`Mesh.all_to_all` (the backward is the reverse
all-to-all).  :meth:`Mesh.ppermute_start` posts a ppermute and returns
a :class:`Posted` handle, so that a ring can queue the product or fold
that does not need the hop before it waits for the hop.

:func:`shard_map` runs a function on this rank's blocks of whole
inputs, as ``jax.shard_map`` runs it on each device's.
"""

from __future__ import annotations

import datetime
import itertools
import math

import torch

# A mesh collective that waits longer than this raises instead of
# hanging (the worker's collective timeout): every rank must issue the
# same collectives in the same order.
GROUP_TIMEOUT_S = 120


class P(tuple):
    """A partition spec: ``P(None, "tp")`` splits dimension 1 over the
    ``tp`` axis and keeps dimension 0 whole; ``P(("dp", "sp"))`` splits
    dimension 0 over both, ``dp`` major.  Dimensions past the spec's
    length are whole."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _dist():
    import torch.distributed as dist
    return dist


def _world() -> tuple[int, int]:
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """This rank's view of a named-axis mesh over the process group.

    ``shape`` maps axis name -> size in layout order (as JAX's
    ``mesh.shape``); :meth:`index` is this rank's coordinate on an axis
    and :meth:`size` an axis's size (0 and 1 for an axis the mesh lacks,
    so code written for a dp x tp x sp mesh runs on any of its
    sub-meshes).  :meth:`group` is the process group of this rank's
    slice along an axis; the collectives below run over it."""

    def __init__(self, shape: dict, coords: dict, groups: dict,
                 slice_ranks: dict):
        self.shape = dict(shape)
        self._coords = dict(coords)
        self._groups = dict(groups)
        self._slice_ranks = dict(slice_ranks)
        self._p2p_ready = set()

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    def size(self, axis: str | None) -> int:
        return self.shape.get(axis, 1) if axis is not None else 1

    def index(self, axis: str | None) -> int:
        return self._coords.get(axis, 0) if axis is not None else 0

    def group(self, axis: str):
        return self._groups.get(axis)

    def without(self, *axes: str) -> "Mesh":
        """The sub-mesh of the ranks that share this rank's coordinates
        on ``axes``: those axes dropped, every other axis's group kept.
        A server prefills a row on its dp slice's ranks with
        ``mesh.without("dp")``."""
        keep = [a for a in self.shape if a not in axes]
        return Mesh({a: self.shape[a] for a in keep},
                    {a: self._coords[a] for a in keep},
                    {a: g for a, g in self._groups.items() if a in keep},
                    {a: r for a, r in self._slice_ranks.items()
                     if a in keep})

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, coords={self._coords})"

    # ---- collectives over one axis (identity on an axis of size 1) --

    def psum(self, x, axis: str):
        """Sum of ``x`` over ``axis``; every rank of the slice gets it."""
        if self.size(axis) == 1:
            return x
        out = x.contiguous().clone()
        _dist().all_reduce(out, group=self._groups[axis])
        return out

    def pmax(self, x, axis: str):
        """Elementwise max of ``x`` over ``axis``."""
        if self.size(axis) == 1:
            return x
        out = x.contiguous().clone()
        _dist().all_reduce(out, op=_dist().ReduceOp.MAX,
                           group=self._groups[axis])
        return out

    def all_gather(self, x, axis: str, dim: int = 0):
        """The slice's ``x`` concatenated along ``dim`` in coordinate
        order (``jax.lax.all_gather(..., tiled=True)``)."""
        n = self.size(axis)
        if n == 1:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        _dist().all_gather(parts, x, group=self._groups[axis])
        return torch.cat(parts, dim=dim)

    def broadcast(self, x, axis: str, src: int):
        """Every rank of the slice returns the value of the rank at
        coordinate ``src`` on ``axis``."""
        if self.size(axis) == 1:
            return x
        out = x.contiguous().clone()
        _dist().broadcast(out, src=self._slice_ranks[axis][src],
                          group=self._groups[axis])
        return out

    def reduce_scatter(self, x, axis: str, dim: int = 0):
        """This rank's slice along ``dim`` of the sum of ``x`` over
        ``axis`` (``jax.lax.psum_scatter(..., tiled=True)``):
        ``reduce_scatter_tensor`` on an NCCL group, an all-reduce and a
        slice on gloo."""
        n = self.size(axis)
        if n == 1:
            return x
        group = self._groups[axis]
        if _dist().get_backend(group) != "nccl":
            return local_slice(self.psum(x, axis), dim, n, self.index(axis))
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of shape {tuple(x.shape)} is "
                             f"not divisible into {n} shards")
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
        _dist().reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim)

    def _staged(self, x, axis: str):
        """(x as the group's backend takes it, the device to copy the
        result back to or None): gloo moves a CUDA tensor through host
        memory."""
        if x.is_cuda and _dist().get_backend(self._groups[axis]) != "nccl":
            return x.detach().to("cpu").contiguous(), x.device
        return x.contiguous(), None

    def ppermute(self, x, axis: str, shift: int = 1, pairs=None):
        """``jax.lax.ppermute`` over ``axis``: with ``shift``, rank ``i``
        sends ``x`` to rank ``(i + shift) % n`` and returns what rank
        ``(i - shift) % n`` sent; with ``pairs``, a list of ``(src,
        dst)`` coordinates (each source and each destination at most
        once), ``src`` sends to ``dst`` and a rank that no pair sends to
        returns zeros.  ``ppermute_start(...).wait()``.  Differentiable:
        the backward runs the inverted pairs."""
        return self.ppermute_start(x, axis, shift, pairs).wait()

    def ppermute_start(self, x, axis: str, shift: int = 1,
                       pairs=None) -> "Posted":
        """Post :meth:`ppermute`'s send and receive and return at once;
        :meth:`Posted.wait` returns what this rank received.  Work queued
        between the two overlaps the transfer: on NCCL it runs on the
        group's stream, and ``wait`` makes the current stream wait for
        it; on gloo a CUDA tensor is copied to the host here and the
        received one back in ``wait``, the transfer running on gloo's
        threads between.  Every rank of the slice calls it, those that
        neither send nor receive included (they post nothing).  ``x``
        is also the template of the received tensor's shape and dtype."""
        n, me = self.size(axis), self.index(axis)
        pairs = _perm_pairs(n, shift, pairs)
        dst = next((d for s, d in pairs if s == me), None)
        src = next((s for s, d in pairs if d == me), None)
        if dst == me and src == me:
            return Posted(self, axis, x, pairs, value=x)
        if dst is None and src is None:
            return Posted(self, axis, x, pairs)
        dist, group = _dist(), self._groups.get(axis)
        ranks = self._slice_ranks.get(axis)
        if axis not in self._p2p_ready and n > 1:
            self._p2p_ready.add(axis)
            if dist.get_backend(group) == "nccl":
                # NCCL builds a group's communicator at its first
                # collective, which every rank must join; a partial
                # permutation's first hop may leave some out.
                dist.all_reduce(torch.zeros(1, device=x.device), group=group)
        host = x.is_cuda and dist.get_backend(group) != "nccl"
        ops, out, send = [], None, None
        if dst is not None:
            send = x.detach()
            send = (send.to("cpu") if host else send).contiguous()
            ops.append(dist.P2POp(dist.isend, send, ranks[dst], group))
        if src is not None:
            out = torch.empty(x.shape, dtype=x.dtype,
                              device="cpu" if host else x.device)
            ops.append(dist.P2POp(dist.irecv, out, ranks[src], group))
        return Posted(self, axis, x, pairs, reqs=dist.batch_isend_irecv(ops),
                      out=out, dev=x.device if host else None, keep=send)

    def all_to_all(self, x, axis: str, split_dim: int, concat_dim: int):
        """``jax.lax.all_to_all(x, axis, split_dim, concat_dim,
        tiled=True)``: ``x`` cut into n blocks along ``split_dim``, block
        j sent to rank j of ``axis``, the blocks received concatenated
        along ``concat_dim`` in rank order.  Differentiable: the
        backward is the reverse all-to-all."""
        if self.size(axis) == 1:
            return x
        return _AllToAll.apply(x, self, axis, _dim(x, split_dim),
                               _dim(x, concat_dim))

    def _all_to_all(self, x, axis: str, split_dim: int, concat_dim: int):
        n = self.size(axis)
        if x.shape[split_dim] % n:
            raise ValueError(f"dimension {split_dim} of shape "
                             f"{tuple(x.shape)} is not divisible into {n} "
                             f"blocks")
        blocks = x.movedim(split_dim, 0)
        blocks = blocks.reshape((n, blocks.shape[0] // n) + blocks.shape[1:])
        src, dev = self._staged(blocks, axis)
        out = torch.empty_like(src)
        _dist().all_to_all_single(out, src, group=self._groups[axis])
        out = out if dev is None else out.to(dev)
        return torch.cat([b.movedim(0, split_dim) for b in out.unbind(0)],
                         dim=concat_dim)

    # ---- differentiable collectives (module docstring) -------------

    def reduce_from(self, x, axis: str):
        """Megatron's ``g``: the sum over ``axis`` (after a row-split
        product); the backward passes the replicated cotangent on."""
        return x if self.size(axis) == 1 else _ReduceFrom.apply(x, self, axis)

    def copy_to(self, x, axis: str):
        """Megatron's ``f``: the identity (before a column-split product
        on a replicated input); the backward sums each rank's share of
        the cotangent over ``axis``."""
        return x if self.size(axis) == 1 else _CopyTo.apply(x, self, axis)

    def gather_from(self, x, axis: str, dim: int = -1):
        """The tiled all-gather of ``x`` along ``dim`` for a consumer
        replicated over ``axis``; the backward keeps this rank's slice
        of the (replicated) cotangent."""
        if self.size(axis) == 1:
            return x
        return _GatherFrom.apply(x, self, axis, dim)

    def scatter_to(self, x, axis: str, dim: int = -1):
        """This rank's slice of a replicated ``x`` along ``dim``; the
        backward all-gathers the cotangent (the transpose of
        :meth:`gather_from`)."""
        if self.size(axis) == 1:
            return x
        return _ScatterTo.apply(x, self, axis, dim)

    def gather_sum(self, x, axis: str, dim: int = 0):
        """The tiled all-gather of ``x`` along ``dim`` over an axis that
        splits the batch (FSDP's parameter gather, the MoE layer's token
        gather); the backward sums the ranks' cotangents and keeps this
        rank's slice: a reduce-scatter."""
        if self.size(axis) == 1:
            return x
        return _GatherSum.apply(x, self, axis, dim)

    def psum_split(self, x, axis: str):
        """The sum of ``x`` over an axis that splits the batch, for a
        term every rank's loss takes whole; the backward sums the
        cotangents over the axis too."""
        return x if self.size(axis) == 1 else _PsumSplit.apply(x, self, axis)


def _dim(x, dim: int) -> int:
    return dim % x.ndim


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum(g, ctx.axis), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, _dim(x, dim)
        return mesh.all_gather(x, axis, ctx.dim)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        return (local_slice(g, ctx.dim, m.size(ctx.axis),
                            m.index(ctx.axis)).contiguous(),
                None, None, None)


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, _dim(x, dim)
        return local_slice(x, ctx.dim, mesh.size(axis),
                           mesh.index(axis)).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.axis, ctx.dim), None, None, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, _dim(x, dim)
        return mesh.all_gather(x, axis, ctx.dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.reduce_scatter(g, ctx.axis, ctx.dim),
                None, None, None)


class _PsumSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum(g, ctx.axis), None, None


class Posted:
    """A ppermute in flight (:meth:`Mesh.ppermute_start`)."""

    def __init__(self, mesh, axis, x, pairs, *, reqs=(), out=None,
                 dev=None, keep=None, value=None):
        self.mesh, self.axis, self.x, self.pairs = mesh, axis, x, pairs
        self._reqs, self._out, self._dev = reqs, out, dev
        self._keep, self._value = keep, value

    def _complete(self) -> None:
        """Wait for the transfer without building the result."""
        for req in self._reqs:
            req.wait()
        self._reqs, self._keep = (), None

    def _result(self):
        if self._value is None:
            self._complete()
            out = self._out
            if out is None:
                out = torch.zeros_like(self.x)
            elif self._dev is not None:
                out = out.to(self._dev)
            self._value, self._out = out, None
        return self._value

    def wait(self):
        """What this rank received: zeros where no pair sends to it; the
        input itself where it sends to itself.  Differentiable in the
        posted tensor."""
        if self._value is self.x:
            return self.x
        if torch.is_grad_enabled() and self.x.requires_grad:
            return _PermuteWait.apply(self.x, self)
        return self._result()


def _perm_pairs(n: int, shift: int, pairs) -> list:
    """The ``(src, dst)`` list of a ppermute: ``pairs`` checked, or the
    cyclic shift's."""
    if pairs is None:
        return [(i, (i + shift) % n) for i in range(n)]
    pairs = [(int(s), int(d)) for s, d in pairs]
    srcs, dsts = [s for s, _ in pairs], [d for _, d in pairs]
    if len(set(srcs)) < len(srcs) or len(set(dsts)) < len(dsts):
        raise ValueError(f"ppermute pairs {pairs} repeat a source or a "
                         f"destination")
    if any(not 0 <= i < n for i in srcs + dsts):
        raise ValueError(f"ppermute pairs {pairs} name a rank outside an "
                         f"axis of size {n}")
    return pairs


class _PermuteWait(torch.autograd.Function):
    """The received tensor as a function of the posted one; the
    backward sends the cotangent along the inverted pairs."""

    @staticmethod
    def forward(ctx, x, posted):
        ctx.posted = posted
        return posted._result()

    @staticmethod
    def backward(ctx, g):
        p = ctx.posted
        back = [(d, s) for s, d in p.pairs]
        return p.mesh.ppermute(g.contiguous(), p.axis, pairs=back), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = mesh, axis, split_dim, concat_dim
        return mesh._all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_dim, concat_dim = ctx.args
        return (mesh._all_to_all(g, axis, concat_dim, split_dim),
                None, None, None, None)


def make_mesh(axis_sizes: dict[str, int] | None = None, *,
              ranks: list[int] | None = None,
              timeout_s: float = GROUP_TIMEOUT_S) -> Mesh:
    """Build a :class:`Mesh` over the world process group (one rank
    without one).

    ``axis_sizes`` maps axis name -> size in layout-major order, e.g.
    ``{"dp": 2, "tp": 2}``; a size of -1 means "whatever is left" (at
    most one axis).  Default: one ``dp`` axis over every rank.

    ``ranks``: the world ranks the mesh spans, in layout order (default:
    every rank), this one among them: the counterpart of JAX's
    ``make_mesh(..., devices=)``.  ``make_mesh({"dp": 1}, ranks=[rank])``
    is a mesh of this rank alone, inside any world.

    Every rank of the world must call it, with the same sizes and
    ``ranks``, where an axis has more than one rank: it creates the
    groups of every axis slice, those this rank is not in included, in
    one order (``dist.new_group``'s rule).  A mesh whose axes all have
    size 1 creates no group."""
    n, rank = _world()
    members = list(range(n)) if ranks is None else [int(r) for r in ranks]
    if rank not in members:
        raise ValueError(f"rank {rank} is not among the mesh's ranks "
                         f"{members}")
    n, pos = len(members), members.index(rank)
    sizes = dict(axis_sizes) if axis_sizes else {"dp": n}
    wild = [k for k, v in sizes.items() if v == -1]
    if len(wild) > 1:
        raise ValueError("at most one axis may be -1")
    fixed = math.prod(v for v in sizes.values() if v != -1)
    if wild:
        if n % fixed:
            raise ValueError(f"{n} ranks not divisible by {fixed}")
        sizes[wild[0]] = n // fixed
    total = math.prod(sizes.values())
    if total != n:
        raise ValueError(
            f"mesh {sizes} needs {total} ranks but {n} are available")
    names = list(sizes)
    dims = [sizes[a] for a in names]
    # Row-major coordinates of every position: pos = ravel(coords).
    coord_of = list(itertools.product(*[range(d) for d in dims]))
    mine = coord_of[pos]
    groups, slice_ranks = {}, {}
    for i, axis in enumerate(names):
        if dims[i] == 1:
            continue
        slices = {}
        for r, c in enumerate(coord_of):
            slices.setdefault(c[:i] + c[i + 1:], []).append(members[r])
        lists = list(slices.values())
        own = slices[mine[:i] + mine[i + 1:]]
        slice_ranks[axis] = own
        dist = _dist()
        td = datetime.timedelta(seconds=timeout_s)
        for group_ranks in lists:    # every rank creates every group
            g = dist.new_group(group_ranks, timeout=td)
            if group_ranks == own:
                groups[axis] = g
    return Mesh(sizes, dict(zip(names, mine)), groups, slice_ranks)


def _spec_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def spec_split(mesh: Mesh, entry) -> tuple[int, int]:
    """(number of shards, this rank's shard) of a dimension whose spec
    entry is ``entry``: the product of its axes' sizes, and the
    row-major index of this rank's coordinates on them.  An axis the
    mesh lacks raises, as JAX's ``NamedSharding`` does."""
    n, idx = 1, 0
    for axis in _spec_axes(entry):
        if axis not in mesh.shape:
            raise ValueError(f"axis {axis!r} of the partition spec is not "
                             f"in the mesh {mesh.shape}")
        n *= mesh.shape[axis]
        idx = idx * mesh.shape[axis] + mesh.index(axis)
    return n, idx


def local_slice(x, dim: int, n: int, idx: int, what: str = "dimension"):
    """Shard ``idx`` of ``n`` equal shards of ``x`` along ``dim`` (a
    view); an indivisible extent raises."""
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"{what} {dim} of shape {tuple(x.shape)} is not "
                         f"divisible into {n} shards")
    step = x.shape[dim] // n
    return x.narrow(dim, idx * step, step)


def shard_batch(batch, mesh: Mesh, axis: str = "dp"):
    """This rank's slice of a batch that every rank holds whole: each
    tensor (or array) of the pytree split on its leading dimension over
    ``axis``, replicated over the other axes.  That is the JAX
    function's single-process meaning (a host batch placed sharded on
    the mesh); the port's multi-process world keeps the same contract,
    so every rank passes the same whole batch."""
    n, idx = spec_split(mesh, axis)

    def one(x):
        return local_slice(torch.as_tensor(x), 0, n, idx,
                           "batch dimension").contiguous()

    return _tree_map(one, batch)


def replicate(tree, mesh: Mesh):
    """A pytree replicated over the mesh: every rank already holds its
    whole value, so this is the identity on the rank's device."""
    return tree


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def axis_index(mesh: Mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (``jax.lax.axis_index``)."""
    return mesh.index(axis)


def psum(x, mesh: Mesh, axis: str):
    """``jax.lax.psum`` over one mesh axis."""
    return mesh.psum(x, axis)


def pmax(x, mesh: Mesh, axis: str):
    """``jax.lax.pmax`` over one mesh axis."""
    return mesh.pmax(x, axis)


def all_gather(x, mesh: Mesh, axis: str, dim: int = 0):
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``."""
    return mesh.all_gather(x, axis, dim)


def _map_spec(fn, tree, spec):
    """``fn(leaf, spec)`` over ``tree`` with ``spec`` a :class:`P` (or
    None) for a whole subtree, or a tree of them matching it."""
    if spec is None or isinstance(spec, P):
        return _tree_map(lambda x: fn(x, spec), tree)
    if isinstance(spec, dict):
        return {k: _map_spec(fn, tree[k], spec[k]) for k in tree}
    if len(spec) != len(tree):
        raise ValueError(f"{len(spec)} specs for {len(tree)} values")
    return type(tree)(_map_spec(fn, t, s) for t, s in zip(tree, spec))


def shard_map(f, mesh: Mesh, in_specs, out_specs):
    """``jax.shard_map(f, mesh=, in_specs=, out_specs=)`` in the port's
    SPMD world: the returned function takes whole inputs (every rank
    passes the same), hands ``f`` this rank's block of each by
    ``in_specs`` (one spec per positional argument, a :class:`P` for all
    of an argument's leaves or a tree of them; one :class:`P` for every
    argument), and returns ``f``'s outputs gathered whole along each
    split dimension of ``out_specs`` (``P()``: as they are, as JAX
    takes a replicated output)."""
    def block(x, spec):
        for dim, entry in enumerate(spec or ()):
            n, idx = spec_split(mesh, entry)
            x = local_slice(torch.as_tensor(x), dim, n, idx)
        return x

    def whole(x, spec):
        for dim, entry in enumerate(spec or ()):
            for axis in reversed(_spec_axes(entry)):
                x = mesh.all_gather(x.contiguous(), axis, dim)
        return x

    def mapped(*args):
        specs = in_specs if not isinstance(in_specs, P) else \
            (in_specs,) * len(args)
        return _map_spec(whole, f(*_map_spec(block, args, tuple(specs))),
                         out_specs)

    return mapped
