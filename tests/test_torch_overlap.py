"""The port's collective matmuls (``parallel/overlap.py``) against the
JAX package's, on the CPU: a 4-rank gloo world of the port's workers
(``test_torch_mesh_train.py``'s cluster) on a ``{"tp": 4}`` mesh, each
rank holding its shards, against the JAX functions under ``shard_map``
on 4 virtual CPU devices with the same numpy operands
(``tests/unit/test_overlap.py``): the output and the gradient of every
operand of ``sum(out * cot)``, gathered whole, within 1e-5; each
decomposed collective is t-1 ``ppermute`` hops and no gather.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from nbdistributed_tpu.parallel import mesh as jmesh
from nbdistributed_tpu.parallel import overlap as joverlap
from nbdistributed_tpu.utils.compat import shard_map
from nbdistributed_tpu_torch.parallel import overlap as poverlap
from nbdistributed_tpu_torch.parallel.mesh import Mesh
from test_torch_mesh_train import (cell, cluster, every_rank,  # noqa: F401
                                   pull0, push)

T = 4
TOL = 1e-5

# Every rank: its shard of each pushed operand by the function's specs
# (dimension -> "tp"), the function, and the output and the operands'
# gradients of sum(out * cot) gathered whole; the ppermute hops and
# all-gathers the function itself ran.
RUN = """
import torch.distributed as _d
from nbdistributed_tpu_torch.parallel.mesh import local_slice
m = make_mesh({{"tp": {T}}})

def part(x, d):
    x = torch.tensor(np.array(x))
    return x if d is None else local_slice(x, d, {T}, m.index("tp")).contiguous()

def whole(x, d):
    return (x if d is None else m.all_gather(x.contiguous(), "tp", d)).numpy()

ins = [part(A[f"x{{i}}"], d).requires_grad_() for i, d in enumerate({ins!r})]
calls = {{"p2p": 0, "gather": 0}}
_p2p, _gather = _d.batch_isend_irecv, _d.all_gather
_d.batch_isend_irecv = lambda *a, **k: (calls.__setitem__("p2p", calls["p2p"] + 1), _p2p(*a, **k))[1]
_d.all_gather = lambda *a, **k: (calls.__setitem__("gather", calls["gather"] + 1), _gather(*a, **k))[1]
try:
    out = overlap.{fn}(*ins, m, "tp")
    (out * part(A["cot"], {out_d!r})).sum().backward()
    hops = dict(calls)
finally:
    _d.batch_isend_irecv, _d.all_gather = _p2p, _gather
res = {{"out": whole(out.detach(), {out_d!r}),
       **{{f"d{{i}}": whole(t.grad, d) for i, (t, d) in enumerate(zip(ins, {ins!r}))}}}}
hops
"""

# function: (operand shapes, the dimension each is split on, the
# output's split dimension).
CASES = {
    "allgather_matmul": (((16, 12), (12, 24)), (0, 1), 1),
    "matmul_reducescatter": (((16, 24), (24, 12)), (1, 0), 0),
    "megatron_sp_block": (((16, 8), (8, 32), (32, 8)), (0, 1, 0), 0),
}


def _spec(d):
    return JP(*([None] * d + ["tp"]))


@pytest.mark.integration
@pytest.mark.parametrize("fn", list(CASES))
def test_overlap_matches_jax_with_grads(cluster, fn):  # noqa: F811
    shapes, ins, out_d = CASES[fn]
    rng = np.random.default_rng(len(fn))
    A = {f"x{i}": (rng.standard_normal(s) / np.sqrt(s[0])).astype(
        np.float32) for i, s in enumerate(shapes)}
    jm = jmesh.make_mesh({"tp": T}, devices=jax.devices()[:T])
    f = shard_map(lambda *a: getattr(joverlap, fn)(*a, "tp"), mesh=jm,
                  in_specs=tuple(_spec(d) for d in ins),
                  out_specs=_spec(out_d))
    args = [jnp.asarray(A[f"x{i}"]) for i in range(len(shapes))]
    want, vjp = jax.vjp(jax.jit(f), *args)
    A["cot"] = rng.standard_normal(want.shape).astype(np.float32)
    grads = vjp(jnp.asarray(A["cot"]))
    push(cluster, "A", A)
    cell(cluster, "from nbdistributed_tpu_torch.parallel import overlap")
    hops = every_rank(cluster, RUN.format(T=T, fn=fn, ins=ins, out_d=out_d))
    # Each ring-decomposed collective: t-1 hops forward, t-1 backward.
    rings = 2 if fn == "megatron_sp_block" else 1
    assert hops == {"p2p": 2 * rings * (T - 1), "gather": 0}
    got = pull0(cluster, "res")
    np.testing.assert_allclose(got["out"], np.asarray(want), atol=TOL,
                               rtol=TOL)
    for i, g in enumerate(grads):
        np.testing.assert_allclose(got[f"d{i}"], np.asarray(g), atol=TOL,
                                   rtol=TOL, err_msg=f"operand {i}")


def test_reducescatter_rejects_indivisible():
    """``overlap.py:88``'s message, before any hop."""
    with pytest.raises(ValueError) as want:
        jm = jmesh.make_mesh({"tp": T}, devices=jax.devices()[:T])
        shard_map(lambda hs, ws: joverlap.matmul_reducescatter(hs, ws, "tp"),
                  mesh=jm, in_specs=(JP(None, "tp"), JP("tp", None)),
                  out_specs=JP("tp", None))(jnp.ones((6, 8)),
                                            jnp.ones((8, 4)))
    with pytest.raises(ValueError) as got:
        poverlap.matmul_reducescatter(torch.ones((6, 2)), torch.ones((2, 4)),
                                      Mesh({"tp": T}, {"tp": 0}, {}, {}),
                                      "tp")
    assert str(got.value) == str(want.value)


# Every rank: the function's forward and backward with each ppermute's
# post (P) and wait (W) and each product (M) recorded in order ("|"
# between forward and backward), and the results gathered whole.
RECORD = """
import nbdistributed_tpu_torch.parallel.mesh as _pm
from nbdistributed_tpu_torch.parallel.mesh import local_slice
m = make_mesh({{"tp": {T}}})
events = []
_start = _pm.Mesh.ppermute_start

def _rec_start(self, *a, **k):
    h = _start(self, *a, **k)
    events.append("P")
    _wait = h.wait
    h.wait = lambda: (events.append("W"), _wait())[1]
    return h

_mm = torch.Tensor.__matmul__

def part(x, d):
    x = torch.tensor(np.array(x))
    return local_slice(x, d, {T}, m.index("tp")).contiguous()

ins = [part(A[f"x{{i}}"], d).requires_grad_() for i, d in enumerate({ins!r})]
_pm.Mesh.ppermute_start = _rec_start
torch.Tensor.__matmul__ = lambda a, b: (events.append("M"), _mm(a, b))[1]
try:
    out = overlap.{fn}(*ins, m, "tp")
    events.append("|")
    (out * part(A["cot"], {out_d!r})).sum().backward()
finally:
    _pm.Mesh.ppermute_start = _start
    torch.Tensor.__matmul__ = _mm
res = {{"out": m.all_gather(out.detach(), "tp", {out_d!r}).numpy(),
       **{{f"d{{i}}": m.all_gather(t.grad, "tp", d).numpy()
          for i, (t, d) in enumerate(zip(ins, {ins!r}))}}}}
"".join(events)
"""

# The order each function must keep on t = 4 ranks: a hop (P ... W)
# always spans a product.  allgather_matmul sends each chunk on before
# its product; matmul_reducescatter's sum carries from hop to hop, so
# the next chunk's product runs during the hop instead.  Each backward
# is the other's ring, two products (dx and dw) a chunk.
ORDER = {
    "allgather_matmul": "PMWPMWPMWM|MMPMMWPMMWPMMW",
    "matmul_reducescatter": "MPMWPMWPMW|PMMWPMMWPMMWMM",
}


@pytest.mark.integration
@pytest.mark.parametrize("fn", list(ORDER))
def test_hops_are_posted_before_the_products_they_overlap(cluster, fn):
    """C4's pin: every rank posts each hop before the product it does not
    depend on and waits for it after, forward and backward, and the
    output and gradients still equal JAX's."""
    shapes, ins, out_d = CASES[fn]
    rng = np.random.default_rng(len(fn) + 1)
    A = {f"x{i}": (rng.standard_normal(s) / np.sqrt(s[0])).astype(
        np.float32) for i, s in enumerate(shapes)}
    jm = jmesh.make_mesh({"tp": T}, devices=jax.devices()[:T])
    f = shard_map(lambda *a: getattr(joverlap, fn)(*a, "tp"), mesh=jm,
                  in_specs=tuple(_spec(d) for d in ins),
                  out_specs=_spec(out_d))
    want, vjp = jax.vjp(jax.jit(f), *[jnp.asarray(A[f"x{i}"])
                                      for i in range(len(shapes))])
    A["cot"] = rng.standard_normal(want.shape).astype(np.float32)
    grads = vjp(jnp.asarray(A["cot"]))
    push(cluster, "A", A)
    cell(cluster, "from nbdistributed_tpu_torch.parallel import overlap")
    order = every_rank(cluster, RECORD.format(T=T, fn=fn, ins=ins,
                                              out_d=out_d))
    assert order == ORDER[fn]
    got = pull0(cluster, "res")
    np.testing.assert_allclose(got["out"], np.asarray(want), atol=TOL,
                               rtol=TOL)
    for i, g in enumerate(grads):
        np.testing.assert_allclose(got[f"d{i}"], np.asarray(g), atol=TOL,
                                   rtol=TOL, err_msg=f"operand {i}")
