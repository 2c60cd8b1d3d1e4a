"""The port's ring attention against the JAX package's, on the CPU.

The hop plan and the zigzag layout are pure Python and must equal
JAX's exactly.  ``ring_attention`` runs on a 4-rank gloo world of the
port's workers (``test_torch_mesh_train.py``'s cluster), each rank on
its chunk of the sequence (and its dp rows and tp heads), against
``nbdistributed_tpu.parallel.ring.ring_attention`` on 4 of the JAX
package's virtual CPU devices with the same numpy inputs: the output
and (dq, dk, dv) of ``sum(out * cot)`` gathered whole, within 1e-5.

The port's flash path (``use_flash=True``: one flash forward per hop
folded by lse, K2/K3 per hop from the global lse and delta) takes the
kernels' plain versions on the CPU and is held to JAX's grouped-einsum
ring the same way; the zigzag schedule, which needs the flash path in
JAX too, against JAX's run in Pallas interpret mode
(``tests/unit/test_ring.py:123-164``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbdistributed_tpu.parallel import mesh as jmesh
from nbdistributed_tpu.parallel import ring as jring
from nbdistributed_tpu_torch.parallel import ring as pring
from nbdistributed_tpu_torch.parallel.mesh import Mesh
from test_torch_mesh_train import (cell, cluster, every_rank,  # noqa: F401
                                   pull0, push)

WORLD = 4
DEVS = jax.devices()[:WORLD]
TOL = 1e-5


# ----------------------------------------------------------------------
# exact: the hop plan and the zigzag layout

@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_hop_plan_equals_jax(n):
    """Every window from 1 to S, plain and zigzag, and cross-length
    plans (``sk_local`` != ``s_local``)."""
    for s_local in (2, 4, 6, 8):
        S = n * s_local
        for window in [None] + list(range(1, S + 1)):
            assert pring.hop_plan(n, s_local, window) == \
                jring.hop_plan(n, s_local, window), (n, s_local, window)
            assert pring.hop_plan(n, s_local, window, "zigzag") == \
                jring.hop_plan(n, s_local, window, "zigzag")
            for sk in (1, 3, 2 * s_local):
                assert pring.hop_plan(n, s_local, window, sk_local=sk) == \
                    jring.hop_plan(n, s_local, window, sk_local=sk)


@pytest.mark.parametrize("S,n", [(8, 1), (16, 2), (24, 4), (64, 8)])
def test_zigzag_layout_equals_jax(S, n):
    np.testing.assert_array_equal(pring.zigzag_order(S, n).numpy(),
                                  jring.zigzag_order(S, n))
    x = np.random.default_rng(S).standard_normal((2, S, 3), np.float32)
    z = pring.zigzag_shard(x, n)
    np.testing.assert_array_equal(z.numpy(), jring.zigzag_shard(x, n))
    np.testing.assert_array_equal(pring.zigzag_unshard(z, n).numpy(), x)
    np.testing.assert_array_equal(
        pring.zigzag_shard(np.swapaxes(x, 0, 1), n, axis=0).numpy(),
        jring.zigzag_shard(np.swapaxes(x, 0, 1), n, axis=0))


def test_zigzag_order_refusal_equals_jax():
    with pytest.raises(ValueError) as want:
        jring.zigzag_order(10, 4)
    with pytest.raises(ValueError) as got:
        pring.zigzag_order(10, 4)
    assert str(got.value) == str(want.value)


def _one_rank_view(n):
    """A mesh object as rank 0 of an ``sp`` axis of ``n`` sees it, for
    checks that raise before any collective."""
    return Mesh({"sp": n}, {"sp": 0}, {}, {})


@pytest.mark.parametrize("kw,H,Hkv,S", [
    (dict(schedule="zigzag", causal=False, use_flash=True), 4, 2, 16),
    (dict(schedule="zigzag", use_flash=False), 4, 2, 16),
    (dict(schedule="zigzag", use_flash=True), 4, 2, 12),
    (dict(schedule="diagonal"), 4, 2, 16),
    (dict(window=0), 4, 2, 16),
    (dict(window=4, causal=False), 4, 2, 16),
    ({}, 4, 3, 16),
], ids=["zigzag_noncausal", "zigzag_einsum", "zigzag_indivisible",
        "schedule", "window_zero", "window_noncausal", "gqa"])
def test_ring_refusals_equal_jax(kw, H, Hkv, S):
    """JAX's checks (``ring.py:123-171``), message for message (the
    port's kernels are CUDA, not Pallas); the port takes rank 0's chunk
    of the sequence JAX takes whole."""
    n = 4
    q = np.zeros((1, S, H, 8), np.float32)
    kv = np.zeros((1, S, Hkv, 8), np.float32)
    jm = jmesh.make_mesh({"sp": n}, devices=DEVS)
    with pytest.raises(ValueError) as want:
        jring.ring_attention(q, kv, kv, jm, **kw)
    import torch
    C = S // n
    tq, tkv = torch.zeros((1, C, H, 8)), torch.zeros((1, C, Hkv, 8))
    with pytest.raises(ValueError) as got:
        pring.ring_attention(tq, tkv, tkv, _one_rank_view(n), **kw)
    assert str(got.value) == str(want.value).replace("Pallas", "flash")


# ----------------------------------------------------------------------
# ring_attention on the 4-rank world

# Every rank: its dp rows, sp chunk and tp heads of the pushed global
# inputs; the function's output and the gradients of sum(out * cot),
# gathered whole.
RUN = """
from nbdistributed_tpu_torch.parallel.mesh import local_slice
m = make_mesh({sizes!r})
QD, SD = {{0: "dp", 1: "sp", 2: "tp"}}, {{0: "dp", 1: "sp"}}

def part(x, dims):
    x = torch.tensor(np.array(x))
    for d, a in dims.items():
        if a in m.shape:
            x = local_slice(x, d, m.size(a), m.index(a))
    return x.contiguous()

def whole(x, dims):
    for d, a in dims.items():
        if a in m.shape:
            x = m.all_gather(x.contiguous(), a, d)
    return x.numpy()

q, k, v = (part(A[n], QD).requires_grad_() for n in "qkv")
seg = part(A["seg"], SD) if "seg" in A else None
out = {fn}(q, k, v, m, segment_ids=seg, **{kw!r})
(out * part(A["cot"], QD)).sum().backward()
res = {{"out": whole(out.detach(), QD), "dq": whole(q.grad, QD),
       "dk": whole(k.grad, QD), "dv": whole(v.grad, QD)}}
"""


def inputs(B, S, H, Hkv, D=8, seg=False, seed=0):
    rng = np.random.default_rng(seed)
    A = {n: rng.standard_normal((B, S, h, D), np.float32)
         for n, h in (("q", H), ("k", Hkv), ("v", Hkv), ("cot", H))}
    if seg:
        A["seg"] = np.sort(rng.integers(0, 4, (B, S)), axis=1).astype(
            np.int32)
    return A


def port_run(comm, A, sizes, fn, **kw):
    push(comm, "A", A)
    cell(comm, RUN.format(sizes=sizes, fn=fn, kw=kw))
    return pull0(comm, "res")


def jax_run(A, sizes, fn, **kw):
    jm = jmesh.make_mesh(sizes, devices=DEVS)
    seg = jnp.asarray(A["seg"]) if "seg" in A else None
    out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, jm, segment_ids=seg,
                                          **kw),
                       *(jnp.asarray(A[n]) for n in "qkv"))
    dq, dk, dv = vjp(jnp.asarray(A["cot"]))
    return {"out": out, "dq": dq, "dk": dk, "dv": dv}


def check(got, want, tol=TOL):
    for name in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                   atol=tol, rtol=tol, err_msg=name)


# (sizes, (B, S, H, Hkv), segments, ring keywords).  S=32 on sp4 is
# chunks of 8: window 7 prunes the plan to hops (0, 1).
CASES = {
    "causal": ({"sp": 4}, (2, 32, 4, 4), False, {}),
    "noncausal": ({"sp": 4}, (2, 32, 4, 4), False, dict(causal=False)),
    "gqa4": ({"sp": 4}, (1, 32, 8, 2), False, {}),
    "window_pruned": ({"sp": 4}, (2, 32, 4, 2), False, dict(window=7)),
    "segments": ({"sp": 4}, (2, 32, 4, 2), True, {}),
    "segments_noncausal": ({"sp": 4}, (2, 32, 4, 2), True,
                           dict(causal=False)),
    "dp2_sp2": ({"dp": 2, "sp": 2}, (2, 16, 4, 2), True,
                dict(batch_axis="dp")),
    "sp2_tp2": ({"sp": 2, "tp": 2}, (2, 16, 4, 2), False,
                dict(head_axis="tp")),
}


@pytest.mark.integration
@pytest.mark.parametrize("use_flash", [False, True], ids=["einsum", "flash"])
@pytest.mark.parametrize("case", list(CASES))
def test_ring_attention_matches_jax(cluster, case, use_flash):
    """Output and (dq, dk, dv) against JAX's grouped-einsum ring, for the
    port's einsum ring and its flash ring (per-hop kernels' plain
    versions on the CPU)."""
    sizes, (B, S, H, Hkv), seg, kw = CASES[case]
    A = inputs(B, S, H, Hkv, seg=seg, seed=len(case))
    got = port_run(cluster, A, sizes, "ring_attention", use_flash=use_flash,
                   **kw)
    check(got, jax_run(A, sizes, jring.ring_attention, use_flash=False, **kw))


@pytest.mark.integration
@pytest.mark.parametrize("window", [None, 5], ids=["full", "window5"])
def test_zigzag_ring_matches_jax(cluster, window):
    """The zigzag schedule (four half-pair hops each way) on inputs in
    zigzag order, with segments, against JAX's zigzag ring (Pallas in
    interpret mode); window 5 over half-chunks of 2 prunes the plan."""
    A = inputs(1, 16, 4, 2, seg=True, seed=7)
    A = {k: np.asarray(pring.zigzag_shard(v, WORLD)) for k, v in A.items()}
    kw = dict(use_flash=True, schedule="zigzag", window=window)
    got = port_run(cluster, A, {"sp": 4}, "ring_attention", **kw)
    check(got, jax_run(A, {"sp": 4}, jring.ring_attention, **kw))


# Every rank: its block of the pushed global array along dim 0, the
# collective, and the result and the gradient of sum(out * cot) gathered
# back along dim 0 (the JAX shard_map's in and out spec).
COLLECTIVE = """
from nbdistributed_tpu_torch.parallel.mesh import local_slice
m = make_mesh({{"sp": 4}})
x = local_slice(torch.tensor(np.array(A["x"])), 0, 4, m.index("sp")).contiguous()
x.requires_grad_()
out = {call}
cot = torch.tensor(np.array(A["cot"]))
(out * local_slice(cot, 0, 4, m.index("sp"))).sum().backward()
res = {{"out": m.all_gather(out.detach().contiguous(), "sp", 0).numpy(),
       "dx": m.all_gather(x.grad.contiguous(), "sp", 0).numpy()}}
"""


@pytest.mark.integration
@pytest.mark.parametrize("op,args", [
    ("ppermute", (1,)), ("ppermute", (-1,)), ("ppermute", (3,)),
    ("all_to_all", (2, 1)), ("all_to_all", (1, 2)), ("all_to_all", (3, 0)),
], ids=["shift1", "shift-1", "shift3", "split2_concat1", "split1_concat2",
        "split3_concat0"])
def test_mesh_collectives_match_jax(cluster, op, args):
    """``Mesh.ppermute`` and ``Mesh.all_to_all`` (the ring's and
    Ulysses' collectives) and their backwards against
    ``jax.lax.ppermute`` / ``jax.lax.all_to_all(tiled=True)`` inside
    ``shard_map`` on sp4: the outputs and the input gradients, exactly
    (they only move data)."""
    from jax.sharding import PartitionSpec as JP

    from nbdistributed_tpu.utils.compat import shard_map
    rng = np.random.default_rng(len(op) + sum(args))
    x = rng.standard_normal((8, 4, 8, 4)).astype(np.float32)
    jm = jmesh.make_mesh({"sp": WORLD}, devices=DEVS)
    if op == "ppermute":
        perm = [(j, (j + args[0]) % WORLD) for j in range(WORLD)]
        fn = lambda t: jax.lax.ppermute(t, "sp", perm)  # noqa: E731
        call = f"m.ppermute(x, 'sp', {args[0]})"
    else:
        split, concat = args
        fn = lambda t: jax.lax.all_to_all(  # noqa: E731
            t, "sp", split, concat, tiled=True)
        call = f"m.all_to_all(x, 'sp', {split}, {concat})"
    f = shard_map(fn, mesh=jm, in_specs=JP("sp"), out_specs=JP("sp"))
    want, vjp = jax.vjp(jax.jit(f), jnp.asarray(x))
    cot = rng.standard_normal(want.shape).astype(np.float32)
    (dx,) = vjp(jnp.asarray(cot))
    push(cluster, "A", {"x": x, "cot": cot})
    cell(cluster, COLLECTIVE.format(call=call))
    got = pull0(cluster, "res")
    np.testing.assert_array_equal(got["out"], np.asarray(want))
    np.testing.assert_array_equal(got["dx"], np.asarray(dx))


# Every rank: ``RUN``'s ring with each ppermute's post (P) and wait (W)
# and each per-hop kernel call (F: K1 forward, K2/K3 backward) recorded
# in order, "|" between forward and backward.
RECORD = """
import nbdistributed_tpu_torch.parallel.mesh as _pm
import nbdistributed_tpu_torch.parallel.ring as _ring
events = []
_start, _fwd, _bwd = (_pm.Mesh.ppermute_start, _ring._flash_forward,
                      _ring._flash_backward_hop)

def _rec_start(self, *a, **k):
    h = _start(self, *a, **k)
    events.append("P")
    _wait = h.wait
    h.wait = lambda: (events.append("W"), _wait())[1]
    return h

def _rec(fn):
    return lambda *a, **k: (events.append("F"), fn(*a, **k))[1]

class _Mark(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        events.append("|")
        return g

_pm.Mesh.ppermute_start = _rec_start
_ring._flash_forward, _ring._flash_backward_hop = _rec(_fwd), _rec(_bwd)
ring_attention_ = ring_attention
ring_attention = lambda *a, **k: _Mark.apply(ring_attention_(*a, **k))
try:
{run}
finally:
    ring_attention = ring_attention_
    _pm.Mesh.ppermute_start = _start
    _ring._flash_forward, _ring._flash_backward_hop = _fwd, _bwd
"".join(events)
"""


def _hop_order(n, fwd_folds, bwd_folds, riders):
    """The event order of a full ring of ``n`` hops: each step posts the
    K/V riders (P x riders) before its fold (F x the step's kernel
    calls) and waits for them after; in the backward the dK/dV riders
    (PP) are posted after the fold, the last step's sending them home."""
    p, w, f, b = "P" * riders, "W" * riders, "F" * fwd_folds, "F" * bwd_folds
    return ((p + f + w) * (n - 1) + f + "|"
            + (p + b + "PPWW" + w) * (n - 1) + b + "PPWW")


@pytest.mark.integration
@pytest.mark.parametrize("schedule", ["plain", "zigzag"])
def test_ring_hops_are_posted_before_each_fold(cluster, schedule):
    """C4's pin: in both flash ring Functions every rank posts the K/V
    and segment-id riders of a hop before the fold that reads them (one
    K1 launch a hop, four half-pair launches zigzag; K2 + K3 in the
    backward) and waits for them after it; the fp32 dK/dV riders go
    after their fold.  The output and (dq, dk, dv) still equal JAX's."""
    A = inputs(2, 32, 4, 2, seg=True, seed=21)
    kw = {"use_flash": True}
    if schedule == "zigzag":
        A = {k: np.asarray(pring.zigzag_shard(v, WORLD))
             for k, v in A.items()}
        kw["schedule"] = "zigzag"
    push(cluster, "A", A)
    run = RUN.format(sizes={"sp": 4}, fn="ring_attention", kw=kw)
    body = "\n".join("    " + ln for ln in run.strip().splitlines())
    order = every_rank(cluster, RECORD.format(run=body))
    folds = 4 if schedule == "zigzag" else 1
    assert order == _hop_order(WORLD, folds, folds, 3)
    want = jax_run(A, {"sp": 4}, jring.ring_attention,
                   use_flash=schedule == "zigzag",
                   **({"schedule": "zigzag"} if schedule == "zigzag"
                      else {}))
    check(pull0(cluster, "res"), want)
