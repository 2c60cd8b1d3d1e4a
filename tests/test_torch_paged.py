"""Paged KV serving in the port against the JAX package on the CPU: the
block allocator (the same decisions from the same event stream), the
gather / scatter between the block pool and the dense view, and the
paged ``DecodeServer``, whose greedy tokens must equal the JAX paged
server's and solo ``generate``'s at ``tiny_config`` float32.

The JAX servers run ``use_flash=False`` except in one case, where JAX's
decode kernel runs in interpret mode and the port's flash-decode wrapper
takes its plain version on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbdistributed_tpu.models import paged_kv as jpaged
from nbdistributed_tpu.models import transformer as jtf
from nbdistributed_tpu.models.generate import generate as jgenerate
from nbdistributed_tpu.models.serving import DecodeServer as JaxServer
from nbdistributed_tpu.serving_fast import paging as jpaging
from nbdistributed_tpu_torch.models import (DecodeServer, generate,
                                            params_from_jax, tiny_config)
from nbdistributed_tpu_torch.models import paged_kv
from nbdistributed_tpu_torch.serving_fast import paging


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = jtf.tiny_config(dtype=jnp.float32, use_flash=False)
    tree = jax.tree.map(np.asarray,
                        jtf.init_params(jax.random.PRNGKey(0), jcfg))
    cfg = tiny_config(dtype=torch.float32)
    return (jcfg, jax.tree.map(jnp.asarray, tree), cfg,
            params_from_jax(tree, cfg, device="cpu"))


def solo(params, cfg, prompt, n, **kw):
    return generate(params, [prompt], cfg, n, **kw)[0, len(prompt):].tolist()


def jax_solo(jparams, jcfg, prompt, n, **kw):
    out = jgenerate(jparams, jnp.asarray([prompt], jnp.int32), jcfg, n, **kw)
    return [int(t) for t in np.asarray(out)[0][len(prompt):]]


# ----------------------------------------------------------------------
# the allocator


def _alloc_stream(seed, n_events=400):
    """A seeded random stream of alloc / extend / free / defrag events."""
    rng = np.random.default_rng(seed)
    for _ in range(n_events):
        kind = rng.choice(["alloc", "alloc", "extend", "free", "defrag"],
                          p=[0.3, 0.2, 0.2, 0.25, 0.05])
        yield str(kind), f"r{int(rng.integers(0, 12))}", int(
            rng.integers(0, 6))


def _apply(alloc, event):
    """Run one event; returns its outcome (result or exception name)."""
    kind, owner, n = event
    try:
        if kind == "alloc":
            return alloc.alloc(owner, n)
        if kind == "extend":
            return alloc.extend(owner, n)
        if kind == "free":
            return alloc.free(owner)
        return alloc.defrag()
    except (paging.BlocksExhausted, jpaging.BlocksExhausted) as e:
        return ("exhausted", e.need, e.free)
    except (ValueError, KeyError) as e:
        return type(e).__name__


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_decides_as_jax_over_a_random_stream(seed):
    ours, theirs = paging.BlockAllocator(24, 8), jpaging.BlockAllocator(24, 8)
    for i, event in enumerate(_alloc_stream(seed)):
        assert _apply(ours, event) == _apply(theirs, event), (i, event)
        if i % 10 == 9:
            ours.check()
            theirs.check()
            assert ours.snapshot() == theirs.snapshot()
            for owner in theirs.owners():
                assert ours.table(owner) == theirs.table(owner)
    assert ours._free == theirs._free


def test_allocator_surface():
    a = paging.BlockAllocator(4, 8)
    assert [paging.blocks_needed(t, 8) for t in (-3, 0, 1, 8, 9)] == \
        [0, 0, 1, 1, 2]
    assert a.alloc("x", 3) == [0, 1, 2] and not a.can_fit(9)
    with pytest.raises(paging.BlocksExhausted) as e:
        a.alloc("y", 2)
    assert (e.value.need, e.value.free) == (2, 1)
    with pytest.raises(ValueError, match="already"):
        a.alloc("x", 1)
    a.reset()
    assert a.free_blocks == 4 and a.largest_free_run() == 4
    with pytest.raises(ValueError, match="n_blocks"):
        paging.BlockAllocator(0, 8)


# ----------------------------------------------------------------------
# gather / scatter


def _pool(quantized, seed=0, L=2, NB=6, hkv=2, bt=4, D=8):
    rng = np.random.default_rng(seed)
    if quantized:
        return {"k": rng.integers(-127, 128, (L, NB + 1, hkv, bt, D),
                                  dtype=np.int8),
                "k_s": rng.random((L, NB + 1, hkv, bt, 1), np.float32)}
    return {"k": rng.standard_normal((L, NB + 1, hkv, bt, D),
                                     dtype=np.float32),
            "v": rng.standard_normal((L, NB + 1, hkv, bt, D),
                                     dtype=np.float32)}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


TABLE = np.array([[3, 0, 6], [1, 5, 6], [6, 6, 6]], np.int32)   # 6 = trash


@pytest.mark.parametrize("quantized", [False, True])
def test_gather_dense_matches_jax_and_scatter_row_is_identity(quantized):
    pool = _pool(quantized)
    got = paged_kv.gather_dense(_torch(pool), torch.from_numpy(TABLE))
    want = jpaged.gather_dense(jax.tree.map(jnp.asarray, pool),
                               jnp.asarray(TABLE))
    for name in pool:
        assert got[name].is_contiguous()
        assert np.array_equal(got[name].numpy(), np.asarray(want[name]))
    # gather then scatter of an owned row leaves the pool as it was.
    tp = _torch(pool)
    row_ids = torch.from_numpy(TABLE[1])
    paged_kv.scatter_row(tp, paged_kv.gather_row(tp, row_ids), row_ids)
    for name in pool:
        assert np.array_equal(tp[name].numpy(), pool[name])


def test_scatter_step_writes_one_block_per_slot_like_jax():
    pool = _pool(False)
    dense = jax.tree.map(
        lambda c: np.random.default_rng(3).standard_normal(
            (c.shape[0], 3, c.shape[2], 3 * c.shape[3], c.shape[4])
        ).astype(np.float32), pool)
    pos = np.array([5, 2, 9], np.int32)         # blocks 1, 0, 2
    active = np.array([True, True, False])
    got = paged_kv.scatter_step(_torch(pool), _torch(dense),
                                torch.from_numpy(TABLE),
                                torch.from_numpy(pos),
                                torch.from_numpy(active), 6, 4)
    want = jpaged.scatter_step(
        jax.tree.map(jnp.asarray, pool), jax.tree.map(jnp.asarray, dense),
        jnp.asarray(TABLE), jnp.asarray(pos), jnp.asarray(active), 6, 4)
    for name in pool:
        g, w = got[name].numpy(), np.asarray(want[name])
        assert np.array_equal(g[:, :6], w[:, :6])   # all but trash
        changed = np.nonzero((g[:, :6] != pool[name][:, :6]).any(
            axis=(0, 2, 3, 4)))[0].tolist()
        assert changed == [0, 1]      # slot 0's block 1, slot 1's block 0


def test_apply_moves_matches_jax():
    pool = _pool(True)
    moves = {4: 0, 5: 1, 0: 4}
    got = paged_kv.apply_moves(_torch(pool), moves)
    want = jpaged.apply_moves(jax.tree.map(jnp.asarray, pool), moves)
    for name in pool:
        assert np.array_equal(got[name].numpy(), np.asarray(want[name]))


# ----------------------------------------------------------------------
# the paged server


def _staggered(srv):
    reqs = [([5, 9, 2], 7), ([7, 1, 3, 11, 4], 5), ([2, 2], 6)]
    r0 = srv.submit(*reqs[0])
    srv.step()
    r1 = srv.submit(*reqs[1])
    srv.step()
    r2 = srv.submit(*reqs[2])          # queues until a slot frees
    srv.run_until_done(max_steps=100)
    return reqs, [srv.outputs[r] for r in (r0, r1, r2)]


def _starved(srv):
    reqs = [([i + 1, i + 2], 4) for i in range(4)]
    rids = [srv.submit(*r) for r in reqs]
    assert srv.kv_snapshot()["used"] == 1   # one admitted, three wait
    srv.run_until_done(max_steps=200)
    return reqs, [srv.outputs[r] for r in rids]


def _interleaved(srv):
    short = ([5, 9, 2], 6)
    long = ([7, 1, 3, 11, 4, 2, 8, 6, 1, 9, 4, 4, 2, 7], 5)
    r_short = srv.submit(*short)
    srv.step()
    r_long = srv.submit(*long)         # one chunk per step
    assert srv.prefill_progress() == {r_long: (0, 14)}
    srv.step()
    assert srv.prefill_progress() == {r_long: (4, 14)}
    srv.run_until_done(max_steps=100)
    return [short, long], [srv.outputs[r_short], srv.outputs[r_long]]


SCENARIOS = {
    "staggered": (_staggered, dict(max_batch=2, max_len=32,
                                   kv_block_tokens=8)),
    "block_starved": (_starved, dict(max_batch=2, max_len=16,
                                     kv_block_tokens=8, kv_blocks=1)),
    "int8_kv": (_staggered, dict(max_batch=2, max_len=32,
                                 kv_block_tokens=8, kv_quantized=True)),
    "interleaved_chunked": (_interleaved, dict(
        max_batch=2, max_len=32, kv_block_tokens=8, prefill_chunk=4,
        interleave_prefill=True)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_paged_server_matches_jax_server_and_solo(setup, name):
    jcfg, jparams, cfg, params = setup
    drive, kw = SCENARIOS[name]
    reqs, got = drive(DecodeServer(params, cfg, pad_to=4, **kw))
    _, want = drive(JaxServer(jparams, jcfg, pad_to=4, **kw))
    assert got == want
    q = kw.get("kv_quantized", False)
    for out, (prompt, n) in zip(got, reqs):
        assert out == solo(params, cfg, prompt, n, kv_quantized=q)


def test_paged_server_against_jax_decode_kernel(setup):
    """JAX's paged server through its Pallas decode kernel (interpret
    mode) and the port's through the flash-decode wrapper's plain
    version give the same tokens, which equal the JAX solo run's."""
    jcfg, jparams, cfg, params = setup
    kw = dict(max_batch=2, max_len=24, kv_block_tokens=4, pad_to=4)
    reqs = [([5, 9, 2, 8], 6), ([7, 1], 5)]
    servers = (DecodeServer(params, cfg, **kw),
               JaxServer(jparams, dataclasses.replace(jcfg, use_flash=True),
                         **kw))
    outs = []
    for srv in servers:
        rids = [srv.submit(*r) for r in reqs]
        srv.run_until_done(max_steps=50)
        outs.append([srv.outputs[r] for r in rids])
    assert outs[0] == outs[1]
    assert outs[0] == [jax_solo(jparams, jcfg, p, n) for p, n in reqs]


def test_paged_step_reads_the_host_once(setup, monkeypatch):
    """A paged decode step reads one tensor on the host (its tokens):
    the table is cached on the device and the positions never leave
    it."""
    _, _, cfg, params = setup
    srv = DecodeServer(params, cfg, max_batch=2, max_len=32, pad_to=4,
                       kv_block_tokens=8)
    srv.submit([5, 9, 2], 8)
    srv.submit([7, 1], 8)
    srv.step()
    reads = []

    def counted(name, orig):
        return lambda *a, **k: reads.append(name) or orig(*a, **k)

    for name in ("item", "tolist", "numpy", "__int__", "__index__",
                 "__bool__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name,
                            counted(name, getattr(torch.Tensor, name)))
    srv.step()
    srv.step()
    monkeypatch.undo()
    assert reads == ["tolist", "tolist"]


def test_cancel_frees_blocks_and_snapshot(setup):
    _, _, cfg, params = setup
    srv = DecodeServer(params, cfg, max_batch=1, max_len=16, pad_to=4,
                       kv_block_tokens=8, kv_blocks=1)
    r0 = srv.submit([5, 9], 6)              # 8 tokens: the whole pool
    srv.step()
    snap = srv.kv_snapshot()
    assert (snap["used"], snap["free"], snap["owners"]) == (1, 0, {"0": 1})
    assert srv.cancel(r0) is True and srv.kv_snapshot()["used"] == 0
    assert srv.cancel(r0) is False
    r1 = srv.submit([3, 1], 4)
    srv.run_until_done(max_steps=50)
    assert srv.outputs[r1] == solo(params, cfg, [3, 1], 4)
    assert DecodeServer(params, cfg, max_batch=1,
                        max_len=16).kv_snapshot() is None
    dflt = DecodeServer(params, cfg, max_batch=2, max_len=16,
                        kv_block_tokens=4).kv_snapshot()
    assert dflt["blocks"] == 2 * (16 // 4) and dflt["block_tokens"] == 4


def test_cancel_mid_prefill_frees_the_slot_and_blocks(setup):
    _, _, cfg, params = setup
    srv = DecodeServer(params, cfg, max_batch=1, max_len=32, pad_to=4,
                       kv_block_tokens=8, prefill_chunk=4,
                       interleave_prefill=True)
    rid = srv.submit(list(range(1, 15)), 4)
    srv.step()
    assert srv.prefill_progress() == {rid: (4, 14)}
    with pytest.raises(ValueError, match="in flight"):
        srv.release(rid)
    assert srv.cancel(rid) and srv.prefill_progress() == {}
    assert srv.kv_snapshot()["used"] == 0 and srv.done()
    r1 = srv.submit([4, 4, 2], 5)
    srv.run_until_done(max_steps=50)
    assert srv.outputs[r1] == solo(params, cfg, [4, 4, 2], 5)


@pytest.mark.parametrize("kwargs,match", [
    (dict(kv_block_tokens=0), "kv_block_tokens"),
    (dict(kv_blocks=4), "kv_blocks"),
    (dict(interleave_prefill=True), "interleave_prefill"),
    (dict(kv_block_tokens=4, draft_cfg="draft", draft_params={}),
     "speculative"),
])
def test_paged_validation(setup, kwargs, match):
    _, _, cfg, params = setup
    if kwargs.get("draft_cfg") == "draft":
        kwargs = dict(kwargs, draft_cfg=cfg)
    with pytest.raises(ValueError, match=match):
        DecodeServer(params, cfg, max_batch=1, max_len=16, **kwargs)


def test_paged_server_refuses_prefix_and_step_many(setup):
    _, _, cfg, params = setup
    srv = DecodeServer(params, cfg, max_batch=1, max_len=16,
                       kv_block_tokens=4)
    with pytest.raises(ValueError, match="not paged"):
        srv.cache_prefix([1, 2])
    srv.submit([1, 2], 3)
    with pytest.raises(ValueError, match="dense-pool"):
        srv.step_many(2)
