"""The port's serving on a mesh against the JAX package's, on the CPU: a
module-scoped 4-rank gloo world of the port's workers, every rank
running the same ``DecodeServer`` / ``generate`` cell on its shard, held
to the JAX package on 4 of its 8 virtual CPU devices with the same
numpy parameters and the same mesh.

Mirrors ``tests/unit/test_decode.py:99,390-487`` (tp kernel routing;
generate, speculative decoding and the server on sp),
``tests/unit/test_generate.py:120,303`` (generate on dp x tp, int8 KV
on tp) and ``tests/unit/test_serving.py:695`` (prefix caching on
dp x tp), plus the paged pool, interleaved chunked prefill and the MoE
server on an ep mesh.  Greedy tokens are compared exactly; a
replicated tree and a tp-split tree give the same tokens.
"""

import ast
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbdistributed_tpu.models import moe as jmoe
from nbdistributed_tpu.models import transformer as jtf
from nbdistributed_tpu.models.generate import generate as jgenerate
from nbdistributed_tpu.models.serving import DecodeServer as JaxServer
from nbdistributed_tpu.models.speculative import \
    speculative_generate as jspec
from nbdistributed_tpu.parallel import mesh as jmesh
from nbdistributed_tpu.parallel.tensor_parallel import apply_shardings as jput
from nbdistributed_tpu_torch.manager import ProcessManager, wait_until_ready
from nbdistributed_tpu_torch.messaging.codec import flatten_pytree_wire
from nbdistributed_tpu_torch.messaging.coordinator import \
    CommunicationManager

pytestmark = [pytest.mark.integration]

# The module (the package's ``generate`` name is the function).
jgen_mod = importlib.import_module("nbdistributed_tpu.models.generate")
WORLD = 4
DEVS = jax.devices()[:WORLD]
REQS = [([5, 9, 2], 6), ([7, 1, 3, 11], 5), ([2, 2, 8, 1, 9, 4, 4], 4)]


@pytest.fixture(scope="module")
def cluster():
    comm = CommunicationManager(num_workers=WORLD, timeout=120)
    pm = ProcessManager()
    pm.add_death_callback(lambda rank, rc: comm.mark_worker_dead(rank))
    try:
        pm.start_workers(WORLD, comm.port, backend="cpu")
        wait_until_ready(comm, pm, 120, poll_s=0.5)
        cell(comm, SETUP_CELL)
    except Exception:
        pm.shutdown()
        comm.shutdown()
        raise
    yield comm
    comm.post(list(range(WORLD)), "shutdown")
    pm.shutdown()
    comm.shutdown()


# Every rank: the port's names, and a staggered drive of a server — the
# first request, one step, the rest, then until done.
SETUP_CELL = """
torch.set_num_threads(1)
from nbdistributed_tpu_torch.models import *

def drive(srv, reqs, prefixes=()):
    for p in prefixes:
        srv.cache_prefix(p)
    rids = [srv.submit(*reqs[0])]
    srv.step()
    rids += [srv.submit(*r) for r in reqs[1:]]
    srv.run_until_done(max_steps=200)
    return [srv.outputs[r] for r in rids]
"""


def jax_drive(srv, reqs, prefixes=()):
    for p in prefixes:
        srv.cache_prefix(p)
    rids = [srv.submit(*reqs[0])]
    srv.step()
    rids += [srv.submit(*r) for r in reqs[1:]]
    srv.run_until_done(max_steps=200)
    return [srv.outputs[r] for r in rids]


def cell(comm, code):
    """Run ``code`` on every rank; {rank: echoed output} (errors fail)."""
    r = comm.send_to_all("execute", code, timeout=120)
    errs = {k: (m.data["error"], m.data.get("traceback"))
            for k, m in r.items() if "error" in m.data}
    assert not errs, errs
    return {k: m.data.get("output") for k, m in r.items()}


def every_rank(comm, code):
    """The value of ``code``'s last expression, which must be the same
    on every rank (the ranks' host state is one)."""
    out = {r: ast.literal_eval(o) for r, o in cell(comm, code).items()}
    assert all(v == out[0] for v in out.values()), out
    return out[0]


def push(comm, name, tree):
    meta, bufs = flatten_pytree_wire(tree)
    r = comm.send_to_all("set_var", {"name": name, "pytree": meta},
                         bufs=bufs)
    assert all(m.data.get("status") == "set" for m in r.values())


def jax_mesh(sizes):
    return jmesh.make_mesh(sizes, devices=DEVS)


@pytest.fixture(scope="module")
def dense(cluster):
    jcfg = jtf.tiny_config(dtype=jnp.float32)
    tree = jax.tree.map(np.asarray,
                        jtf.init_params(jax.random.PRNGKey(0), jcfg))
    push(cluster, "tree", tree)
    cell(cluster, "cfg = tiny_config(dtype=torch.float32)\n"
                  "full = params_from_jax(tree, cfg, device='cpu')")
    return jcfg, jax.tree.map(jnp.asarray, tree)


def port_params(sizes):
    """The cell expression of the tree a mesh serves: tp-split where the
    mesh has tp."""
    return ("apply_shardings(full, m, param_shardings(cfg))"
            if "tp" in sizes else "full")


def jax_params(jparams, jcfg, sizes):
    jm = jax_mesh(sizes)
    if "tp" in sizes:
        jparams = jput(jparams, jm, jtf.param_shardings(jcfg))
    return jm, jparams


MESHES = [{"dp": 2, "sp": 2}, {"tp": 2, "sp": 2}, {"dp": 2, "tp": 2}]


@pytest.mark.parametrize("sizes", MESHES, ids=str)
def test_server_on_mesh_matches_jax_server(cluster, dense, sizes):
    """The dense pool on dp x sp, tp x sp and dp x tp
    (``test_decode.py:463``): staggered requests, the JAX server's tokens
    on the same mesh (which the JAX tests hold to solo decode)."""
    jcfg, jparams = dense
    got = every_rank(cluster, f"""
m = make_mesh({sizes!r})
drive(DecodeServer({port_params(sizes)}, cfg, max_batch=2, max_len=32,
                   pad_to=4, mesh=m), {REQS!r})""")
    jm, jp = jax_params(jparams, jcfg, sizes)
    want = jax_drive(JaxServer(jp, jcfg, max_batch=2, max_len=32, pad_to=4,
                               mesh=jm), REQS)
    assert got == want


@pytest.mark.parametrize("kind", ["int8_kv", "paged", "interleaved"])
def test_server_modes_on_mesh_match_jax(cluster, dense, kind):
    """An int8 cache on dp x tp (``test_generate.py:303``), the paged
    pool (heads split over tp; blocks of 8) and interleaved chunked
    prefill (chunks of 4) on dp x sp: the JAX server's tokens."""
    jcfg, jparams = dense
    sizes = {"dp": 2, "sp": 2} if kind == "interleaved" else \
        {"dp": 2, "tp": 2}
    kw = {"int8_kv": dict(kv_quantized=True),
          "paged": dict(kv_block_tokens=8),
          "interleaved": dict(prefill_chunk=4,
                              interleave_prefill=True)}[kind]
    got = every_rank(cluster, f"""
m = make_mesh({sizes!r})
drive(DecodeServer({port_params(sizes)}, cfg, max_batch=2, max_len=32,
                   pad_to=4, mesh=m, **{kw!r}), {REQS!r})""")
    jm, jp = jax_params(jparams, jcfg, sizes)
    want = jax_drive(JaxServer(jp, jcfg, max_batch=2, max_len=32, pad_to=4,
                               mesh=jm, **kw), REQS)
    assert got == want


def test_prefix_cache_on_dp_tp_mesh(cluster, dense):
    """``test_serving.py:695``: a cached prefix on dp x tp (its buffer
    split over tp only) admits by copy into dp-split slots: the JAX
    server's tokens with the same prefix on the same mesh."""
    jcfg, jparams = dense
    prefix = [3, 1, 4, 1, 5, 9]
    reqs = [(prefix + [2, 6], 5), (prefix + [8], 5), ([9, 9], 5)]
    sizes = {"dp": 2, "tp": 2}
    got = every_rank(cluster, f"""
m = make_mesh({sizes!r})
drive(DecodeServer({port_params(sizes)}, cfg, max_batch=2, max_len=32,
                   pad_to=4, mesh=m), {reqs!r}, [{prefix!r}])""")
    jm, jp = jax_params(jparams, jcfg, sizes)
    want = jax_drive(JaxServer(jp, jcfg, max_batch=2, max_len=32, pad_to=4,
                               mesh=jm), reqs, [prefix])
    assert got == want


def test_speculative_on_sp_mesh_matches_jax(cluster, dense):
    """``test_decode.py:438``: batched speculative decoding with both
    caches split over dp x sp (draft steps through the sp-combined
    kernel, the verify through per-slice attention), the JAX result and
    every proposal of a self-draft accepted; and a speculative server
    on the same mesh, which gives the plain server's tokens."""
    jcfg, jparams = dense
    prompt = np.random.default_rng(7).integers(0, 512, (2, 6))
    got = every_rank(cluster, f"""
m = make_mesh({{"dp": 2, "sp": 2}})
toks, acc = speculative_generate(full, full, torch.tensor({prompt.tolist()}),
                                 cfg, cfg, 8, gamma=3, mesh=m, max_len=32)
srv = lambda **kw: DecodeServer(full, cfg, max_batch=2, max_len=32,
                               pad_to=4, mesh=m, **kw)
(toks.tolist(), acc, drive(srv(draft_params=full, draft_cfg=cfg, gamma=3),
                           {REQS!r}), drive(srv(), {REQS!r}))""")
    jm = jax_mesh({"dp": 2, "sp": 2})
    want, acc = jspec(jparams, jparams, jnp.asarray(prompt), jcfg, jcfg, 8,
                      gamma=3, mesh=jm, max_len=32)
    assert got[0] == np.asarray(want).tolist()
    assert got[1] == float(acc) == 3.0
    assert got[2] == got[3]


def test_generate_on_meshes_and_tree_layouts(cluster, dense):
    """``test_decode.py:99,390`` and ``test_generate.py:120``: generate on
    dp x sp and on tp x sp with a tp-split tree and with a whole one
    (each rank cuts its heads), the JAX mesh run's tokens."""
    jcfg, jparams = dense
    prompt = np.random.default_rng(3).integers(0, 512, (2, 6))
    got = every_rank(cluster, f"""
outs = []
for sizes in ({{"dp": 2, "sp": 2}}, {{"tp": 2, "sp": 2}}):
    m = make_mesh(sizes)
    for ps in (full, apply_shardings(full, m, param_shardings(cfg))
               if "tp" in sizes else full):
        outs.append(generate(ps, torch.tensor({prompt.tolist()}), cfg, 10,
                             mesh=m, max_len=32).tolist())
outs""")
    jm, jp = jax_params(jparams, jcfg, {"tp": 2, "sp": 2})
    want = np.asarray(jgenerate(jp, jnp.asarray(prompt), jcfg, 10, mesh=jm,
                                max_len=32)).tolist()
    assert all(g == want for g in got)


@pytest.fixture(scope="module")
def moe(cluster):
    jcfg = jmoe.tiny_moe_config(dtype=jnp.float32, capacity_factor=2.0)
    tree = jax.tree.map(np.asarray,
                        jmoe.init_moe_model(jax.random.PRNGKey(0), jcfg))
    push(cluster, "mtree", tree)
    cell(cluster, "mcfg = tiny_moe_config(dtype=torch.float32, "
                  "capacity_factor=2.0)\n"
                  "mfull = params_from_jax(mtree, mcfg, device='cpu')")
    return jcfg, jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("mode", ["dense", "dropless"])
def test_moe_server_on_ep_mesh_matches_jax(cluster, moe, mode):
    """Mixtral-style serving with the experts split over ep=4: each rank
    computes its expert's share, one psum over ep; the JAX server's
    tokens on the same mesh (dropless: the hierarchical shard-capacity
    path)."""
    jcfg, jparams = moe
    got = every_rank(cluster, f"""
import dataclasses
m = make_mesh({{"ep": 4}})
c = dataclasses.replace(mcfg, moe_dispatch={mode!r})
ps = apply_shardings(mfull, m, moe_model_shardings(c, tp_axis=None))
drive(DecodeServer(ps, c, max_batch=2, max_len=32, mesh=m), {REQS!r})""")
    c = dataclasses.replace(jcfg, moe_dispatch=mode)
    jm = jax_mesh({"ep": 4})
    jp = jput(jparams, jm, jmoe.moe_model_shardings(c, tp_axis=None))
    want = jax_drive(JaxServer(jp, c, max_batch=2, max_len=32, mesh=jm),
                     REQS)
    assert got == want


def test_moe_generate_on_tp_sp_mesh(cluster, moe):
    """The MoE family on tp x sp (attention split, experts whole): JAX's
    tokens."""
    jcfg, jparams = moe
    prompt = np.random.default_rng(2).integers(0, 512, (2, 6))
    got = every_rank(cluster, f"""
m = make_mesh({{"tp": 2, "sp": 2}})
ps = apply_shardings(mfull, m, moe_model_shardings(mcfg, ep_axis=None))
generate(ps, torch.tensor({prompt.tolist()}), mcfg, 8, mesh=m,
         max_len=16).tolist()""")
    want = jgenerate(jparams, jnp.asarray(prompt), jcfg, 8)
    assert got == np.asarray(want).tolist()


def test_decode_kernel_on_tp_mesh(cluster):
    """``test_decode.py:99``: on a 4-way tp mesh (8 heads, 4 KV heads)
    the einsum config never touches the decode kernel's wrapper and the
    ``use_flash`` config decodes through it on every rank; both give the
    JAX mesh run's tokens."""
    jcfg = jtf.tiny_config(dtype=jnp.float32, n_heads=8, n_kv_heads=4,
                           use_flash=False)
    tree = jax.tree.map(np.asarray,
                        jtf.init_params(jax.random.PRNGKey(0), jcfg))
    push(cluster, "tree8", tree)
    prompt = [[5, 9, 2], [7, 1, 3]]
    got = every_rank(cluster, f"""
import dataclasses, sys
from nbdistributed_tpu_torch.models import generate as G
gen_mod = sys.modules["nbdistributed_tpu_torch.models.generate"]
real, calls = gen_mod.flash_decode_attention, []
gen_mod.flash_decode_attention = lambda *a, **k: calls.append(1) or \\
    real(*a, **k)
c8 = tiny_config(dtype=torch.float32, n_heads=8, n_kv_heads=4)
m = make_mesh({{"tp": 4}})
p8 = apply_shardings(params_from_jax(tree8, c8, device="cpu"), m,
                     param_shardings(c8))
out = []
for flash in (False, True):
    calls.clear()
    toks = G(p8, torch.tensor({prompt}), dataclasses.replace(
        c8, use_flash=flash), 10, mesh=m).tolist()
    out.append((toks, len(calls)))
gen_mod.flash_decode_attention = real
out""")
    jm = jax_mesh({"tp": 4})
    jp = jput(jax.tree.map(jnp.asarray, tree), jm, jtf.param_shardings(jcfg))
    want = np.asarray(jgenerate(jp, jnp.asarray(prompt), jcfg, 10,
                                mesh=jm)).tolist()
    (einsum, n_einsum), (flash, n_flash) = got
    assert einsum == flash == want
    assert n_einsum == 0 and n_flash == 2 * 9    # layers x decode steps


# ----------------------------------------------------------------------
# ROADMAP C2 and C3: axes that do not divide, and dropless prefill blocks

def test_generate_odd_batch_on_dp_matches_jax(cluster, dense):
    """C2: 3 rows on dp2 x tp2 — the rows held whole on both dp ranks
    (tp still splitting the heads): the tokens of the JAX package's
    replicated einsum on the same mesh (its cache's batch held whole;
    its own ``generate`` cannot place a dp-split cache of 3 rows)."""
    jcfg, jparams = dense
    prompt = np.random.default_rng(9).integers(0, 512, (3, 5))
    sizes = {"dp": 2, "tp": 2}
    got = every_rank(cluster, f"""
m = make_mesh({sizes!r})
generate(apply_shardings(full, m, param_shardings(cfg)),
         torch.tensor({prompt.tolist()}), cfg, 6, mesh=m).tolist()""")
    jm, jp = jax_params(jparams, jcfg, sizes)
    B, S0 = prompt.shape
    cache = jgen_mod.init_kv_cache(
        jcfg, B, S0 + 6, mesh=jm,
        rules=jgen_mod.kv_cache_shardings(dp_axis=None, tp_axis="tp"))
    logits, cache = jgen_mod.forward_with_cache(
        jp, jnp.asarray(prompt), cache, 0, jcfg, last_only=True, mesh=jm)
    toks = [jnp.argmax(logits[:, -1], -1)]
    for i in range(5):
        logits, cache = jgen_mod.forward_with_cache(
            jp, toks[-1][:, None], cache, S0 + i, jcfg, mesh=jm)
        toks.append(jnp.argmax(logits[:, -1], -1))
    want = np.concatenate([prompt, np.stack([np.asarray(t) for t in toks],
                                            1)], 1).tolist()
    assert got == want
    assert want == np.asarray(jgenerate(jparams, jnp.asarray(prompt), jcfg,
                                        6)).tolist()


@pytest.mark.parametrize("sizes,kw", [
    ({"tp": 4}, dict(max_batch=2, max_len=32)),
    ({"dp": 2, "sp": 2}, dict(max_batch=3, max_len=31)),
    ({"dp": 2, "tp": 2}, dict(max_batch=3, max_len=32,
                              kv_block_tokens=8))],
    ids=["heads_over_tp4", "batch_and_len_over_dp2_sp2", "paged_dp2_tp2"])
def test_server_with_indivisible_axes_matches_jax(cluster, dense, sizes,
                                                   kw):
    """C2 for the server: 2 KV heads on tp4 (every head on every rank),
    3 slots on dp2 and 31 positions on sp2 (rows and tokens whole), and
    the paged pool with 3 slots: the JAX server's tokens (unsharded: its
    mesh server cannot place such a pool)."""
    jcfg, jparams = dense
    got = every_rank(cluster, f"""
m = make_mesh({sizes!r})
drive(DecodeServer({port_params(sizes)}, cfg, pad_to=4, mesh=m, **{kw!r}),
      {REQS!r})""")
    want = jax_drive(JaxServer(jparams, jcfg, pad_to=4, **kw), REQS)
    assert got == want


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_moe_dropless_prefill_blocks_on_dp_ep_match_jax(cluster, moe, paged):
    """C3: Mixtral-style dropless serving on dp2 x ep2 at a tight
    capacity factor (1.0), where the shard capacity drops rows: a
    prefill (a whole row on its dp slice's ranks) and a paged decode
    step (every row on every rank) route their tokens as dp blocks, each
    with its own shard capacity, as JAX's flattened-token sharding
    does: the JAX server's tokens on the same mesh."""
    jcfg, jparams = moe
    kw = dict(max_batch=2, max_len=32,
              **(dict(kv_block_tokens=8) if paged else {}))
    reqs = [([5, 9, 2, 7, 1, 3, 11, 4], 6), ([7, 1, 3, 11, 2, 2], 5),
            ([2, 2, 8, 1, 9, 4, 4, 6, 1, 3], 4)]
    got = every_rank(cluster, f"""
import dataclasses
m = make_mesh({{"dp": 2, "ep": 2}})
c = dataclasses.replace(mcfg, moe_dispatch="dropless", capacity_factor=1.0)
ps = apply_shardings(mfull, m, moe_model_shardings(c, tp_axis=None))
drive(DecodeServer(ps, c, mesh=m, **{kw!r}), {reqs!r})""")
    c = dataclasses.replace(jcfg, moe_dispatch="dropless",
                            capacity_factor=1.0)
    jm = jax_mesh({"dp": 2, "ep": 2})
    jp = jput(jparams, jm, jmoe.moe_model_shardings(c, tp_axis=None))
    want = jax_drive(JaxServer(jp, c, mesh=jm, **kw), reqs)
    assert got == want
