"""The port's mesh layer against the JAX package's mesh runs, on the CPU:
one module-scoped 4-rank gloo world of the port's workers
(``ProcessManager(backend="cpu")``) beside the JAX package on 4 of its
8 virtual CPU devices (``tests/conftest.py``), K4 in interpret mode.

Mirrors the JAX mesh tests of the layers under serving:
``tests/unit/test_model.py:131-136`` (the mesh builder),
``tests/unit/test_decode.py:316-487`` (the sp-sharded decode kernel:
a window, an int8 cache, a partial final block, a window wholly past a
shard), ``tests/unit/test_generate.py:162`` (the cache layout),
``tests/unit/test_quant.py:89,123,246`` (quantized tp and ep trees)
and ``tests/unit/test_expert.py:170,253,468-626`` (the ep dispatch
modes, the shard overflow dropping only the tail, a token mask, the
indivisible experts).  Both sides take the same numpy parameters: the
test process pushes the JAX tree as numpy arrays over the control plane
(``set_var``), and each worker converts it (``params_from_jax``) and
cuts its shard (``apply_shardings``); the workers import no JAX.

Tolerances: shards exactly JAX's; ``_flash_decode_on_mesh`` and the
logits of ``forward_with_cache`` within 1e-5 relative L2 of JAX's; the
expert layer within 1e-5 (absolute and relative).
"""

import ast
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from nbdistributed_tpu.models import moe as jmoe
from nbdistributed_tpu.models import quant as jquant
from nbdistributed_tpu.models import transformer as jtf
from nbdistributed_tpu.ops.decode import flash_decode_attention as jdecode
from nbdistributed_tpu.parallel import expert as jexp
from nbdistributed_tpu.parallel import mesh as jmesh
from nbdistributed_tpu.parallel.tensor_parallel import apply_shardings as jput
from nbdistributed_tpu_torch.manager import ProcessManager, wait_until_ready
from nbdistributed_tpu_torch.messaging.codec import (flatten_pytree_wire,
                                                     unflatten_pytree_wire)
from nbdistributed_tpu_torch.messaging.coordinator import \
    CommunicationManager

pytestmark = [pytest.mark.integration]

# The module (the package's ``generate`` name is the function).
jgen = importlib.import_module("nbdistributed_tpu.models.generate")
WORLD = 4
DEVS = jax.devices()[:WORLD]


@pytest.fixture(scope="module")
def cluster():
    comm = CommunicationManager(num_workers=WORLD, timeout=120)
    pm = ProcessManager()
    pm.add_death_callback(lambda rank, rc: comm.mark_worker_dead(rank))
    try:
        pm.start_workers(WORLD, comm.port, backend="cpu")
        wait_until_ready(comm, pm, 120, poll_s=0.5)
        cell(comm, "torch.set_num_threads(1)\n"
                   "from nbdistributed_tpu_torch.models import *\n"
                   "from nbdistributed_tpu_torch.models.generate import "
                   "_flash_decode_on_mesh\n"
                   "from nbdistributed_tpu_torch.parallel import expert")
    except Exception:
        pm.shutdown()
        comm.shutdown()
        raise
    yield comm
    comm.post(list(range(WORLD)), "shutdown")
    pm.shutdown()
    comm.shutdown()


def cell(comm, code):
    """Run ``code`` on every rank; {rank: echoed output} (errors fail)."""
    r = comm.send_to_all("execute", code, timeout=120)
    errs = {k: (m.data["error"], m.data.get("traceback"))
            for k, m in r.items() if "error" in m.data}
    assert not errs, errs
    return {k: m.data.get("output") for k, m in r.items()}


def push(comm, name, tree):
    meta, bufs = flatten_pytree_wire(tree)
    r = comm.send_to_all("set_var", {"name": name, "pytree": meta},
                         bufs=bufs)
    assert all(m.data.get("status") == "set" for m in r.values())


def pull(comm, name):
    """``name`` from every rank, its leaves as numpy arrays."""
    out = {}
    for r, m in comm.send_to_all("get_var", name).items():
        if "pytree" in m.data:
            out[r] = jax.tree.map(np.asarray, unflatten_pytree_wire(
                m.data["pytree"], m.bufs))
        else:
            out[r] = np.asarray(m.bufs["value"])
    return out


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def coords(jm, rank):
    """Rank ``rank``'s coordinates in the JAX mesh of DEVS."""
    where = np.argwhere(jm.devices == DEVS[rank])[0]
    return dict(zip(jm.axis_names, (int(c) for c in where)))


def jax_shard(arr, rank):
    """Device ``rank``'s shard of a placed JAX array."""
    (s,) = [s for s in arr.addressable_shards if s.device == DEVS[rank]]
    return np.asarray(s.data)


def local_block(x, jm, rank, spec):
    """Rank ``rank``'s block of a whole numpy array under ``spec``."""
    c = coords(jm, rank)
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        n = jm.shape[axis]
        step = x.shape[d] // n
        x = np.take(x, range(c[axis] * step, (c[axis] + 1) * step), axis=d)
    return x


# ----------------------------------------------------------------------
# the mesh builder, its collectives and placement

def test_mesh_builder_layout_wildcard_and_errors(cluster):
    """``test_model.py:131-136``: the -1 wildcard and the refusals, and
    every rank's coordinates where JAX puts its device."""
    out = cell(cluster, """
m = make_mesh({"dp": -1, "tp": 2})
errs = []
for sizes in ({"dp": 3}, {"dp": -1, "tp": -1}, {"dp": 3, "tp": -1}):
    try:
        make_mesh(sizes)
    except ValueError as e:
        errs.append(type(e).__name__)
(m.shape, m.index("dp"), m.index("tp"), errs)""")
    jm = jmesh.make_mesh({"dp": -1, "tp": 2}, devices=DEVS)
    for r in range(WORLD):
        shape, dp, tp, errs = ast.literal_eval(out[r])
        assert shape == dict(jm.shape)
        assert {"dp": dp, "tp": tp} == coords(jm, r)
        assert errs == ["ValueError"] * 3
    for sizes in ({"dp": 3}, {"dp": -1, "tp": -1}, {"dp": 3, "tp": -1}):
        with pytest.raises(ValueError):
            jmesh.make_mesh(sizes, devices=DEVS)


def test_axis_collectives(cluster):
    out = cell(cluster, """
from nbdistributed_tpu_torch.parallel import mesh as M
m = make_mesh({"dp": 2, "tp": 2})
x = torch.tensor([rank + 1.0, 10.0 * rank])
(M.psum(x, m, "dp").tolist(), M.psum(x, m, "tp").tolist(),
 M.pmax(x, m, "tp").tolist(), M.all_gather(x[None], m, "tp", 0).tolist(),
 m.broadcast(x, "dp", 1).tolist(), M.axis_index(m, "tp"),
 shard_batch(torch.arange(8).reshape(4, 2), m).tolist())""")
    jm = jmesh.make_mesh({"dp": 2, "tp": 2}, devices=DEVS)
    at = {tuple(coords(jm, r).values()): r for r in range(WORLD)}
    x = {r: [r + 1.0, 10.0 * r] for r in range(WORLD)}
    for r in range(WORLD):
        dp, tp = coords(jm, r).values()
        got = ast.literal_eval(out[r])
        dps = [x[at[(i, tp)]] for i in range(2)]
        tps = [x[at[(dp, j)]] for j in range(2)]
        assert got[0] == [a + b for a, b in zip(*dps)]
        assert got[1] == [a + b for a, b in zip(*tps)]
        assert got[2] == [max(a, b) for a, b in zip(*tps)]
        assert got[3] == tps
        assert got[4] == x[at[(1, tp)]]
        assert got[5] == tp
        assert got[6] == np.arange(8).reshape(4, 2)[2 * dp:2 * dp + 2].tolist()


@pytest.fixture(scope="module")
def dense(cluster):
    jcfg = jtf.tiny_config(dtype=jnp.float32)
    tree = np_tree(jtf.init_params(jax.random.PRNGKey(0), jcfg))
    push(cluster, "tree", tree)
    cell(cluster, "cfg = tiny_config(dtype=torch.float32)\n"
                  "full = params_from_jax(tree, cfg, device='cpu')")
    return jcfg, tree


def test_apply_shardings_gives_jax_shards(cluster, dense):
    """Every leaf of the tp-split tree, plain and int8
    (``quantized_shardings``), and the cache (``kv_cache_shardings``;
    ``test_generate.py:162``) equal to the shard JAX places on the
    rank's device."""
    jcfg, tree = dense
    cell(cluster, """
m = make_mesh({"dp": 2, "tp": 2})
rules = param_shardings(cfg)
placed = {"plain": apply_shardings(full, m, rules),
          "int8": apply_shardings(quantize_params(full), m,
                                  quantized_shardings(rules))}
cache = init_kv_cache(cfg, 2, 16, mesh=m, quantized=True, device="cpu")
shapes = {k: torch.tensor(v.shape) for k, v in cache.items()}""")
    got, shapes = pull(cluster, "placed"), pull(cluster, "shapes")
    jm = jmesh.make_mesh({"dp": 2, "tp": 2}, devices=DEVS)
    rules = jtf.param_shardings(jcfg)
    jtree = jax.tree.map(jnp.asarray, tree)
    want = {"plain": jput(jtree, jm, rules),
            "int8": jput(jquant.quantize_params(jtree), jm,
                         jquant.quantized_shardings(rules))}
    jcache = jgen.init_kv_cache(jcfg, 2, 16, mesh=jm, quantized=True)
    for r in range(WORLD):
        for kind in want:
            flat_w = jax.tree_util.tree_leaves_with_path(want[kind])
            flat_g = dict(jax.tree_util.tree_leaves_with_path(
                got[r][kind]))
            assert len(flat_w) == len(flat_g)
            for path, leaf in flat_w:
                np.testing.assert_array_equal(flat_g[path],
                                              jax_shard(leaf, r),
                                              err_msg=f"{kind} {path}")
        for name, buf in jcache.items():
            assert tuple(shapes[r][name]) == \
                jax_shard(buf, r).shape


# ----------------------------------------------------------------------
# K4 under sp: _flash_decode_on_mesh

def _decode_inputs(B, H, Hkv, T, D, seed, int8=False):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    q = np.asarray(jax.random.normal(ks[0], (B, H, D)))
    kc = jax.random.normal(ks[1], (B, Hkv, T, D))
    vc = jax.random.normal(ks[2], (B, Hkv, T, D))
    if not int8:
        return {"q": q, "kc": np.asarray(kc), "vc": np.asarray(vc)}
    k8, k_s = jgen._quantize_kv(kc)
    v8, v_s = jgen._quantize_kv(vc)
    return {"q": q, "kc": np.asarray(k8), "vc": np.asarray(v8),
            "ks": np.asarray(k_s), "vs": np.asarray(v_s)}


# (mesh, B, H, Hkv, T, positions, window, int8): the JAX tests' cases on
# four ranks — sp alone, or dp x sp where the batch splits.
DECODE_CASES = {
    "window_none": ({"dp": 2, "sp": 2}, 2, 4, 2, 128, [90, 127], None, 0),
    "window48": ({"dp": 2, "sp": 2}, 2, 4, 2, 128, [90, 127], 48, 0),
    "int8_cache": ({"sp": 4}, 2, 4, 2, 128, [70, 127], None, 1),
    "partial_final_block": ({"sp": 4}, 1, 2, 1, 384, [380], None, 0),
    "partial_final_block_window": ({"sp": 4}, 1, 2, 1, 384, [380], 100, 0),
    "window_past_shard_300": ({"sp": 4}, 1, 2, 1, 384, [300], 100, 0),
    "window_past_shard_291": ({"sp": 4}, 1, 2, 1, 384, [291], 100, 0),
    "window_past_shard_355": ({"sp": 4}, 1, 2, 1, 384, [355], 100, 0),
    "empty_shards": ({"sp": 4}, 1, 2, 1, 384, [40], None, 1),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_flash_decode_on_mesh_matches_jax(cluster, case):
    sizes, B, H, Hkv, T, pos, window, int8 = DECODE_CASES[case]
    D = 16
    x = _decode_inputs(B, H, Hkv, T, D, seed=len(case), int8=bool(int8))
    x["pos"] = np.asarray(pos, np.int32)
    push(cluster, "dec", x)
    cell(cluster, f"""
m = make_mesh({sizes!r})
dp = "dp" if "dp" in m.shape else None
cs = P(dp, None, "sp", None)
d = {{k: torch.as_tensor(v) for k, v in dec.items()}}
loc = apply_shardings(d, m, {{"q": P(dp), "kc": cs, "vc": cs, "pos": P(dp),
                              **({{"ks": cs, "vs": cs}} if "ks" in d else {{}})}})
o = _flash_decode_on_mesh(loc["q"], loc["kc"], loc["vc"], loc["pos"], m,
                          {1 / np.sqrt(D)}, {window!r}, loc.get("ks"),
                          loc.get("vs"))""")
    got = pull(cluster, "o")
    jm = jmesh.make_mesh(sizes, devices=DEVS)
    args = [jnp.asarray(x[k]) for k in ("q", "kc", "vc", "pos")]
    scales = [jnp.asarray(x[k]) for k in ("ks", "vs")] if int8 else []
    want = np.asarray(jax.jit(lambda: jgen._flash_decode_on_mesh(
        *args, jm, 1 / np.sqrt(D), window, *scales))())
    ref = np.asarray(jdecode(*args, window=window,
                             **dict(zip(("k_s", "v_s"), scales))))
    np.testing.assert_allclose(want, ref, atol=1e-5, rtol=1e-5)
    for r in range(WORLD):
        block = local_block(want, jm, r, ("dp" if "dp" in sizes else None,))
        assert np.isfinite(got[r]).all()
        assert rel_l2(got[r], block) <= 1e-5, (case, r)


# ----------------------------------------------------------------------
# forward_with_cache on each mesh

FWD_MESHES = [{"dp": 2, "sp": 2}, {"tp": 2, "sp": 2}, {"dp": 2, "tp": 2}]


def _jax_fwd_sequence(jparams, jcfg, jm, steps, quantized=False):
    cache = jgen.init_kv_cache(jcfg, 2, 16, mesh=jm, quantized=quantized)
    outs = []
    for toks, start in steps:
        lg, cache = jgen.forward_with_cache(jparams, jnp.asarray(toks),
                                            cache, start, jcfg, mesh=jm)
        outs.append(np.asarray(lg))
    return outs


FWD_CELL = """
m = make_mesh({sizes!r})
rows = (lambda t: shard_batch(t, m)) if "dp" in m.shape else (lambda t: t)
cache = init_kv_cache(cfg, 2, 16, mesh=m, quantized={quantized},
                      device="cpu")
ps = {tree_expr}
lg = []
for toks, start in steps:
    start = rows(torch.as_tensor(start)) if np.ndim(start) else int(start)
    out, cache = forward_with_cache(ps, rows(torch.as_tensor(toks)), cache,
                                    start, cfg, mesh=m)
    lg.append(out)
"""


def _fwd_steps():
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 512, (2, 6))
    return [(prompt, 0), (rng.integers(0, 512, (2, 1)), np.array([6, 4])),
            (rng.integers(0, 512, (2, 3)), np.array([7, 5]))]


def _check_fwd(cluster, jm, want):
    got = pull(cluster, "lg")
    for r in range(WORLD):
        for i, w in enumerate(want):
            block = local_block(w, jm, r, ("dp" if "dp" in jm.shape
                                           else None,))
            assert rel_l2(got[r][i], block) <= 1e-5, (r, i)


@pytest.mark.parametrize("sizes", FWD_MESHES, ids=str)
def test_forward_with_cache_logits_match_jax(cluster, dense, sizes):
    """A prefill (B=2, S=6), a decode step at per-row positions [6, 4]
    and a verify of S=3 at [7, 5] (per-row writes that cross the sp
    slices): every step's logits."""
    jcfg, tree = dense
    steps = _fwd_steps()
    push(cluster, "steps", [list(s) for s in steps])
    tp = "tp" in sizes
    cell(cluster, FWD_CELL.format(
        sizes=sizes, quantized=False,
        tree_expr="apply_shardings(full, m, param_shardings(cfg))" if tp
        else "full"))
    jm = jmesh.make_mesh(sizes, devices=DEVS)
    jparams = jax.tree.map(jnp.asarray, tree)
    if tp:
        jparams = jput(jparams, jm, jtf.param_shardings(jcfg))
    _check_fwd(cluster, jm, _jax_fwd_sequence(jparams, jcfg, jm, steps))


@pytest.mark.parametrize("kind", ["int8", "int4", "int8_kv"])
def test_quantized_tp_trees_match_jax(cluster, dense, kind):
    """``test_quant.py:123,246`` and ``test_generate.py:303``: an int8 or
    int4 tree split by ``quantized_shardings(4)`` (int4 scales re-cut on
    the row split), and an int8 cache, on dp x tp."""
    jcfg, tree = dense
    sizes = {"dp": 2, "tp": 2}
    steps = _fwd_steps()
    push(cluster, "steps", [list(s) for s in steps])
    q = {"int8": ("quantize_params", "quantized_shardings"),
         "int4": ("quantize_params4", "quantized_shardings4"),
         "int8_kv": (None, None)}[kind]
    expr = ("apply_shardings(full, m, param_shardings(cfg))" if q[0] is None
            else f"apply_shardings({q[0]}(full), m, "
                 f"{q[1]}(param_shardings(cfg)))")
    cell(cluster, FWD_CELL.format(sizes=sizes, quantized=kind == "int8_kv",
                                  tree_expr=expr))
    jm = jmesh.make_mesh(sizes, devices=DEVS)
    jparams = jax.tree.map(jnp.asarray, tree)
    rules = jtf.param_shardings(jcfg)
    if q[0] is not None:
        jparams = getattr(jquant, q[0])(jparams)
        rules = getattr(jquant, q[1])(rules)
    jparams = jput(jparams, jm, rules)
    _check_fwd(cluster, jm, _jax_fwd_sequence(
        jparams, jcfg, jm, steps, quantized=kind == "int8_kv"))


def test_replicated_tree_on_tp_matches_sharded(cluster, dense):
    """A whole tree on a tp mesh: each rank cuts its shard per layer from
    the leaves' shapes, as GSPMD reads the layout from the arrays; the
    logits equal the split tree's."""
    steps = _fwd_steps()
    push(cluster, "steps", [list(s) for s in steps])
    cell(cluster, FWD_CELL.format(sizes={"tp": 2, "sp": 2}, quantized=False,
                                  tree_expr="full"))
    whole = pull(cluster, "lg")
    cell(cluster, FWD_CELL.format(
        sizes={"tp": 2, "sp": 2}, quantized=False,
        tree_expr="apply_shardings(full, m, param_shardings(cfg))"))
    split = pull(cluster, "lg")
    for r in range(WORLD):
        for a, b in zip(whole[r], split[r]):
            assert rel_l2(a, b) <= 1e-6


def jax_replicated_decode(jp, prompt, jcfg, n, jm, cache_rules):
    """Greedy decoding by the JAX package's ``forward_with_cache`` on
    ``jm`` with the cache placed by ``cache_rules``: where an axis holds
    a dimension whole, GSPMD computes it by the replicated einsum
    (``_can_flash_decode_on_mesh`` false)."""
    B, S0 = prompt.shape
    cache = jgen.init_kv_cache(jcfg, B, S0 + n, mesh=jm, rules=cache_rules)
    logits, cache = jgen.forward_with_cache(jp, prompt, cache, 0, jcfg,
                                            last_only=True, mesh=jm)
    toks = [jnp.argmax(logits[:, -1], -1)]
    for i in range(n - 1):
        logits, cache = jgen.forward_with_cache(
            jp, toks[-1][:, None], cache, S0 + i, jcfg, mesh=jm)
        toks.append(jnp.argmax(logits[:, -1], -1))
    return np.concatenate([np.asarray(prompt), np.stack(
        [np.asarray(t) for t in toks], 1)], 1).tolist()


def test_indivisible_decode_axis_raises(cluster, dense):
    """The call that raised before ROADMAP C2 was repaired: ``generate``
    with ``tiny_config``'s 2 KV heads on ``{"tp": 4}``.  Where tp does
    not divide the heads, each rank now gathers q, k and v over tp,
    attends every head against a cache holding them all, and keeps its
    columns of the output for ``wo``'s row split: the tokens of the JAX
    package's replicated einsum on the same mesh (its cache's heads held
    whole; JAX's own ``generate`` cannot place a tp-split cache there),
    which are its unsharded ``generate``'s."""
    jcfg, tree = dense
    prompt = np.random.default_rng(4).integers(0, 512, (2, 3))
    out = cell(cluster, f"""
m = make_mesh({{"tp": 4}})
generate(apply_shardings(full, m, param_shardings(cfg)),
         torch.tensor({prompt.tolist()}), cfg, 6, mesh=m).tolist()""")
    jm = jmesh.make_mesh({"tp": 4}, devices=DEVS)
    params = jax.tree.map(jnp.asarray, tree)
    want = jax_replicated_decode(
        jput(params, jm, jtf.param_shardings(jcfg)), jnp.asarray(prompt),
        jcfg, 6, jm, jgen.kv_cache_shardings(dp_axis=None, tp_axis=None))
    assert want == np.asarray(jgen.generate(params, jnp.asarray(prompt),
                                            jcfg, 6)).tolist()
    assert all(ast.literal_eval(o) == want for o in out.values())


# ----------------------------------------------------------------------
# the expert layer over ep

D_E, F_E = 16, 32


def _moe_case(T, E=4, seed=3):
    p = np_tree(jexp.init_moe_params(jax.random.PRNGKey(seed), D_E, F_E, E,
                                     dtype=jnp.float32))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 1),
                                     (T, D_E)))
    return p, x


def _run_moe(cluster, sizes, p, x, mask=None, quant=False, **kw):
    push(cluster, "moe_in", {"p": p, "x": x, **({"mask": mask}
                                               if mask is not None else {})})
    cell(cluster, f"""
m = make_mesh({sizes!r})
rules = expert.moe_param_shardings()
tp_ = {{k: torch.as_tensor(v) for k, v in moe_in["p"].items()}}
if {quant}:
    for n in ("w_gate", "w_up", "w_down"):
        tp_[n] = quantize_weight(tp_[n])
        rules[n] = {{"q8": rules[n], "s": P(*rules[n][:-2], None,
                                             rules[n][-1])}}
ploc = apply_shardings(tp_, m, rules)
xs = torch.as_tensor(moe_in["x"])
ms = torch.as_tensor(moe_in["mask"]) if "mask" in moe_in else None
if "dp" in m.shape:
    xs = shard_batch(xs, m)
    ms = shard_batch(ms, m) if ms is not None else None
y, aux = expert.moe_ffn(xs, ploc, mesh=m, token_mask=ms, **{kw!r})""")
    return pull(cluster, "y"), pull(cluster, "aux")


def _jax_moe(sizes, p, x, mask=None, quant=False, **kw):
    jm = jmesh.make_mesh(sizes, devices=DEVS)
    jp = jax.tree.map(jnp.asarray, p)
    rules = jexp.moe_param_shardings()
    if quant:
        for n in ("w_gate", "w_up", "w_down"):
            jp[n] = jquant.quantize_weight(jp[n])
            rules[n] = jquant._q_spec(rules[n])
    jp = jput(jp, jm, rules)
    y, aux = jax.jit(lambda p_, x_: jexp.moe_ffn(
        x_, p_, mesh=jm, token_mask=None if mask is None
        else jnp.asarray(mask), **kw))(jp, jnp.asarray(x))
    return jm, np.asarray(y), float(aux)


def _check_moe(got, got_aux, jm, want, want_aux):
    for r in range(WORLD):
        block = local_block(want, jm, r, ("dp" if "dp" in jm.shape
                                          else None,))
        np.testing.assert_allclose(got[r], block, atol=1e-5,
                                   rtol=1e-5)
        assert float(got_aux[r]) == pytest.approx(want_aux, rel=1e-5)


@pytest.mark.parametrize("sizes", [{"dp": 2, "ep": 2}, {"ep": 4}], ids=str)
@pytest.mark.parametrize("mode", ["dense", "sparse", "dropless"])
def test_moe_ffn_on_ep_mesh_matches_jax(cluster, sizes, mode):
    """``test_expert.py:170,253,468``: each dispatch mode on an ep mesh
    (tokens split over dp where the mesh has it), at capacity factor 4."""
    p, x = _moe_case(32)
    kw = dict(capacity_factor=4.0, dispatch_mode=mode)
    got, aux = _run_moe(cluster, sizes, p, x, **kw)
    _check_moe(got, aux, *_jax_moe(sizes, p, x, **kw))


@pytest.mark.parametrize("capacity", [8, 2 * 96])
def test_dropless_ep_shard_overflow_drops_only_the_tail(cluster, capacity):
    """``test_expert.py:498``: a tight pooled shard capacity drops the
    sorted tail of each shard's segment, exactly as JAX drops it; an
    ample one drops nothing."""
    p, x = _moe_case(96)
    kw = dict(capacity=capacity, dispatch_mode="dropless")
    got, aux = _run_moe(cluster, {"ep": 4}, p, x, **kw)
    jm, want, want_aux = _jax_moe({"ep": 4}, p, x, **kw)
    _check_moe(got, aux, jm, want, want_aux)
    lossless = np.asarray(jexp.moe_ffn(jnp.asarray(x), jax.tree.map(
        jnp.asarray, p), dispatch_mode="dropless")[0])
    assert (np.abs(want - lossless).max() > 1e-4) == (capacity == 8)


@pytest.mark.parametrize("mode", ["dense", "dropless"])
def test_moe_ffn_ep_token_mask_and_int8(cluster, mode):
    """``test_expert.py:528``: a token mask and int8 experts on dp x ep;
    masked rows give exactly 0."""
    p, x = _moe_case(24)
    mask = np.arange(24) % 3 != 0
    kw = dict(capacity_factor=8.0, dispatch_mode=mode)
    got, aux = _run_moe(cluster, {"dp": 2, "ep": 2}, p, x, mask=mask,
                        quant=True, **kw)
    jm, want, want_aux = _jax_moe({"dp": 2, "ep": 2}, p, x, mask=mask,
                                  quant=True, **kw)
    _check_moe(got, aux, jm, want, want_aux)
    assert np.abs(want[~mask]).max() == 0


def test_ep_mesh_rejects_indivisible_experts(cluster):
    """``test_expert.py:610``: six experts on four ep ranks, JAX's error."""
    p, x = _moe_case(8, E=6)
    push(cluster, "moe_in", {"p": p, "x": x})
    out = cell(cluster, """
m = make_mesh({"ep": 4})
msg = ""
try:
    expert.moe_ffn(torch.as_tensor(moe_in["x"]),
                   {k: torch.as_tensor(v) for k, v in moe_in["p"].items()},
                   mesh=m, dispatch_mode="dropless")
except ValueError as e:
    msg = str(e)
msg""")
    jm = jmesh.make_mesh({"ep": 4}, devices=DEVS)
    with pytest.raises(ValueError) as want:
        jexp.moe_ffn(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                     dispatch_mode="dropless", mesh=jm)
    assert all(ast.literal_eval(o) == str(want.value) for o in out.values())


def test_quantized_moe_forward_on_ep_mesh(cluster):
    """``test_quant.py:246``: an int8 MoE tree split by
    ``quantized_moe_shardings(moe_model_shardings(tp_axis=None))``
    through ``moe_forward`` on dp x ep: JAX's logits and aux."""
    jcfg = jmoe.tiny_moe_config(dtype=jnp.float32)
    tree = np_tree(jmoe.init_moe_model(jax.random.PRNGKey(0), jcfg))
    tokens = np.random.default_rng(1).integers(0, 512, (2, 16))
    push(cluster, "mtree", tree)
    push(cluster, "mtok", tokens)
    cell(cluster, """
mcfg = tiny_moe_config(dtype=torch.float32)
m = make_mesh({"dp": 2, "ep": 2})
qp = apply_shardings(quantize_moe_params(params_from_jax(mtree, mcfg,
                                                         device="cpu")),
                     m, quantized_moe_shardings(moe_model_shardings(
                         mcfg, tp_axis=None)))
lg, aux = moe_forward(qp, shard_batch(torch.as_tensor(mtok), m), mcfg,
                      mesh=m)""")
    got, aux = pull(cluster, "lg"), pull(cluster, "aux")
    jm = jmesh.make_mesh({"dp": 2, "ep": 2}, devices=DEVS)
    jq = jput(jquant.quantize_moe_params(jax.tree.map(jnp.asarray, tree)),
              jm, jquant.quantized_moe_shardings(
                  jmoe.moe_model_shardings(jcfg, tp_axis=None)))
    want, want_aux = jax.jit(lambda p, t: jmoe.moe_forward(
        p, t, jcfg, mesh=jm))(jq, jnp.asarray(tokens))
    for r in range(WORLD):
        block = local_block(np.asarray(want), jm, r, ("dp",))
        assert rel_l2(got[r], block) <= 1e-5
        assert float(aux[r]) == pytest.approx(float(want_aux), rel=1e-5)
