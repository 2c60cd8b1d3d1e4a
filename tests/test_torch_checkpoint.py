"""The port's per-rank checkpoints against the JAX package's, on the CPU
(``nbdistributed_tpu_torch/runtime/checkpoint.py`` against
``nbdistributed_tpu/runtime/checkpoint.py``).

Parity, exact: for the same numpy-derived tree both packages' manifests
give every leaf the same kind of entry, dtype, shape and crc32, and each
package's ``info(verify=True)`` reads the other's directory.  Then
``tests/unit/test_checkpoint.py``'s cases on the port (bf16, numpy
against tensors, the optimizer's state, object and structured dtypes, a
non-contiguous array, subsets, missing names and ranks, independent
rank dirs, a resave, a failed save keeping the old checkpoint, staging
dirs, the async cases) and the port's own: restore into live params in
place with the optimizer still stepping them, the optimizer's
``state_dict`` round trip, ``save_async`` followed by an in-place step
restoring the values from before it, and the ``device=`` refusal.
"""

import json
import os
import shutil
import zipfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from nbdistributed_tpu.runtime import checkpoint as jck
from nbdistributed_tpu_torch.models import (AdamW, loss_fn, make_train_step,
                                            param_leaves, params_from_jax,
                                            tiny_config)
from nbdistributed_tpu_torch.models import transformer as ttf
from nbdistributed_tpu_torch.runtime import checkpoint


def roundtrip(tmp_path, ns, names, restore_names=None):
    checkpoint.save(str(tmp_path / "ck"), ns, names, rank=0, world_size=1)
    out: dict = {}
    checkpoint.restore(str(tmp_path / "ck"), out, restore_names, rank=0)
    return out


def _manifest(path, rank=0):
    with open(os.path.join(path, f"rank_{rank}", "manifest.json")) as f:
        return json.load(f)


# ----------------------------------------------------------------------
# parity with the JAX package

def _trees():
    """One set of numpy values as a JAX tree and as the port's."""
    from nbdistributed_tpu.models import transformer as jtf

    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 5)).astype(np.float32)
    jp = jtf.init_params(jax.random.PRNGKey(0),
                         jtf.tiny_config(dtype=jnp.bfloat16))
    np_params = jax.tree.map(np.asarray, jp)
    jtree = {"params": jp, "w": jnp.asarray(w), "h": jnp.asarray(w[0],
                                                                 jnp.float16),
             "bf": jnp.asarray(w, jnp.bfloat16), "i8": jnp.arange(
                 -4, 4, dtype=jnp.int8), "flag": jnp.asarray([True, False]),
             "n": np.arange(6, dtype=np.int64), "lst": [jnp.ones(2), None,
                                                        (3, "x")]}
    ttree = {"params": params_from_jax(np_params, tiny_config(
                 dtype=torch.bfloat16), device="cpu"),
             "w": torch.from_numpy(w.copy()),
             "h": torch.from_numpy(w[0].astype(np.float16)),
             "bf": torch.from_numpy(np.asarray(jtree["bf"]).view(
                 np.int16).copy()).view(torch.bfloat16),
             "i8": torch.arange(-4, 4, dtype=torch.int8),
             "flag": torch.tensor([True, False]),
             "n": np.arange(6, dtype=np.int64),
             "lst": [torch.ones(2), None, (3, "x")]}
    return jtree, ttree


def test_manifests_match_the_jax_package(tmp_path):
    """Leaf for leaf: the same order, dtype, shape and crc32 (a tensor
    records its device where a JAX array records its sharding), and the
    same array bytes in ``arrays.npz``."""
    jtree, ttree = _trees()
    jck.save(str(tmp_path / "j"), {"t": jtree}, ["t"], rank=1, world_size=2)
    checkpoint.save(str(tmp_path / "p"), {"t": ttree}, ["t"], rank=1,
                    world_size=2)
    jm, tm = _manifest(tmp_path / "j", 1), _manifest(tmp_path / "p", 1)
    assert tm["version"] == jm["version"] == checkpoint.FORMAT_VERSION
    assert (tm["rank"], tm["world_size"]) == (jm["rank"], jm["world_size"])
    jl, tl = jm["entries"]["t"]["leaves"], tm["entries"]["t"]["leaves"]
    assert len(jl) == len(tl) > 12
    for a, b in zip(jl, tl):
        kind = {"jax": "torch"}.get(a["kind"], a["kind"])
        assert b["kind"] == kind
        for k in ("dtype", "shape", "crc32"):
            assert b.get(k) == a.get(k), (a, b)
        if kind == "torch":
            assert b["device"] == "cpu" and "sharding" in a
    with np.load(tmp_path / "j" / "rank_1" / "arrays.npz") as jz, \
            np.load(tmp_path / "p" / "rank_1" / "arrays.npz") as tz:
        assert sorted(jz.files) == sorted(tz.files)
        for k in jz.files:
            np.testing.assert_array_equal(jz[k], tz[k])


def test_each_package_verifies_the_others_directory(tmp_path):
    jtree, ttree = _trees()
    for r in range(2):
        jck.save(str(tmp_path / "j"), {"t": jtree, "s": 3}, ["t", "s"],
                 rank=r, world_size=2)
        checkpoint.save(str(tmp_path / "p"), {"t": ttree, "s": 3},
                        ["t", "s"], rank=r, world_size=2)
    want = {"world_size": 2, "names": ["s", "t"], "integrity": "ok"}
    for info in (jck.info(str(tmp_path / "p"), verify=True),
                 checkpoint.info(str(tmp_path / "j"), verify=True),
                 checkpoint.info(str(tmp_path / "p"), verify=True)):
        assert info["ranks"] == {0: want, 1: want}
    # A flipped byte is named by both.
    _flip_npz_byte(tmp_path / "p" / "rank_1", "t.")
    for info in (jck.info(str(tmp_path / "p"), verify=True),
                 checkpoint.info(str(tmp_path / "p"), verify=True)):
        assert info["ranks"][0]["integrity"] == "ok"
        assert any("crc32" in p for p in info["ranks"][1]["integrity"])


def test_restore_refuses_a_jax_directory(tmp_path):
    jck.save(str(tmp_path / "j"), {"x": jnp.ones(2)}, ["x"])
    with pytest.raises(ValueError, match="written by the JAX package"):
        checkpoint.restore(str(tmp_path / "j"), {})


# ----------------------------------------------------------------------
# tests/unit/test_checkpoint.py on the port

def test_tensor_roundtrip_exact(tmp_path):
    ns = {"x": torch.arange(12.0).reshape(3, 4)}
    out = roundtrip(tmp_path, ns, ["x"])
    assert isinstance(out["x"], torch.Tensor)
    assert torch.equal(out["x"], ns["x"])


def test_bfloat16_dtype_survives(tmp_path):
    ns = {"w": torch.tensor([1.5, -2.0, 3.25], dtype=torch.bfloat16)}
    out = roundtrip(tmp_path, ns, ["w"])
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"], ns["w"])


def test_numpy_stays_numpy_torch_stays_torch(tmp_path):
    ns = {"a": np.arange(3, dtype=np.int64), "b": torch.ones(2)}
    out = roundtrip(tmp_path, ns, ["a", "b"])
    assert type(out["a"]) is np.ndarray and out["a"].dtype == np.int64
    assert isinstance(out["b"], torch.Tensor)


def test_tree_with_optimizer_state(tmp_path):
    """The counterpart of ``test_pytree_with_optax_state``: an AdamW
    saves as its state dict, restores as one where no optimizer lives."""
    params = {"dense": {"w": torch.ones(4, 4), "b": torch.zeros(4)}}
    opt = AdamW(param_leaves(params), lr=1e-3)
    for p in param_leaves(params):
        p.grad = torch.full_like(p, 0.5)
    opt.step()
    ns = {"params": params, "opt_state": opt, "step": 17, "note": "hello"}
    out = roundtrip(tmp_path, ns, ["params", "opt_state", "step", "note"])
    assert out["step"] == 17 and out["note"] == "hello"
    sd = opt.state_dict()
    got = out["opt_state"]
    assert got["param_groups"] == sd["param_groups"]
    for k, st in sd["state"].items():
        assert got["state"][k]["step"] == st["step"] == 1
        assert torch.equal(got["state"][k]["mu"], st["mu"])
        assert torch.equal(got["state"][k]["nu"], st["nu"])


def test_object_dtype_ndarray_roundtrips_via_pickle_path(tmp_path):
    ns = {"o": np.array([{"a": 1}, None, "s"], dtype=object)}
    out = roundtrip(tmp_path, ns, ["o"])
    assert out["o"].dtype == object
    assert list(out["o"]) == [{"a": 1}, None, "s"]


def test_restored_numpy_array_is_writable(tmp_path):
    out = roundtrip(tmp_path, {"a": np.arange(4.0)}, ["a"])
    out["a"][0] = 99.0
    assert out["a"][0] == 99.0


def test_non_contiguous_arrays_save_correctly(tmp_path):
    base = np.arange(12.0).reshape(3, 4)
    ns = {"t": base.T, "tt": torch.from_numpy(base).T}
    out = roundtrip(tmp_path, ns, ["t", "tt"])
    np.testing.assert_array_equal(out["t"], base.T)
    assert torch.equal(out["tt"], torch.from_numpy(base).T)


def test_restore_subset_of_names(tmp_path):
    ns = {"x": torch.ones(2), "y": torch.zeros(2)}
    out = roundtrip(tmp_path, ns, ["x", "y"], restore_names=["y"])
    assert set(out) == {"y"}


def test_missing_name_on_save_raises(tmp_path):
    with pytest.raises(KeyError, match="nope"):
        checkpoint.save(str(tmp_path / "ck"), {"x": 1}, ["nope"], rank=0)


def test_missing_name_on_restore_raises(tmp_path):
    checkpoint.save(str(tmp_path / "ck"), {"x": 1}, ["x"], rank=0)
    with pytest.raises(KeyError, match="ghost"):
        checkpoint.restore(str(tmp_path / "ck"), {}, ["ghost"], rank=0)


def test_missing_rank_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "ck"), {}, rank=3)


def test_unknown_version_raises(tmp_path):
    checkpoint.save(str(tmp_path / "ck"), {"x": 1}, ["x"])
    mpath = tmp_path / "ck" / "rank_0" / "manifest.json"
    m = json.loads(mpath.read_text())
    m["version"] = 99
    mpath.write_text(json.dumps(m))
    with pytest.raises(ValueError, match="unsupported checkpoint version"):
        checkpoint.restore(str(tmp_path / "ck"), {})


def test_torn_aux_and_missing_entry_are_refused(tmp_path):
    checkpoint.save(str(tmp_path / "ck"), {"x": torch.ones(3)}, ["x"])
    d = tmp_path / "ck" / "rank_0"
    shutil.copy(d / "arrays.npz", tmp_path / "arrays.npz")
    (d / "aux.pkl").write_bytes(b"torn")
    with pytest.raises(ValueError, match="torn checkpoint: .*aux.pkl"):
        checkpoint.restore(str(tmp_path / "ck"), {})
    checkpoint.save(str(tmp_path / "ck"), {"x": torch.ones(3)}, ["x"])
    np.savez(d / "arrays.npz", other=np.zeros(1, np.uint8))
    with pytest.raises(ValueError, match="has no entry 'x.0'"):
        checkpoint.restore(str(tmp_path / "ck"), {})
    assert any("absent" in p for p in checkpoint.verify_rank(
        str(tmp_path / "ck"), 0))


def test_per_rank_dirs_are_independent(tmp_path):
    for r in range(2):
        checkpoint.save(str(tmp_path / "ck"), {"v": torch.full((2,), r)},
                        ["v"], rank=r, world_size=2)
    out0, out1 = {}, {}
    checkpoint.restore(str(tmp_path / "ck"), out0, rank=0)
    checkpoint.restore(str(tmp_path / "ck"), out1, rank=1)
    assert float(out0["v"][0]) == 0.0 and float(out1["v"][0]) == 1.0


def test_resave_overwrites_cleanly(tmp_path):
    ns1 = {"x": torch.ones(2), "extra": torch.zeros(3)}
    checkpoint.save(str(tmp_path / "ck"), ns1, ["x", "extra"], rank=0)
    checkpoint.save(str(tmp_path / "ck"), {"x": torch.full((2,), 7.0)},
                    ["x"], rank=0)
    out: dict = {}
    checkpoint.restore(str(tmp_path / "ck"), out, rank=0)
    assert set(out) == {"x"} and float(out["x"][0]) == 7.0


def test_failed_save_preserves_previous_checkpoint(tmp_path):
    checkpoint.save(str(tmp_path / "ck"), {"x": torch.ones(2)}, ["x"],
                    rank=0)
    with pytest.raises(Exception):
        # A lambda does not pickle: the staged tmp dir fails mid-write.
        checkpoint.save(str(tmp_path / "ck"), {"x": lambda: None},
                        ["x"], rank=0)
    out: dict = {}
    checkpoint.restore(str(tmp_path / "ck"), out, rank=0)
    assert float(out["x"][0]) == 1.0


def test_tensor_leaf_manifest_records_device(tmp_path):
    checkpoint.save(str(tmp_path / "ck"), {"x": torch.ones(2)}, ["x"])
    leaf = _manifest(tmp_path / "ck")["entries"]["x"]["leaves"][0]
    assert leaf["kind"] == "torch" and leaf["device"] == "cpu"


def test_structured_dtype_roundtrips_via_pickle_path(tmp_path):
    rec = np.zeros(3, dtype=[("a", "<i4"), ("b", "<f8")])
    rec["a"] = [1, 2, 3]
    out = roundtrip(tmp_path, {"rec": rec}, ["rec"])
    assert out["rec"].dtype == rec.dtype
    np.testing.assert_array_equal(out["rec"]["a"], rec["a"])


def test_info_skips_staging_dirs(tmp_path):
    checkpoint.save(str(tmp_path / "ck"), {"x": torch.ones(1)}, ["x"])
    shutil.copytree(tmp_path / "ck" / "rank_0", tmp_path / "ck" / "rank_0.tmp")
    shutil.copytree(tmp_path / "ck" / "rank_0", tmp_path / "ck" / "rank_1.old")
    assert sorted(checkpoint.info(str(tmp_path / "ck"))["ranks"]) == [0]


def test_info_lists_ranks_and_names(tmp_path):
    for r in range(2):
        checkpoint.save(str(tmp_path / "ck"), {"p": torch.ones(1), "s": 2},
                        ["p", "s"], rank=r, world_size=2)
    meta = checkpoint.info(str(tmp_path / "ck"))
    assert sorted(meta["ranks"]) == [0, 1]
    assert meta["ranks"][0]["names"] == ["p", "s"]
    assert meta["ranks"][0]["world_size"] == 2
    assert checkpoint.info(str(tmp_path / "none")) == {
        "path": str(tmp_path / "none"), "ranks": {}}


def _flip_npz_byte(rank_dir, prefix):
    zpath = os.path.join(rank_dir, "arrays.npz")
    with zipfile.ZipFile(zpath) as z:
        names = z.namelist()
        blobs = {n: bytearray(z.read(n)) for n in names}
    victim = sorted(n for n in names if n.startswith(prefix))[0]
    blobs[victim][-1] ^= 0xFF
    with zipfile.ZipFile(zpath, "w") as z:
        for n in names:
            z.writestr(n, bytes(blobs[n]))
    return victim.removesuffix(".npy")


def test_manifest_verifies_and_refuses(tmp_path):
    """``test_trainguard.py:396``: a flipped payload byte is named by
    ``verify_rank`` and refused by ``restore``; a manifest without crc32
    reads as unverifiable."""
    path = str(tmp_path / "ck")
    checkpoint.save(path, {"params": {"w": torch.arange(16.0).reshape(4, 4)}},
                    ["params"])
    assert checkpoint.verify_rank(path, 0) == []
    key = _flip_npz_byte(os.path.join(path, "rank_0"), "params")
    problems = checkpoint.verify_rank(path, 0)
    assert problems and any("crc32" in p and key in p for p in problems)
    with pytest.raises(ValueError, match=f"integrity.*{key}"):
        checkpoint.restore(path, {}, ["params"])
    mpath = os.path.join(path, "rank_0", "manifest.json")
    manifest = json.load(open(mpath))
    for entry in manifest["entries"].values():
        for meta in entry["leaves"]:
            meta.pop("crc32", None)
    json.dump(manifest, open(mpath, "w"))
    assert any("no crc32" in p for p in checkpoint.verify_rank(path, 0))


def test_save_async_roundtrip_and_done(tmp_path):
    ns = {"w": torch.arange(12, dtype=torch.bfloat16).reshape(3, 4),
          "step": 7}
    h = checkpoint.save_async(str(tmp_path / "ck"), ns, ["w", "step"])
    summary = h.wait(30)
    assert h.done() and summary["w"]["bytes"] == 24
    out: dict = {}
    checkpoint.restore(str(tmp_path / "ck"), out)
    assert torch.equal(out["w"], ns["w"]) and out["step"] == 7


def test_save_async_snapshots_mutable_leaves(tmp_path):
    cfg = {"lr": [1, 2, 3]}
    h = checkpoint.save_async(str(tmp_path / "ck"), {"cfg": cfg}, ["cfg"])
    cfg["lr"].append(999)
    h.wait(30)
    out: dict = {}
    checkpoint.restore(str(tmp_path / "ck"), out)
    assert out["cfg"] == {"lr": [1, 2, 3]}


def test_save_async_missing_name_raises_synchronously(tmp_path):
    with pytest.raises(KeyError, match="nope"):
        checkpoint.save_async(str(tmp_path / "ck"), {"a": 1}, ["nope"])


def test_save_async_error_surfaces_at_wait(tmp_path):
    target = tmp_path / "blocked"
    target.write_text("a file where the checkpoint dir must go")
    h = checkpoint.save_async(str(target), {"x": torch.ones(3)}, ["x"])
    with pytest.raises(Exception):
        h.wait(30)


def test_save_async_freezes_numpy_and_tensor_leaves(tmp_path):
    """In-place writes after the call do not reach the checkpoint: the
    counterpart of ``test_save_async_survives_buffer_donation`` and
    ``test_save_async_freezes_numpy_leaves``."""
    buf = np.arange(6, dtype=np.int32)
    x = torch.arange(8.0)
    h = checkpoint.save_async(str(tmp_path / "ck"), {"buf": buf, "x": x},
                              ["buf", "x"])
    buf[:] = -1
    x.mul_(0)
    h.wait(30)
    out: dict = {}
    checkpoint.restore(str(tmp_path / "ck"), out)
    np.testing.assert_array_equal(out["buf"], np.arange(6, dtype=np.int32))
    assert torch.equal(out["x"], torch.arange(8.0))


# ----------------------------------------------------------------------
# the port's own: live state

def _train_setup(seed=0):
    from nbdistributed_tpu.models import transformer as jtf

    tree = jax.tree.map(np.asarray, jtf.init_params(
        jax.random.PRNGKey(seed), jtf.tiny_config(dtype=jnp.float32)))
    cfg = tiny_config(dtype=torch.float32)
    params = params_from_jax(tree, cfg, device="cpu")
    opt = AdamW(param_leaves(params), lr=1e-3)
    return cfg, params, opt, make_train_step(cfg, opt)


def _batch(i):
    rng = np.random.default_rng(100 + i)
    return {"tokens": torch.from_numpy(
        rng.integers(0, 512, (2, 24)).astype(np.int64))}


def _bytes_of(params, opt):
    return ([p.detach().numpy().tobytes() for p in param_leaves(params)],
            [(opt.state[p]["step"], opt.state[p]["mu"].numpy().tobytes(),
              opt.state[p]["nu"].numpy().tobytes())
             for p in param_leaves(params)])


def test_restore_into_live_params_in_place(tmp_path):
    """Restoring the state after step 2 into a live tree and optimizer
    writes into their tensors (the optimizer still steps the same ones),
    and steps 3-4 then repeat the uninterrupted run's losses and bytes."""
    cfg, params, opt, step = _train_setup()
    for i in range(2):
        step(params, _batch(i))
    checkpoint.save(str(tmp_path / "ck"), {"params": params, "opt": opt},
                    ["params", "opt"])
    want = [float(step(params, _batch(i))) for i in (2, 3)]
    want_bytes = _bytes_of(params, opt)

    leaves = param_leaves(params)
    ns = {"params": params, "opt": opt}
    checkpoint.restore(str(tmp_path / "ck"), ns)
    assert ns["params"] is params and ns["opt"] is opt
    assert all(a is b for a, b in zip(param_leaves(params), leaves))
    assert all(opt.state[p]["step"] == 2 for p in leaves)
    got = [float(step(params, _batch(i))) for i in (2, 3)]
    assert got == want and _bytes_of(params, opt) == want_bytes


def test_optimizer_state_dict_roundtrip_into_a_fresh_tree(tmp_path):
    """A fresh tree and a fresh AdamW over it take the saved state: the
    tree by in-place copies, the optimizer by ``load_state_dict``."""
    cfg, params, opt, step = _train_setup()
    for i in range(2):
        step(params, _batch(i))
    checkpoint.save(str(tmp_path / "ck"), {"params": params, "opt": opt},
                    ["params", "opt"])
    before = _bytes_of(params, opt)
    _, fresh, fopt, fstep = _train_setup(seed=1)
    ns = {"params": fresh, "opt": fopt}
    checkpoint.restore(str(tmp_path / "ck"), ns)
    assert ns["opt"] is fopt and _bytes_of(fresh, fopt) == before
    assert float(fstep(fresh, _batch(2))) == float(step(params, _batch(2)))


def test_save_async_then_an_in_place_step_restores_the_state_before_it(
        tmp_path):
    """``save_async`` of the live state, then a step at once that
    overwrites every tensor in place: the checkpoint holds the values
    from before the step."""
    cfg, params, opt, step = _train_setup()
    step(params, _batch(0))
    before = _bytes_of(params, opt)
    h = checkpoint.save_async(str(tmp_path / "ck"),
                              {"params": params, "opt": opt},
                              ["params", "opt"])
    step(params, _batch(1))
    assert _bytes_of(params, opt) != before
    h.wait(60)
    ns = {"params": params, "opt": opt}
    checkpoint.restore(str(tmp_path / "ck"), ns)
    assert _bytes_of(params, opt) == before


def test_restore_makes_new_tensors_where_nothing_fits(tmp_path):
    ns = {"x": torch.ones(2, 3), "y": {"a": torch.zeros(2)}}
    checkpoint.save(str(tmp_path / "ck"), ns, ["x", "y"])
    live = {"x": torch.zeros(3, 2), "y": {"b": torch.zeros(2)}}
    old = live["x"]
    checkpoint.restore(str(tmp_path / "ck"), live)
    assert live["x"] is not old and live["x"].shape == (2, 3)
    assert set(live["y"]) == {"a"}


def test_cuda_leaves_need_device_without_cuda(tmp_path):
    """A leaf recorded on a CUDA device, restored where there is none,
    raises naming ``device=``; ``device="cpu"`` restores it."""
    checkpoint.save(str(tmp_path / "ck"), {"x": torch.arange(3.0)}, ["x"])
    mpath = tmp_path / "ck" / "rank_0" / "manifest.json"
    m = json.loads(mpath.read_text())
    m["entries"]["x"]["leaves"][0]["device"] = "cuda:0"
    mpath.write_text(json.dumps(m))
    if torch.cuda.is_available():
        pytest.skip("this check needs a process without CUDA")
    with pytest.raises(ValueError, match="device="):
        checkpoint.restore(str(tmp_path / "ck"), {})
    out: dict = {}
    checkpoint.restore(str(tmp_path / "ck"), out, device="cpu")
    assert torch.equal(out["x"], torch.arange(3.0))


def test_loss_fn_reads_restored_params(tmp_path):
    """A restored tree is a working parameter tree (the loss of the
    restored tree equals the saved tree's)."""
    cfg, params, _, _ = _train_setup()
    checkpoint.save(str(tmp_path / "ck"), {"p": params}, ["p"])
    out: dict = {}
    checkpoint.restore(str(tmp_path / "ck"), out)
    b = _batch(0)
    with torch.no_grad():
        assert float(loss_fn(out["p"], b, cfg)) == \
            float(loss_fn(params, b, cfg))
    assert ttf.named_param_leaves(out["p"])[0][0] == "embed"


def test_bf16_numpy_leaf_goes_through_the_pickle_path(tmp_path):
    """An ml_dtypes bfloat16 numpy leaf (void kind to numpy) is pickled
    whole, as the JAX package's byte path cannot name it without JAX."""
    a = np.asarray([1.5, 2.0], ml_dtypes.bfloat16)
    out = roundtrip(tmp_path, {"a": a}, ["a"])
    np.testing.assert_array_equal(out["a"].astype(np.float32),
                                  a.astype(np.float32))
