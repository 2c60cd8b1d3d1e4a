"""The port's training slice against the JAX package on the CPU: the
loss and its gradients, remat, the chunked-vocab loss, AdamW against
optax, the LoRA step (on a MoE config too), and the data utilities.

Both packages get the same parameters (JAX init, converted with
``params_from_jax`` / ``lora_from_jax``) and the same batches (numpy,
from a seed) at ``tiny_config`` in float32.  The JAX side runs its
Pallas flash kernels in interpret mode where ``use_flash`` is on.
Tolerances: losses to 1e-6 relative; gradients to 2e-5 absolute and
1e-4 relative — two layers of fp32 products and attention sums taken
in different orders by XLA and PyTorch; AdamW parameters after three
steps to 1e-6 against optax fed the same gradients, and losses to 1e-5
against the JAX train step run on its own gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nbdistributed_tpu.models import lora as jlora
from nbdistributed_tpu.models import moe as jmoe
from nbdistributed_tpu.models import transformer as jtf
from nbdistributed_tpu.ops import xent as jxent
from nbdistributed_tpu.utils import data as jdata
from nbdistributed_tpu_torch.models import (AdamW, apply_optimizer_updates,
                                            lora_from_jax, lora_init,
                                            lora_merge, lora_num_params,
                                            lora_to_numpy, loss_fn,
                                            make_layer_fn,
                                            make_lora_train_step,
                                            make_train_step, moe_loss_fn,
                                            named_param_leaves,
                                            num_tokens_per_step,
                                            packed_positions, param_leaves,
                                            params_from_jax,
                                            params_to_numpy, shifted_xent,
                                            tiny_config, tiny_moe_config)
from nbdistributed_tpu_torch.ops import attention as tattn
from nbdistributed_tpu_torch.ops import xent as txent
from nbdistributed_tpu_torch.utils import data as tdata


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast, and leaves the
    cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
B, S = 2, 32
# ``param_leaves`` walks any nested dict in sorted-key order, which is
# JAX's pytree order: it lines up the port's leaves with the JAX trees.


@pytest.fixture(scope="module")
def tree():
    cfg = jtf.tiny_config(dtype=jnp.float32)
    return jax.tree.map(np.asarray,
                        jtf.init_params(jax.random.PRNGKey(0), cfg))


def _batch(seed=1, segments=True):
    """Packed random documents: tokens and segment ids (B, S)."""
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, 512, int(rng.integers(5, 20)))
            for _ in range(12)]
    tokens, segs = jdata.pack_tokens(docs, S, eos_id=0,
                                     return_segments=True)
    batch = {"tokens": tokens[:B]}
    if segments:
        batch["segments"] = segs[:B]
    return batch


def _port(tree, cfg, requires_grad=True):
    params = params_from_jax(tree, cfg, device="cpu")
    for p in param_leaves(params):
        p.requires_grad_(requires_grad)
    return params


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def test_named_param_leaves_follow_the_jax_tree_paths(tree):
    params = _port(tree, tiny_config(dtype=torch.float32), False)
    named = named_param_leaves(params)
    want = ["/".join(k.key for k in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert [name for name, _ in named] == want
    assert all(a is b for (_, a), b in zip(named, param_leaves(params)))


# (name, config overrides, segments)
LOSS_CASES = [
    ("flash", {}, False),
    ("flash_segments", {}, True),
    ("remat", {"remat": True}, True),
    ("remat_attn_only", {"remat": True, "remat_policy": "attn_only"}, True),
    ("remat_mlp_only", {"remat": True, "remat_policy": "mlp_only"}, False),
    ("ce_chunk", {"ce_chunk": 100}, True),
    ("ce_chunk_remat", {"ce_chunk": 128, "remat": True}, False),
    ("window", {"sliding_window": 7}, True),
    ("plain_attention", {"use_flash": False}, True),
]


@pytest.mark.parametrize("case", LOSS_CASES, ids=[c[0] for c in LOSS_CASES])
def test_loss_and_grads_match_jax(tree, case):
    """``loss_fn`` value and every gradient leaf against
    ``jax.value_and_grad(loss_fn)`` — through K2/K3's plain version when
    ``use_flash``, against the Pallas backward in interpret mode."""
    _, over, segs = case
    batch = _batch(segments=segs)
    jcfg = jtf.tiny_config(dtype=jnp.float32, **over)
    want_loss, want = jax.value_and_grad(jtf.loss_fn)(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    cfg = tiny_config(dtype=torch.float32, **over)
    params = _port(tree, cfg)
    loss = loss_fn(params, _t(batch), cfg)
    got = torch.autograd.grad(loss, param_leaves(params))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-6)
    for a, b in zip(got, param_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_train_steps_match_optax_adamw(tree):
    """Three ``make_train_step`` steps with the port's AdamW against
    ``optax.adamw(1e-3)`` and the JAX package's update convention
    (``apply_optimizer_updates``) fed the same gradients: every
    parameter to 1e-6.  Adam's ``g / (|g| + eps)`` turns the ~3e-8
    gradient differences between XLA and PyTorch into up to ~1e-4 at the
    few elements with |g| ~ 1e-7, so optax gets the port's gradients
    (their parity is ``test_loss_and_grads_match_jax``).  End to end,
    JAX's own train step gives the same losses to 1e-5."""
    batch = _batch(seed=3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jcfg = jtf.tiny_config(dtype=jnp.float32)
    opt = optax.adamw(1e-3)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = opt.init(jparams)
    own, own_state = jparams, jstate
    own_step = jax.jit(jtf.make_train_step(jcfg, opt))
    cfg = tiny_config(dtype=torch.float32)
    params = _port(tree, cfg, requires_grad=False)
    step = make_train_step(cfg, AdamW(param_leaves(params), lr=1e-3))
    treedef = jax.tree.structure(jparams)
    for _ in range(3):
        loss = step(params, _t(batch))
        grads = jax.tree.unflatten(treedef, [
            jnp.asarray(p.grad.numpy()) for p in param_leaves(params)])
        updates, jstate = opt.update(grads, jstate, jparams)
        jparams = jtf.apply_optimizer_updates(jparams, updates)
        own, own_state, own_loss = own_step(own, own_state, jbatch)
        np.testing.assert_allclose(float(loss), float(own_loss), rtol=1e-5)
    for a, b in zip(param_leaves(params), param_leaves(jparams)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-6, rtol=1e-6)


def test_adamw_defaults_are_optax_and_bf16_leaves_step_in_fp32():
    """optax's numbers (weight decay 1e-4, not torch's 1e-2), and a bf16
    leaf receives fp32(p) + u cast once, with moments kept in bf16."""
    p = torch.full((4,), 1.0, dtype=torch.bfloat16, requires_grad=True)
    opt = AdamW([p], lr=1e-3)
    assert opt.defaults == dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                                weight_decay=1e-4)
    p.grad = torch.tensor([1.0, -1.0, 0.0, 2.0], dtype=torch.bfloat16)
    opt.step()
    u = -1e-3 * (torch.tensor([1.0, -1.0, 0.0, 1.0]) + 1e-4)
    assert torch.equal(p.detach(), (1.0 + u).to(torch.bfloat16))
    assert opt.state[p]["mu"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="lr"):
        AdamW([p], lr=0.0)
    # The same convention on a tree, against JAX's.
    tree = {"a": {"w": torch.ones(3, dtype=torch.bfloat16)}}
    apply_optimizer_updates(tree, {"a": {"w": torch.full((3,), 6e-3)}})
    want = jtf.apply_optimizer_updates(
        {"a": {"w": jnp.ones(3, jnp.bfloat16)}},
        {"a": {"w": jnp.full((3,), 6e-3)}})["a"]["w"]
    np.testing.assert_array_equal(tree["a"]["w"].float().numpy(),
                                  np.asarray(want, np.float32))
    assert float(tree["a"]["w"][0]) != 1.0


def test_lora_step_matches_jax(tree):
    """Two ``make_lora_train_step`` steps against ``optax.adamw(1e-3)``
    fed the port's adapter gradients (as in the full train step), from
    one adapter tree with ``b`` made non-zero so both factors get
    gradients: adapters to 1e-6, base untouched; JAX's own LoRA step
    gives the same losses to 1e-5."""
    batch = _batch(seed=5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jcfg = jtf.tiny_config(dtype=jnp.float32)
    jl = jax.tree.map(np.asarray, jlora.lora_init(
        jax.random.PRNGKey(2), jcfg, rank=4, targets=jlora.ALL_TARGETS))
    rng = np.random.default_rng(6)
    for ab in jl["layers"].values():
        ab["b"] = (0.02 * rng.standard_normal(ab["b"].shape)).astype(
            np.float32)
    opt = optax.adamw(1e-3)
    jparams = jax.tree.map(jnp.asarray, tree)
    jlo = jax.tree.map(jnp.asarray, jl)
    jstate = opt.init(jlo)
    own, own_state = jlo, jstate
    own_step = jax.jit(jlora.make_lora_train_step(jcfg, opt))
    cfg = tiny_config(dtype=torch.float32)
    base = _port(tree, cfg, requires_grad=False)
    lora = lora_from_jax(jl, device="cpu")
    step = make_lora_train_step(cfg, AdamW(param_leaves(lora), lr=1e-3))
    treedef = jax.tree.structure(jlo)
    for _ in range(2):
        loss = step(base, lora, _t(batch))
        grads = jax.tree.unflatten(treedef, [
            jnp.asarray(p.grad.numpy()) for p in param_leaves(lora)])
        updates, jstate = opt.update(grads, jstate, jlo)
        jlo = jtf.apply_optimizer_updates(jlo, updates)
        own, own_state, own_loss = own_step(jparams, own, own_state,
                                            jbatch)
        np.testing.assert_allclose(float(loss), float(own_loss), rtol=1e-5)
    for a, b in zip(param_leaves(lora_to_numpy(lora)), param_leaves(jlo)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=1e-6)
    for a, b in zip(param_leaves(params_to_numpy(base)), param_leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_lora_init_merge_and_count():
    """Zero-init ``b`` makes the merge the identity; the count and the
    conversion round trip match the JAX tree; expert targets on a MoE
    config and unknown targets raise."""
    cfg = tiny_config(dtype=torch.float32)
    jcfg = jtf.tiny_config(dtype=jnp.float32)
    lora = lora_init(3, cfg, rank=4, device="cpu")
    jl = jlora.lora_init(jax.random.PRNGKey(3), jcfg, rank=4)
    assert lora_num_params(lora) == jlora.lora_num_params(jl)
    for a, b in zip(param_leaves(lora), param_leaves(jl)):
        assert tuple(a.shape) == b.shape
    back = lora_from_jax(lora_to_numpy(lora), device="cpu")
    for a, b in zip(param_leaves(back), param_leaves(lora)):
        assert torch.equal(a, b)
    params = init_cpu_params(cfg)
    merged = lora_merge(params, lora)
    for name in params["layers"]:
        assert torch.equal(merged["layers"][name], params["layers"][name])
    with pytest.raises(ValueError, match="expert weights"):
        lora_init(0, tiny_moe_config(), rank=4, targets=("wq", "w_up"),
                  device="cpu")
    with pytest.raises(ValueError, match="unknown LoRA targets"):
        lora_init(0, cfg, rank=4, targets=("wz",), device="cpu")


def init_cpu_params(cfg):
    from nbdistributed_tpu_torch.models import init_params
    return init_params(cfg, 0, device="cpu")


@pytest.mark.parametrize("over", [
    {"remat_policy": "bogus", "remat": True},
    {"remat_policy": "attn_only"},
], ids=["unknown_policy", "policy_without_remat"])
def test_remat_policy_errors_match_jax(over):
    """The policy validation raises JAX's errors word for word."""
    with pytest.raises(ValueError) as want:
        jtf.make_layer_fn(jtf.tiny_config(**over), None)
    with pytest.raises(ValueError) as got:
        make_layer_fn(tiny_config(**over), None)
    assert str(got.value) == str(want.value)


def test_remat_dots_policy_names_its_roadmap_entry():
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        make_layer_fn(tiny_config(remat=True, remat_policy="dots"), None)


def test_remat_recomputes_the_flash_forward():
    """With remat each layer's forward runs again in the backward, so
    the flash forward runs twice per layer and the backward once (on
    the CPU the wrappers take the plain versions and count nothing;
    count the calls instead)."""
    cfg = tiny_config(dtype=torch.float32, remat=True)
    params = init_cpu_params(cfg)
    for p in param_leaves(params):
        p.requires_grad_()
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tattn._flash_forward_plain, tattn._flash_backward_plain

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    tattn._flash_forward_plain, tattn._flash_backward_plain = \
        count_fwd, count_bwd
    try:
        loss_fn(params, _t(_batch()), cfg).backward()
    finally:
        tattn._flash_forward_plain, tattn._flash_backward_plain = fwd, bwd
    assert calls == {"fwd": 2 * cfg.n_layers, "bwd": cfg.n_layers}


def test_shifted_xent_and_packed_positions_match_jax():
    batch = _batch(seed=9)
    rng = np.random.default_rng(10)
    logits = rng.standard_normal((B, S, 512)).astype(np.float32)
    for seg in (None, batch["segments"]):
        want = jtf.shifted_xent(jnp.asarray(logits),
                                jnp.asarray(batch["tokens"]),
                                None if seg is None else jnp.asarray(seg))
        got = shifted_xent(torch.from_numpy(logits),
                           torch.from_numpy(batch["tokens"]),
                           None if seg is None else torch.from_numpy(seg))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_array_equal(
        packed_positions(torch.from_numpy(batch["segments"])).numpy(),
        np.asarray(jtf.packed_positions(batch["segments"])))
    assert num_tokens_per_step((4, 2048)) == jtf.num_tokens_per_step(
        (4, 2048)) == 8192


@pytest.mark.parametrize("chunk", [64, 100, 512, 1000])
def test_chunked_xent_matches_jax(chunk):
    """``chunked_softmax_xent`` value and grads (x, W) against the JAX
    version, with a validity mask, at chunks that do and do not divide
    V."""
    rng = np.random.default_rng(chunk)
    x = rng.standard_normal((24, 16)).astype(np.float32)
    W = (0.3 * rng.standard_normal((16, 300))).astype(np.float32)
    tgt = rng.integers(0, 300, 24).astype(np.int32)
    valid = rng.random(24) > 0.3
    want_loss, want = jax.value_and_grad(jxent.chunked_softmax_xent,
                                         argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(W), jnp.asarray(tgt),
        jnp.asarray(valid), chunk)
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, W))
    loss = txent.chunked_softmax_xent(tx, tw, torch.from_numpy(tgt),
                                      torch.from_numpy(valid), chunk)
    got = torch.autograd.grad(loss, (tx, tw))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-5)


def test_pack_tokens_matches_jax():
    rng = np.random.default_rng(11)
    docs = [rng.integers(1, 100, int(n)) for n in rng.integers(1, 30, 9)]
    for kw in ({}, {"eos_id": 0}, {"eos_id": 0, "return_segments": True},
               {"eos_id": 7, "drop_remainder": False,
                "return_segments": True}):
        want = jdata.pack_tokens(docs, 16, **kw)
        got = tdata.pack_tokens(docs, 16, **kw)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="eos_id"):
        tdata.pack_tokens(docs, 16, drop_remainder=False)


@pytest.mark.parametrize("world,drop,epochs,seed", [
    (1, True, 1, 0), (3, True, 2, 5), (2, False, 2, None), (4, False, 1, 1)])
def test_batch_iterator_order_matches_jax(world, drop, epochs, seed):
    """Same batches, in the same order, on every rank; the ranks'
    shards interleave back into the global batch."""
    data = {"x": np.arange(23 * 3).reshape(23, 3),
            "y": np.arange(23) * 10}
    for rank in range(world):
        kw = dict(batch_size=2, rank=rank, world_size=world, seed=seed,
                  drop_remainder=drop, epochs=epochs)
        want = list(jdata.batch_iterator(data, **kw))
        got = list(tdata.batch_iterator(data, **kw))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            for k in data:
                np.testing.assert_array_equal(a[k], b[k])
    shards = [next(tdata.batch_iterator(data, batch_size=2, rank=r,
                                        world_size=world, seed=seed))
              for r in range(world)]
    want = jdata.interleave_shards(shards)
    got = tdata.interleave_shards(shards)
    for k in data:
        np.testing.assert_array_equal(got[k], want[k])


def test_rank_slice_and_shard_arrays_match_jax():
    for n, world in ((10, 3), (2, 4), (9, 1)):
        for rank in range(world):
            assert tdata.rank_slice(n, rank, world) == \
                jdata.rank_slice(n, rank, world)
    batch = {"a": np.arange(10), "b": np.arange(20).reshape(10, 2)}
    for rank in range(3):
        got = tdata.shard_arrays(batch, rank, 3)
        want = jdata.shard_arrays(batch, rank, 3)
        for k in batch:
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="rank 3 outside"):
        tdata.rank_slice(4, 3, 3)
    with pytest.raises(ValueError, match="leading-axis mismatch"):
        tdata.shard_arrays({"a": np.arange(3), "b": np.arange(4)}, 0, 1)


def test_prefetch_to_device_yields_every_batch_in_order():
    """On the CPU the batches come back as tensors, in order, whatever
    the depth; a bad depth raises at call time and the default device
    (the GPU) raises where there is none."""
    batches = [{"t": np.full((2, 3), i, np.int32)} for i in range(5)]
    for size in (1, 2, 7):
        out = list(tdata.prefetch_to_device(iter(batches), size=size,
                                            device="cpu"))
        assert [int(b["t"][0, 0]) for b in out] == list(range(5))
        assert all(b["t"].dtype == torch.int32 for b in out)
    assert list(tdata.prefetch_to_device([], device="cpu")) == []
    with pytest.raises(ValueError, match="size"):
        tdata.prefetch_to_device(batches, size=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdata.prefetch_to_device(batches)


def test_lora_on_moe_matches_jax():
    """Attention-target LoRA on a MoE config: the adapted
    ``moe_loss_fn`` and every adapter gradient against JAX's (``b`` made
    non-zero so both factors get gradients), the port's step trains
    through ``moe_loss_fn`` (its loss equals JAX's own LoRA step's), and
    expert targets raise JAX's ``ValueError``."""
    jcfg = jmoe.tiny_moe_config(dtype=jnp.float32)
    cfg = tiny_moe_config(dtype=torch.float32)
    jtree = jax.tree.map(np.asarray,
                         jmoe.init_moe_model(jax.random.PRNGKey(0), jcfg))
    jl = jax.tree.map(np.asarray, jlora.lora_init(jax.random.PRNGKey(2),
                                                  jcfg, rank=4))
    rng = np.random.default_rng(7)
    for ab in jl["layers"].values():
        ab["b"] = (0.02 * rng.standard_normal(ab["b"].shape)).astype(
            np.float32)
    batch = _batch(seed=8)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jparams = jax.tree.map(jnp.asarray, jtree)
    want_loss, want = jax.value_and_grad(lambda lo: jmoe.moe_loss_fn(
        jlora.lora_merge(jparams, lo), jbatch, jcfg))(
            jax.tree.map(jnp.asarray, jl))
    base = _port(jtree, cfg, requires_grad=False)
    lora = lora_from_jax(jl, device="cpu")
    for p in param_leaves(lora):
        p.requires_grad_()
    loss = moe_loss_fn(lora_merge(base, lora), _t(batch), cfg)
    got = torch.autograd.grad(loss, param_leaves(lora))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-6)
    for a, b in zip(got, param_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)
    opt = optax.adamw(1e-3)
    jlo = jax.tree.map(jnp.asarray, jl)
    _, _, own_loss = jlora.make_lora_train_step(jcfg, opt)(
        jparams, jlo, opt.init(jlo), jbatch)
    step = make_lora_train_step(cfg, AdamW(param_leaves(lora), lr=1e-3))
    np.testing.assert_allclose(float(step(base, lora, _t(batch))),
                               float(own_loss), rtol=1e-5)
    for targets in (("w_gate",), ("wq", "w_down")):
        with pytest.raises(ValueError) as jerr:
            jlora.lora_init(jax.random.PRNGKey(0), jcfg, 4, targets=targets)
        with pytest.raises(ValueError) as terr:
            lora_init(0, cfg, 4, targets=targets, device="cpu")
        assert str(terr.value) == str(jerr.value)
