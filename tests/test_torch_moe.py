"""The port's MoE model family (``nbdistributed_tpu_torch/models/moe.py``)
against the JAX package's on the CPU at ``tiny_moe_config`` float32.

Both packages get the same parameters (JAX ``init_moe_model``, converted
with ``params_from_jax``) and the same numpy batches.  The JAX side runs
its Pallas flash kernel in interpret mode where ``use_flash`` is on.
Logits to 1e-5 absolute, aux and losses to 1e-6 relative; every
gradient leaf to 1e-4 relative L2 (two layers of fp32 products and
attention sums taken in other orders by XLA and PyTorch).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbdistributed_tpu.models import moe as jmoe
from nbdistributed_tpu.models import quant as jquant
from nbdistributed_tpu.utils import data as jdata
from nbdistributed_tpu_torch.models import (MoEConfig, init_moe_model,
                                            mixtral_8x7b_config, moe_forward,
                                            moe_loss_fn, named_param_leaves,
                                            param_leaves, params_from_jax,
                                            params_to_numpy, tiny_moe_config)

B, S = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree():
    cfg = jmoe.tiny_moe_config(dtype=jnp.float32)
    return jax.tree.map(np.asarray,
                        jmoe.init_moe_model(jax.random.PRNGKey(0), cfg))


def _batch(seed=1, segments=True):
    """Packed random documents: tokens and segment ids (B, S)."""
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, 512, int(rng.integers(5, 20)))
            for _ in range(12)]
    tokens, segs = jdata.pack_tokens(docs, S, eos_id=0, return_segments=True)
    batch = {"tokens": tokens[:B]}
    if segments:
        batch["segments"] = segs[:B]
    return batch


def _port(tree, cfg, requires_grad=False):
    params = params_from_jax(tree, cfg, device="cpu")
    for p in param_leaves(params):
        p.requires_grad_(requires_grad)
    return params


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_init_moe_model_layout_dtypes_and_seed(tree):
    cfg = tiny_moe_config()
    a = init_moe_model(cfg, 5, device="cpu")
    b = init_moe_model(cfg, 5, device="cpu")
    got = named_param_leaves(a)
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [n for n, _ in got] == ["/".join(k.key for k in p)
                                   for p, _ in want]
    for (name, x), (_, y) in zip(got, want):
        assert tuple(x.shape) == y.shape, name
        assert x.dtype == (torch.float32 if "norm" in name or "router" in name
                           else torch.bfloat16), name
    assert all(torch.equal(x, y) for x, y in zip(param_leaves(a),
                                                 param_leaves(b)))
    assert abs(float(a["layers"]["moe"]["router"].std()) - 0.02) < 0.005


@pytest.mark.parametrize("factory", ["tiny_moe_config", "mixtral_8x7b_config"])
def test_configs_and_num_params_match_jax(factory):
    got = {"tiny_moe_config": tiny_moe_config,
           "mixtral_8x7b_config": mixtral_8x7b_config}[factory]()
    want = getattr(jmoe, factory)()
    assert isinstance(got, MoEConfig)
    assert got.num_params() == want.num_params()
    for f in dataclasses.fields(want):
        if f.name != "dtype":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert mixtral_8x7b_config(n_layers=2).n_layers == 2


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_params_from_jax_round_trip_with_moe_subtree(kind):
    """JAX -> port -> numpy, every leaf bit for bit in its own dtype: the
    fp32 router, the experts in the model dtype, int8 members of a
    ``quantize_moe_params`` tree as integers."""
    jdt = jnp.float32 if kind == "float32" else jnp.bfloat16
    jcfg = jmoe.tiny_moe_config(dtype=jdt)
    jtree = jmoe.init_moe_model(jax.random.PRNGKey(3), jcfg)
    if kind == "int8":
        jtree = jquant.quantize_moe_params(jtree)
    jtree = jax.tree.map(np.asarray, jtree)
    cfg = tiny_moe_config(dtype=torch.bfloat16 if kind != "float32"
                          else torch.float32)
    params = params_from_jax(jtree, cfg, device="cpu")
    moe = params["layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    if kind == "int8":
        assert moe["w_gate"]["q8"].dtype == torch.int8
        assert params["layers"]["wq"]["q8"].dtype == torch.int8
    else:
        assert moe["w_gate"].dtype == cfg.dtype
    got = jax.tree_util.tree_flatten_with_path(params_to_numpy(params))[0]
    want = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        b = np.asarray(b, np.float32) if b.dtype.kind == "V" or str(
            b.dtype) == "bfloat16" else b
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    bad = jax.tree.map(lambda a: a, jtree)
    bad["layers"]["moe"]["router"] = jtree["layers"]["moe"]["router"][:, :, :2]
    with pytest.raises(ValueError, match="moe/router"):
        params_from_jax(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="moe/w_gate"):
        params_from_jax(jtree, tiny_moe_config(d_ff=128), device="cpu")


# (name, config overrides, segments)
FORWARD_CASES = [("flash", {}, False), ("flash_segments", {}, True),
                 ("plain_attention", {"use_flash": False}, True),
                 ("sparse", {"moe_dispatch": "sparse", "use_flash": False},
                  False),
                 ("dropless", {"moe_dispatch": "dropless",
                               "use_flash": False}, True),
                 ("tight_capacity", {"capacity_factor": 0.5,
                                     "use_flash": False}, False)]


@pytest.mark.parametrize("case", FORWARD_CASES,
                         ids=[c[0] for c in FORWARD_CASES])
def test_moe_forward_matches_jax(tree, case):
    _, over, segs = case
    batch = _batch(seed=2, segments=segs)
    seg = batch.get("segments")
    jcfg = jmoe.tiny_moe_config(dtype=jnp.float32, **over)
    want, want_aux = jmoe.moe_forward(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(batch["tokens"]), jcfg,
        segment_ids=None if seg is None else jnp.asarray(seg))
    cfg = tiny_moe_config(dtype=torch.float32, **over)
    got, aux = moe_forward(_port(tree, cfg), torch.from_numpy(
        batch["tokens"]), cfg, segment_ids=None if seg is None
        else torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)


LOSS_CASES = [("flash", {}, False), ("flash_segments", {}, True),
              ("ce_chunk", {"ce_chunk": 100}, True),
              ("sparse", {"moe_dispatch": "sparse", "use_flash": False}, True),
              ("dropless", {"moe_dispatch": "dropless", "use_flash": False},
               False),
              ("tight_capacity", {"capacity_factor": 0.5, "use_flash": False},
               True)]


@pytest.mark.parametrize("case", LOSS_CASES, ids=[c[0] for c in LOSS_CASES])
def test_moe_loss_and_grads_match_jax(tree, case):
    """``moe_loss_fn`` and every gradient leaf (the router's included)
    against ``jax.value_and_grad(moe_loss_fn)``: through K2/K3's plain
    version when ``use_flash``, against the Pallas backward in
    interpret mode."""
    _, over, segs = case
    batch = _batch(seed=3, segments=segs)
    jcfg = jmoe.tiny_moe_config(dtype=jnp.float32, **over)
    want_loss, want = jax.value_and_grad(jmoe.moe_loss_fn)(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    cfg = tiny_moe_config(dtype=torch.float32, **over)
    params = _port(tree, cfg, requires_grad=True)
    loss = moe_loss_fn(params, {k: torch.from_numpy(v)
                                for k, v in batch.items()}, cfg)
    got = torch.autograd.grad(loss, param_leaves(params))
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-6)
    names = [n for n, _ in named_param_leaves(params)]
    for name, a, b in zip(names, got, param_leaves(want)):
        assert _rel_l2(a.numpy(), b) <= 1e-4, name


def test_model_loss_equal_across_dispatch_modes(tree):
    """At lossless capacity the three modes give one loss, as in JAX
    (``test_expert.py:237``), and that loss is JAX's."""
    tok = np.random.default_rng(13).integers(0, 512, (2, 16))
    losses = []
    for mode in ("dense", "sparse", "dropless"):
        cfg = tiny_moe_config(dtype=torch.float32, use_flash=False,
                              moe_dispatch=mode)
        losses.append(float(moe_loss_fn(_port(tree, cfg),
                                        {"tokens": torch.from_numpy(tok)},
                                        cfg)))
    want = float(jmoe.moe_loss_fn(
        jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(tok)},
        jmoe.tiny_moe_config(dtype=jnp.float32, use_flash=False)))
    assert max(losses) - min(losses) < 1e-5
    assert losses[0] == pytest.approx(want, rel=1e-6)


def test_parallel_arguments_name_their_roadmap_entries(tree):
    cfg = tiny_moe_config(dtype=torch.float32)
    params = _port(tree, cfg)
    tok = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        moe_forward(params, tok, cfg, sp=object())
    with pytest.raises(NotImplementedError, match="ROADMAP A5a"):
        moe_forward(params, tok, cfg, mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP A5a"):
        moe_loss_fn(params, {"tokens": tok}, cfg, mesh=object())
