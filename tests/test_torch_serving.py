"""The port's DecodeServer against the JAX package's and against solo
``generate`` runs, on the CPU at ``tiny_config`` float32.

Mirrors ``tests/unit/test_serving.py`` (staggered admission, slot
recycling, EOS, int8 cache, step_many).  Greedy tokens are compared
exactly: per request, the port's server, the port's solo generate, the
JAX server and JAX's solo generate must all agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbdistributed_tpu.models import transformer as jtf
from nbdistributed_tpu.models.generate import generate as jgenerate
from nbdistributed_tpu.models.serving import DecodeServer as JaxServer
from nbdistributed_tpu_torch.models import (DecodeServer, generate,
                                            params_from_jax, tiny_config)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast, and leaves the
    cores to the suite's other workers."""
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
    out = generate(params, [prompt], cfg, n, **kw)
    return out[0, len(prompt):].tolist()


def jax_solo(jparams, jcfg, prompt, n, **kw):
    out = jgenerate(jparams, jnp.asarray(prompt, jnp.int32)[None], jcfg, n,
                    **kw)
    return [int(t) for t in np.asarray(out)[0][len(prompt):]]


def _staggered(srv):
    reqs = [([5, 9, 2], 7), ([7, 1, 3, 11, 4], 5), ([2, 2], 6)]
    r0 = srv.submit(*reqs[0])
    srv.step()
    r1 = srv.submit(*reqs[1])          # fills the second slot
    srv.step()
    r2 = srv.submit(*reqs[2])          # queues until a slot frees
    srv.run_until_done(max_steps=100)
    return reqs, [srv.outputs[r] for r in (r0, r1, r2)]


def test_staggered_admission_matches_solo_and_jax_server(setup):
    jcfg, jparams, cfg, params = setup
    reqs, got = _staggered(DecodeServer(params, cfg, max_batch=2,
                                        max_len=64, pad_to=4))
    _, want = _staggered(JaxServer(jparams, jcfg, max_batch=2, max_len=64,
                                   pad_to=4))
    assert got == want
    for out, (prompt, n) in zip(got, reqs):
        assert out == solo(params, cfg, prompt, n)
        assert out == jax_solo(jparams, jcfg, prompt, n)


def test_slots_recycle_and_outputs_complete(setup):
    _, _, cfg, params = setup
    srv = DecodeServer(params, cfg, max_batch=2, max_len=32, pad_to=4)
    rids = [srv.submit([i + 1, i + 2], 4) for i in range(5)]
    srv.run_until_done(max_steps=200)
    assert srv.done() and srv.n_active == 0
    for rid in rids:
        assert len(srv.outputs[rid]) == 4
        assert srv.outputs[rid] == solo(params, cfg, srv.prompts[rid], 4)
    assert srv.finished == set(rids)
    assert srv.prefill_tokens_total == 10
    assert srv.decode_tokens_total == 15
    assert srv.prefill_progress() == {}
    out0 = list(srv.outputs[rids[0]])
    assert srv.release(rids[0]) == out0 and rids[0] not in srv.outputs
    with pytest.raises(KeyError):
        srv.release(rids[0])


def test_eos_frees_slot_early(setup):
    _, _, cfg, params = setup
    prompt, n = [5, 9, 2], 8
    toks = solo(params, cfg, prompt, n)
    eos = toks[2]
    srv = DecodeServer(params, cfg, max_batch=1, max_len=64, pad_to=4,
                       eos_id=eos)
    rid = srv.submit(prompt, n)
    srv.run_until_done(max_steps=50)
    got = srv.outputs[rid]
    assert got == toks[:got.index(eos) + 1]
    assert got[-1] == eos and len(got) <= n


def test_int8_cache_serving_matches_int8_generate(setup):
    jcfg, jparams, cfg, params = setup
    prompt, n = [5, 9, 2, 7], 6
    srv = DecodeServer(params, cfg, max_batch=2, max_len=32, pad_to=4,
                       kv_quantized=True)
    rid = srv.submit(prompt, n)
    srv.run_until_done(max_steps=50)
    assert srv.outputs[rid] == solo(params, cfg, prompt, n,
                                    kv_quantized=True)
    assert srv.outputs[rid] == jax_solo(jparams, jcfg, prompt, n,
                                        kv_quantized=True)


def test_step_many_matches_single_steps(setup):
    _, _, cfg, params = setup
    reqs = [([5, 9, 2], 9), ([7, 1, 3, 11], 7)]
    a = DecodeServer(params, cfg, max_batch=2, max_len=64, pad_to=4)
    b = DecodeServer(params, cfg, max_batch=2, max_len=64, pad_to=4)
    ra = [a.submit(*r) for r in reqs]
    rb = [b.submit(*r) for r in reqs]
    for _ in range(8):
        a.step()
    b.step_many(4)
    b.step_many(4)
    for x, y in zip(ra, rb):
        assert a.outputs[x] == b.outputs[y]
    a.run_until_done(max_steps=20)
    b.run_until_done(max_steps=20)
    for y, (prompt, n) in zip(rb, reqs):
        assert b.outputs[y] == solo(params, cfg, prompt, n)


def test_cancel_sampling_and_validation(setup):
    _, _, cfg, params = setup
    srv = DecodeServer(params, cfg, max_batch=1, max_len=16, pad_to=4,
                       temperature=1.0, top_k=8, seed=7)
    with pytest.raises(ValueError, match="empty"):
        srv.submit([], 4)
    with pytest.raises(ValueError, match=">= 1"):
        srv.submit([1], 0)
    with pytest.raises(ValueError, match="exceeds max_len"):
        srv.submit([1] * 10, 10)
    r0 = srv.submit([4, 2], 5)
    r1 = srv.submit([9], 3)                      # pending: one slot
    assert srv.cancel(r1) and not srv.cancel(r1 + 5)
    with pytest.raises(ValueError, match="in flight"):
        srv.release(r0)
    srv.run_until_done(max_steps=20)
    assert len(srv.outputs[r0]) == 5
    assert all(0 <= t < cfg.vocab_size for t in srv.outputs[r0])


@pytest.mark.parametrize("kwargs", [
    {"mesh": object()}, {"draft_params": {}}, {"prefill_chunk": 4},
    {"kv_block_tokens": 8}, {"interleave_prefill": True}])
def test_later_slice_arguments_raise(setup, kwargs):
    _, _, cfg, params = setup
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DecodeServer(params, cfg, max_batch=1, max_len=16, **kwargs)
    srv = DecodeServer(params, cfg, max_batch=1, max_len=16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        srv.cache_prefix([1, 2])
