"""The port's DecodeServer against the JAX package's and against solo
``generate`` runs, on the CPU at ``tiny_config`` float32.

Mirrors ``tests/unit/test_serving.py`` (staggered admission, slot
recycling, EOS, int8 cache, step_many, chunked and interleaved prefill,
prefix caching, speculative serving and spec_step_many, MoE configs).
Greedy tokens are compared exactly: per request, the port's server, the
port's solo generate, the JAX server with the same arguments and JAX's
solo generate must all agree.  Paged serving of the dense family is in
``test_torch_paged.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbdistributed_tpu.models import moe as jmoe
from nbdistributed_tpu.models import quant as jquant
from nbdistributed_tpu.models import transformer as jtf
from nbdistributed_tpu.models.generate import generate as jgenerate
from nbdistributed_tpu.models.serving import DecodeServer as JaxServer
from nbdistributed_tpu_torch.models import (DecodeServer, generate,
                                            params_from_jax,
                                            quantize_moe_params, tiny_config,
                                            tiny_moe_config)


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


@pytest.mark.parametrize("kwargs", [{"mesh": object()}])
def test_later_slice_arguments_raise(setup, kwargs):
    """A mesh is a later slice (ROADMAP A5, then A2)."""
    _, _, cfg, params = setup
    with pytest.raises(NotImplementedError, match="ROADMAP A[25]"):
        DecodeServer(params, cfg, max_batch=1, max_len=16, **kwargs)


# ----------------------------------------------------------------------
# against the JAX server with the same arguments


def both(setup, drive, draft=None, **kw):
    """Run ``drive(server)`` on the port's server and on the JAX
    package's, built with the same arguments (and the same draft, by
    seed); returns the port's result after checking they agree."""
    jcfg, jparams, cfg, params = setup
    if draft is not None:
        jd = jtf.init_params(jax.random.PRNGKey(draft), jcfg)
        kw_t = dict(kw, draft_params=params_from_jax(
            jax.tree.map(np.asarray, jd), cfg, device="cpu"), draft_cfg=cfg)
        kw_j = dict(kw, draft_params=jd, draft_cfg=jcfg)
    else:
        kw_t = kw_j = kw
    got = drive(DecodeServer(params, cfg, **kw_t))
    want = drive(JaxServer(jparams, jcfg, **kw_j))
    assert got == want
    return got


def submit_all(reqs):
    def drive(srv):
        rids = [srv.submit(*r) for r in reqs]
        srv.run_until_done(max_steps=200)
        return [srv.outputs[r] for r in rids]
    return drive


@pytest.mark.parametrize("L", [7, 12, 13])
def test_chunked_prefill_matches_jax_and_solo(setup, L):
    """Chunk 4: a prompt of whole chunks, one with a tail, one of a
    single full chunk plus a tail."""
    _, _, cfg, params = setup
    prompt = np.random.default_rng(40 + L).integers(1, 512, L).tolist()
    got = both(setup, submit_all([(prompt, 5), ([3, 1], 4)]), max_batch=2,
               max_len=64, pad_to=4, prefill_chunk=4)
    assert got == [solo(params, cfg, prompt, 5), solo(params, cfg, [3, 1], 4)]


def test_interleaved_prefill_matches_jax_and_solo(setup):
    """A long prompt streams in one chunk per step beside a decoding
    request, on the dense pool: the inactive row's frozen-position
    writes land at its written frontier."""
    _, _, cfg, params = setup
    long = np.random.default_rng(3).integers(1, 512, 18).tolist()

    def drive(srv):
        r0 = srv.submit([5, 9, 2], 9)
        srv.step()
        r1 = srv.submit(long, 6)
        seen = []
        while not srv.done():
            seen.append(srv.prefill_progress().get(r1))
            srv.step()
        return [srv.outputs[r0], srv.outputs[r1], seen[:6]]

    got = both(setup, drive, max_batch=2, max_len=64, pad_to=4,
               prefill_chunk=4, interleave_prefill=True)
    assert got[0] == solo(params, cfg, [5, 9, 2], 9)
    assert got[1] == solo(params, cfg, long, 6)
    assert got[2] == [(0, 18), (4, 18), (8, 18), (12, 18), (16, 18), None]


PREFIX = [3, 1, 4, 1, 5, 9, 2, 6]


def _with_prefix(reqs, prefixes=(PREFIX,)):
    def drive(srv):
        pids = [srv.cache_prefix(p) for p in prefixes]
        return [pids] + submit_all(reqs)(srv)
    return drive


@pytest.mark.parametrize("chunk,kv_quantized", [(None, False), (4, False),
                                                (None, True)])
def test_prefix_cache_matches_jax_and_solo(setup, chunk, kv_quantized):
    """Suffixes of several lengths and a prompt equal to the prefix
    (admitted with no prefill at all); chunked, and int8 KV."""
    _, _, cfg, params = setup
    reqs = [(PREFIX + s, 5) for s in ([5, 3], [8, 8, 8, 1, 7], [1], [])]
    got = both(setup, _with_prefix(reqs), max_batch=2, max_len=64, pad_to=4,
               prefill_chunk=chunk, kv_quantized=kv_quantized)
    assert got[0] == [0]
    for out, (prompt, n) in zip(got[1:], reqs):
        assert out == solo(params, cfg, prompt, n, kv_quantized=kv_quantized)


def test_prefix_cache_longest_match_miss_and_drop(setup):
    _, _, cfg, params = setup
    srv = DecodeServer(params, cfg, max_batch=2, max_len=64, pad_to=4)
    p_short = srv.cache_prefix([4, 2])
    p_long = srv.cache_prefix([4, 2, 6, 1])
    assert srv._match_prefix([4, 2, 6, 1, 9]) == p_long
    assert srv._match_prefix([4, 2, 9]) == p_short
    assert srv._match_prefix([9, 9]) is None
    reqs = [([4, 2, 6, 1, 9], 5), ([9, 9, 3], 5), ([4, 2, 7], 4)]
    got = both(setup, _with_prefix(reqs, ([4, 2], [4, 2, 6, 1])),
               max_batch=2, max_len=64, pad_to=4)
    assert got[1:] == [solo(params, cfg, p, n) for p, n in reqs]
    srv.drop_prefix(p_long)
    assert srv._match_prefix([4, 2, 6, 1, 9]) == p_short
    with pytest.raises(KeyError):
        srv.drop_prefix(p_long)
    with pytest.raises(ValueError, match="empty"):
        srv.cache_prefix([])
    with pytest.raises(ValueError, match="max_len"):
        srv.cache_prefix(list(range(64)))


def test_prefix_cache_saves_prefill_positions(setup):
    """With a cached 16-token prefix each admission feeds only its
    suffix's bucket through the prefill forward; a whole-prompt hit
    feeds none (counted as the JAX package's test counts them)."""
    _, _, cfg, params = setup
    prefix, suffix = list(range(1, 17)), [7, 3]
    fed = {"with": 0, "without": 0}

    def counting(srv, key):
        orig = srv._prefill_fn

        def wrapper(p, cache, prompt, slot, start, length):
            fed[key] += prompt.shape[1]
            return orig(p, cache, prompt, slot, start, length)

        srv._prefill_fn = wrapper

    a = DecodeServer(params, cfg, max_batch=1, max_len=64, pad_to=4)
    a.cache_prefix(prefix)
    counting(a, "with")
    b = DecodeServer(params, cfg, max_batch=1, max_len=64, pad_to=4)
    counting(b, "without")
    for srv in (a, b):
        for _ in range(3):
            srv.submit(prefix + suffix, 3)
        srv.submit(prefix, 3)
        srv.run_until_done(max_steps=100)
    assert fed == {"with": 3 * 4, "without": 3 * 20 + 16}
    assert list(a.outputs.values()) == list(b.outputs.values())


@pytest.fixture(scope="module")
def spec(setup):
    """The JAX package's speculative-serving draft: the target's config
    at another seed (a worse model)."""
    jcfg, _, cfg, _ = setup
    return params_from_jax(jax.tree.map(np.asarray, jtf.init_params(
        jax.random.PRNGKey(42), jcfg)), cfg, device="cpu")


def test_spec_serving_staggered_matches_jax_and_solo(setup):
    _, _, cfg, params = setup
    reqs, got = both(setup, _staggered_spec, draft=42, max_batch=2,
                     max_len=64, pad_to=4, gamma=3)
    for out, (prompt, n) in zip(got, reqs):
        assert out == solo(params, cfg, prompt, n) and len(out) == n


def _staggered_spec(srv):
    reqs = [([5, 9, 2], 9), ([7, 1, 3, 11], 6), ([2, 2], 7)]
    r0 = srv.submit(*reqs[0])
    srv.step()
    r1 = srv.submit(*reqs[1])
    srv.step()
    r2 = srv.submit(*reqs[2])
    srv.run_until_done(max_steps=100)
    return reqs, [srv.outputs[r] for r in (r0, r1, r2)]


def test_spec_serving_self_draft_emits_gamma_plus_one(setup):
    _, _, cfg, params = setup
    srv = DecodeServer(params, cfg, max_batch=1, max_len=64, pad_to=4,
                       draft_params=params, draft_cfg=cfg, gamma=3)
    rid = srv.submit([5, 9, 2], 13)
    assert len(srv.step()[rid]) == 4
    srv.run_until_done(max_steps=20)
    assert srv.outputs[rid] == solo(params, cfg, [5, 9, 2], 13)


def test_spec_serving_eos_and_top_k1(setup, spec):
    _, _, cfg, params = setup
    prompt, n = [5, 9, 2], 10
    toks = solo(params, cfg, prompt, n)
    srv = DecodeServer(params, cfg, max_batch=1, max_len=64, pad_to=4,
                       eos_id=toks[4], draft_params=spec, draft_cfg=cfg,
                       gamma=3)
    rid = srv.submit(prompt, n)
    srv.run_until_done(max_steps=50)
    assert srv.outputs[rid] == toks[:5]
    srv = DecodeServer(params, cfg, max_batch=2, max_len=64, pad_to=4,
                       temperature=0.8, top_k=1, draft_params=spec,
                       draft_cfg=cfg, gamma=3, seed=11)
    reqs = [([5, 9, 2], 8), ([7, 1, 3, 11], 6)]
    rids = [srv.submit(*r) for r in reqs]
    srv.run_until_done(max_steps=100)
    assert [srv.outputs[r] for r in rids] == [solo(params, cfg, *r)
                                              for r in reqs]


def test_spec_step_many_matches_steps_and_jax(setup):
    _, _, cfg, params = setup
    reqs = [([5, 9, 2], 9), ([7, 1, 3, 11], 7)]

    def drive(srv):
        rids = [srv.submit(*r) for r in reqs]
        first = srv.spec_step_many(2)
        while not srv.done():
            srv.spec_step_many(2)
        return [first, [srv.outputs[r] for r in rids]]

    got = both(setup, drive, draft=42, max_batch=2, max_len=64, pad_to=4,
               gamma=3)
    assert got[1] == [solo(params, cfg, *r) for r in reqs]
    single = both(setup, submit_all(reqs), draft=42, max_batch=2,
                  max_len=64, pad_to=4, gamma=3)
    assert single == got[1]


def test_spec_step_many_freezes_at_max_len(setup, spec):
    """The tightest legal max_len (prompt + budget + gamma + 1):
    surplus rounds stop on the device instead of overflowing."""
    _, _, cfg, params = setup
    prompt, n, gamma = [5, 9, 2], 6, 3
    srv = DecodeServer(params, cfg, max_batch=1,
                       max_len=len(prompt) + n + gamma + 1, pad_to=4,
                       draft_params=spec, draft_cfg=cfg, gamma=gamma)
    rid = srv.submit(prompt, n)
    while not srv.done():
        srv.spec_step_many(4)
    assert srv.outputs[rid] == solo(params, cfg, prompt, n)


@pytest.mark.parametrize("chunk,interleave", [(4, False), (4, True)])
def test_spec_serving_chunked_and_prefix(setup, spec, chunk, interleave):
    """Both caches prefill chunk by chunk (interleaved too: the draft's
    cache streams in beside the target's) and absorb a cached prefix;
    greedy streams equal the target's solo decode."""
    _, _, cfg, params = setup
    prefix = [5, 1, 5, 1, 5, 1]
    reqs = [(prefix + [2, 6], 6), ([5, 9, 2, 7, 1, 3, 11, 4, 6], 6),
            (prefix + [9], 6)]
    srv = DecodeServer(params, cfg, max_batch=2, max_len=64, pad_to=4,
                       draft_params=spec, draft_cfg=cfg, gamma=2,
                       prefill_chunk=chunk, interleave_prefill=interleave)
    srv.cache_prefix(prefix)
    rids = [srv.submit(*r) for r in reqs]
    srv.run_until_done(max_steps=100)
    assert [srv.outputs[r] for r in rids] == [solo(params, cfg, *r)
                                              for r in reqs]


def test_multi_step_refusals_and_spec_validation(setup, spec):
    _, _, cfg, params = setup
    plain = DecodeServer(params, cfg, max_batch=1, max_len=32, pad_to=4)
    with pytest.raises(ValueError, match="speculative server"):
        plain.spec_step_many(2)
    with pytest.raises(ValueError, match=">= 1"):
        plain.step_many(0)
    sp = DecodeServer(params, cfg, max_batch=1, max_len=16, pad_to=4,
                      draft_params=spec, draft_cfg=cfg, gamma=3)
    with pytest.raises(ValueError, match="plain serving"):
        sp.step_many(2)
    with pytest.raises(ValueError, match=">= 1"):
        sp.spec_step_many(0)
    with pytest.raises(ValueError, match="speculative headroom"):
        sp.submit([1, 2, 3, 4], 9)          # 4 + 9 + 4 > 16
    for kw, match in ((dict(draft_params=spec), "both draft_params"),
                      (dict(draft_params=spec, draft_cfg=cfg, gamma=0),
                       "gamma"),
                      (dict(prefill_chunk=0), "prefill_chunk"),
                      (dict(top_p=0.0), "top_p")):
        with pytest.raises(ValueError, match=match):
            DecodeServer(params, cfg, max_batch=1, max_len=32, **kw)


def test_spec_interleaved_prefill_keeps_the_draft_pointer(setup):
    """ROADMAP C1: while a prompt streams in chunk by chunk beside a live
    speculative stream, the draft's cache pointer follows the written
    frontier as the target's does, so the rounds' frozen-position draft
    writes land where the next chunk overwrites them.  A self-draft's
    cache then equals the target's row for row at activation, and every
    round before the budget cut accepts all gamma proposals."""
    _, _, cfg, params = setup
    gamma, budget = 4, 20
    srv = DecodeServer(params, cfg, max_batch=2, max_len=128, pad_to=4,
                       draft_params=params, draft_cfg=cfg, gamma=gamma,
                       prefill_chunk=16, interleave_prefill=True)
    srv.submit([5, 9, 2, 7], 40)
    srv.step()
    prompt = np.random.default_rng(60).integers(1, 512, 60).tolist()
    rid = srv.submit(prompt, budget)
    slot = next(s for s, st in srv._prefilling.items() if st[0] == rid)
    while rid in srv.prefill_progress():
        srv.step()
    for name in ("k", "v"):
        assert torch.equal(srv._cache_d[name][:, slot, :, :60],
                           srv._cache[name][:, slot, :, :60]), name
    per_round = [len(srv.outputs[rid]) - 1]
    while rid not in srv.finished:
        per_round.append(len(srv.step().get(rid, [])))
    assert per_round[:-1] == [gamma + 1] * (len(per_round) - 1)
    assert sum(per_round) == budget - 1
    assert srv.outputs[rid] == solo(params, cfg, prompt, budget)


# ----------------------------------------------------------------------
# MoE configs, against the JAX server with the same arguments


@pytest.fixture(scope="module")
def moe():
    """``tiny_moe_config`` float32: the target (seed 0) and a draft
    (seed 42) in both packages."""
    jcfg = jmoe.tiny_moe_config(dtype=jnp.float32, use_flash=False)
    cfg = tiny_moe_config(dtype=torch.float32)
    trees = [jax.tree.map(np.asarray, jmoe.init_moe_model(
        jax.random.PRNGKey(seed), jcfg)) for seed in (0, 42)]
    return dict(jcfg=jcfg, cfg=cfg,
                jparams=[jax.tree.map(jnp.asarray, t) for t in trees],
                params=[params_from_jax(t, cfg, device="cpu") for t in trees])


MOE_MODES = {"dense": {}, "paged": {"kv_block_tokens": 8},
             "speculative": {"draft": True, "gamma": 3},
             "int8_weights": {"quantized": True},
             "int8_kv": {"kv_quantized": True}}


@pytest.mark.parametrize("mode", list(MOE_MODES))
def test_moe_server_matches_jax_server(moe, mode):
    """Staggered admission into a 2-slot pool (live requests pool expert
    capacity): the port's greedy tokens equal the JAX server's with the
    same arguments, on the dense pool, paged, with a MoE draft, on a
    ``quantize_moe_params`` tree and with an int8 cache."""
    kw = dict(MOE_MODES[mode])
    draft, quantized = kw.pop("draft", False), kw.pop("quantized", False)
    jp, tp = moe["jparams"][0], moe["params"][0]
    if quantized:
        jp, tp = jquant.quantize_moe_params(jp), quantize_moe_params(tp)
    kw_t = kw_j = dict(kw, max_batch=2, max_len=64, pad_to=4)
    if draft:
        kw_t = dict(kw_t, draft_params=moe["params"][1], draft_cfg=moe["cfg"])
        kw_j = dict(kw_j, draft_params=moe["jparams"][1],
                    draft_cfg=moe["jcfg"])
    srv = DecodeServer(tp, moe["cfg"], **kw_t)
    assert srv._pad_to == 1
    reqs, got = _staggered(srv)
    _, want = _staggered(JaxServer(jp, moe["jcfg"], **kw_j))
    assert got == want
    assert [len(o) for o in got] == [n for _, n in reqs]


def test_moe_lone_request_and_exact_length_admission(moe):
    """A request served alone equals solo ``generate`` (JAX's too), and
    a 20-token prompt is admitted at its exact length although pad_to=64
    was asked for: at capacity factor 1 a 64-token bucket would give the
    experts capacity 32 where the solo run has 16 (JAX
    ``test_serving.py:181``)."""
    jcfg, cfg = moe["jcfg"], moe["cfg"]
    jparams, params = moe["jparams"][0], moe["params"][0]
    srv = DecodeServer(params, cfg, max_batch=2, max_len=32, pad_to=4)
    rid = srv.submit([5, 1, 3], 5)
    srv.run_until_done(max_steps=50)
    assert srv.outputs[rid] == solo(params, cfg, [5, 1, 3], 5) == \
        jax_solo(jparams, jcfg, [5, 1, 3], 5)
    cfg1 = tiny_moe_config(dtype=torch.float32, capacity_factor=1.0)
    jcfg1 = jmoe.tiny_moe_config(dtype=jnp.float32, use_flash=False,
                                 capacity_factor=1.0)
    prompt = np.random.default_rng(101).integers(1, 512, 20).tolist()
    srv = DecodeServer(params, cfg1, max_batch=1, max_len=80, pad_to=64)
    rid = srv.submit(prompt, 4)
    srv.run_until_done(max_steps=50)
    assert srv.outputs[rid] == solo(params, cfg1, prompt, 4) == \
        jax_solo(jparams, jcfg1, prompt, 4)


def test_moe_server_refuses_chunked_prefill_and_prefix_caching(moe):
    """JAX's refusals, word for word: both would prefill at a token count
    other than a solo run's, and expert capacity follows it."""
    jcfg, cfg = moe["jcfg"], moe["cfg"]
    jparams, params = moe["jparams"][0], moe["params"][0]
    with pytest.raises(ValueError) as want:
        JaxServer(jparams, jcfg, max_batch=1, max_len=32, prefill_chunk=4)
    with pytest.raises(ValueError) as got:
        DecodeServer(params, cfg, max_batch=1, max_len=32, prefill_chunk=4)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        JaxServer(jparams, jcfg, max_batch=1, max_len=32).cache_prefix([1, 2])
    with pytest.raises(ValueError) as got:
        DecodeServer(params, cfg, max_batch=1, max_len=32).cache_prefix([1, 2])
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        DecodeServer(params, cfg, max_batch=1, max_len=32, mesh=object())
