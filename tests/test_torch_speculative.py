"""The port's speculative decoding against the JAX package and the
target's own greedy decode on the CPU, at ``tiny_config`` float32 with a
one-layer draft.

Greedy tokens are compared exactly.  Sampled mode cannot match JAX draw
for draw (``torch.Generator`` against ``jax.random``), so it is held by
seed determinism, the vocabulary range and a distribution test at a
16-token vocabulary: the token the accept / resample rule decides must
follow the target's own sampling distribution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbdistributed_tpu.models import TransformerConfig as JaxConfig
from nbdistributed_tpu.models import speculative as jspec
from nbdistributed_tpu.models import transformer as jtf
from nbdistributed_tpu_torch.models import (DecodeServer, TransformerConfig,
                                            generate, init_params,
                                            params_from_jax, quantize_params4,
                                            speculative_generate, tiny_config,
                                            tiny_moe_config)
from nbdistributed_tpu_torch.models import speculative as tspec

DRAFT = dict(d_model=64, n_layers=1, n_heads=2, n_kv_heads=2, d_ff=128,
             max_seq_len=256)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = jtf.tiny_config(dtype=jnp.float32, use_flash=False)
    jdcfg = JaxConfig(vocab_size=jcfg.vocab_size, dtype=jnp.float32,
                      use_flash=False, **DRAFT)
    cfg = tiny_config(dtype=torch.float32)
    dcfg = TransformerConfig(vocab_size=cfg.vocab_size, dtype=torch.float32,
                             **DRAFT)
    trees = [jax.tree.map(np.asarray, jtf.init_params(
        jax.random.PRNGKey(seed), c)) for seed, c in ((0, jcfg), (1, jdcfg))]
    return dict(jcfg=jcfg, jdcfg=jdcfg, cfg=cfg, dcfg=dcfg,
                jparams=jax.tree.map(jnp.asarray, trees[0]),
                jdraft=jax.tree.map(jnp.asarray, trees[1]),
                params=params_from_jax(trees[0], cfg, device="cpu"),
                draft=params_from_jax(trees[1], dcfg, device="cpu"))


def _prompts(seed, B, S0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S0),
                                                dtype=np.int64)


def target_greedy(s, prompts, n):
    return generate(s["params"], prompts, s["cfg"], n).tolist()


@pytest.mark.parametrize("gamma,B", [(1, 1), (3, 1), (5, 1), (3, 4)])
def test_greedy_equals_jax_and_target_decode(setup, gamma, B):
    s = setup
    prompts = _prompts(gamma + B, B, 7)
    got, acc = speculative_generate(s["params"], s["draft"], prompts,
                                    s["cfg"], s["dcfg"], 12, gamma=gamma)
    want, jacc = jspec.speculative_generate(
        s["jparams"], s["jdraft"], jnp.asarray(prompts, jnp.int32),
        s["jcfg"], s["jdcfg"], 12, gamma=gamma)
    assert got.tolist() == np.asarray(want).tolist()
    assert got.tolist() == target_greedy(s, prompts, 12)
    assert acc == pytest.approx(float(jacc), abs=1e-6)
    assert 0.0 <= acc <= gamma


def test_batched_rows_equal_single_stream_runs(setup):
    s = setup
    prompts = _prompts(12, 3, 6)
    got, _ = speculative_generate(s["params"], s["draft"], prompts,
                                  s["cfg"], s["dcfg"], 9, gamma=2)
    for b in range(3):
        one, _ = speculative_generate(s["params"], s["draft"],
                                      prompts[b:b + 1], s["cfg"], s["dcfg"],
                                      9, gamma=2)
        assert got[b].tolist() == one[0].tolist()


def test_self_draft_accepts_everything(setup):
    s = setup
    prompts = _prompts(2, 1, 7)
    got, acc = speculative_generate(s["params"], s["params"], prompts,
                                    s["cfg"], s["cfg"], 10, gamma=4)
    assert got.tolist() == target_greedy(s, prompts, 10)
    assert acc == 4.0


@pytest.mark.parametrize("seed", [2, 3])
def test_int4_draft_exact_with_jax_acceptance(setup, seed):
    """Draft = the int4-quantized target: the tokens are the target's
    greedy decode, and the acceptance is the JAX package's with its own
    int4 draft (greedy rounds are deterministic)."""
    from nbdistributed_tpu.models.quant import quantize_params4 as jq4
    s = setup
    prompts = _prompts(seed, 1, 7)
    got, acc = speculative_generate(s["params"],
                                    quantize_params4(s["params"]), prompts,
                                    s["cfg"], s["cfg"], 12, gamma=4)
    _, jacc = jspec.speculative_generate(
        s["jparams"], jq4(s["jparams"]), jnp.asarray(prompts, jnp.int32),
        s["jcfg"], s["jcfg"], 12, gamma=4)
    assert got.tolist() == target_greedy(s, prompts, 12)
    assert acc == pytest.approx(float(jacc), abs=1e-6) and acc > 0


def test_int8_kv_self_draft(setup):
    """Both caches int8: a self-draft agrees with the int8-cache greedy
    decode, and batched rows behave as the single row."""
    s = setup
    prompt = _prompts(2, 1, 7)
    got, acc = speculative_generate(s["params"], s["params"], prompt,
                                    s["cfg"], s["cfg"], 10, gamma=3,
                                    kv_quantized=True)
    ref = generate(s["params"], prompt, s["cfg"], 10, kv_quantized=True)
    assert float((got == ref).float().mean()) > 0.9 and acc > 0
    rows, _ = speculative_generate(s["params"], s["params"],
                                   np.tile(prompt, (3, 1)), s["cfg"],
                                   s["cfg"], 10, gamma=3, kv_quantized=True)
    assert all(r == got[0].tolist() for r in rows.tolist())


@pytest.mark.parametrize("B,S0,new,gamma", [
    (1, 1, 1, 1),    # the seed token only: no round runs
    (2, 1, 3, 5),    # gamma past max_new_tokens
    (3, 7, 2, 4),    # one round, wide draft past the target count
    (5, 2, 6, 3),    # odd batch, short prompts
])
def test_edge_geometries_exact(setup, B, S0, new, gamma):
    s = setup
    prompts = _prompts(40 + B, B, S0)
    got, acc = speculative_generate(s["params"], s["draft"], prompts,
                                    s["cfg"], s["dcfg"], new, gamma=gamma)
    assert got.shape == (B, S0 + new)
    assert got.tolist() == target_greedy(s, prompts, new)
    assert 0.0 <= acc <= gamma
    big, _ = speculative_generate(s["params"], s["draft"], prompts,
                                  s["cfg"], s["dcfg"], new, gamma=gamma,
                                  max_len=128)
    assert big.tolist() == got.tolist()


def test_greedy_accept_rule_matches_jax():
    """``_accept`` at temperature 0 on rows whose drafts match the
    target's argmax for a varying number of positions."""
    rng = np.random.default_rng(5)
    B, g, V = 6, 4, 16
    vl = rng.standard_normal((B, g + 1, V)).astype(np.float32)
    drafts = vl[:, :g].argmax(-1)
    for b in range(B):                      # row b diverges at b (or never)
        if b < g:
            drafts[b, b] = (drafts[b, b] + 1) % V
    dl = rng.standard_normal((B, g, V)).astype(np.float32)
    n_acc, nxt = tspec._accept(torch.from_numpy(drafts), torch.from_numpy(dl),
                               torch.from_numpy(vl), 0.0)
    for b in range(B):
        jn, jt = jspec._accept(jnp.asarray(drafts[b]), jnp.asarray(dl[b]),
                               jnp.asarray(vl[b]), 0.0, None, None)
        assert (int(n_acc[b]), int(nxt[b])) == (int(jn), int(jt))
    assert n_acc.tolist() == [0, 1, 2, 3, 4, 4]


def test_sampled_mode_deterministic_and_in_vocab(setup):
    s = setup
    prompts = _prompts(9, 2, 7)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return speculative_generate(s["params"], s["draft"], prompts,
                                    s["cfg"], s["dcfg"], 10, gamma=3,
                                    temperature=0.8, generator=g)[0]

    a, b = run(9), run(9)
    assert torch.equal(a, b) and a.shape == (2, 17)
    assert int(a.max()) < s["cfg"].vocab_size and int(a.min()) >= 0
    assert a[:, :7].tolist() == prompts.tolist()


@pytest.mark.parametrize("top_k,top_p", [(None, None), (6, 0.9)])
def test_sampled_preserves_target_distribution(top_k, top_p):
    """The first token decided by accept / resample (position S0 + 1)
    follows the target's own (truncated) sampling distribution:
    empirical TV distance over 4000 rows at a 16-token vocabulary
    (same-distribution TV ~0.03; a broken rule shifts mass far past
    0.1)."""
    V, B = 16, 4000
    cfg = TransformerConfig(vocab_size=V, d_model=32, n_layers=1, n_heads=2,
                            n_kv_heads=2, d_ff=64, max_seq_len=64,
                            dtype=torch.float32)
    dcfg = TransformerConfig(vocab_size=V, d_model=16, n_layers=1, n_heads=1,
                             n_kv_heads=1, d_ff=32, max_seq_len=64,
                             dtype=torch.float32)
    params = init_params(cfg, 0, device="cpu")
    draft = init_params(dcfg, 1, device="cpu")
    prompt = torch.arange(4).expand(B, 4)
    spec, _ = speculative_generate(params, draft, prompt, cfg, dcfg, 2,
                                   gamma=2, temperature=1.0,
                                   generator=torch.Generator().manual_seed(1),
                                   top_k=top_k, top_p=top_p)
    ref = generate(params, prompt, cfg, 2, temperature=1.0,
                   generator=torch.Generator().manual_seed(2), top_k=top_k,
                   top_p=top_p)
    p = [torch.bincount(t[:, 5], minlength=V).float() / B for t in (spec,
                                                                   ref)]
    tv = 0.5 * float((p[0] - p[1]).abs().sum())
    assert tv < 0.1, (tv, p)


def test_top_k1_sampled_equals_greedy(setup):
    s = setup
    prompts = _prompts(2, 1, 7)
    got, _ = speculative_generate(s["params"], s["draft"], prompts, s["cfg"],
                                  s["dcfg"], 10, gamma=3, temperature=0.7,
                                  generator=torch.Generator().manual_seed(3),
                                  top_k=1)
    assert got.tolist() == target_greedy(s, prompts, 10)


def test_validation(setup):
    s = setup
    args = (s["params"], s["draft"])
    prompt = _prompts(2, 1, 7)
    with pytest.raises(ValueError, match="at least one stream"):
        speculative_generate(*args, np.zeros((0, 4), np.int64), s["cfg"],
                             s["dcfg"], 4)
    with pytest.raises(ValueError, match="gamma"):
        speculative_generate(*args, prompt, s["cfg"], s["dcfg"], 4, gamma=0)
    with pytest.raises(ValueError, match="torch.Generator"):
        speculative_generate(*args, prompt, s["cfg"], s["dcfg"], 4,
                             temperature=0.5)
    with pytest.raises(ValueError, match="top_k"):
        speculative_generate(*args, prompt, s["cfg"], s["dcfg"], 4,
                             temperature=1.0, generator=torch.Generator(),
                             top_k=0)
    with pytest.raises(ValueError, match="max_len"):
        speculative_generate(*args, prompt, s["cfg"], s["dcfg"], 4,
                             max_len=12)
    bad = TransformerConfig(vocab_size=99, dtype=torch.float32, **DRAFT)
    with pytest.raises(ValueError, match="vocabulary"):
        speculative_generate(s["params"], init_params(bad, 3, device="cpu"),
                             prompt, s["cfg"], bad, 4)


def test_speculative_step_reads_the_host_once(setup, monkeypatch):
    """A speculative round of the server reads one tensor on the host
    (the round's candidates and accept counts, read together): the
    accept rule and the cache pointers stay on the device."""
    s = setup
    srv = DecodeServer(s["params"], s["cfg"], max_batch=2, max_len=64,
                       pad_to=4, draft_params=s["draft"], draft_cfg=s["dcfg"],
                       gamma=3)
    srv.submit([5, 9, 2], 20)
    srv.submit([7, 1], 20)
    reads = []

    def counted(name, orig):
        return lambda *a, **k: reads.append(name) or orig(*a, **k)

    for name in ("item", "tolist", "numpy", "__int__", "__index__",
                 "__bool__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name,
                            counted(name, getattr(torch.Tensor, name)))
    srv.step()
    srv.spec_step_many(2)
    monkeypatch.undo()
    assert reads == ["tolist", "tolist"]


@pytest.mark.parametrize("gamma,B", [(3, 1), (2, 3)])
def test_moe_target_with_moe_draft_matches_jax(gamma, B):
    """A ``tiny_moe_config`` target with a one-layer MoE draft: tokens
    and acceptance equal JAX's; every round masks the finished rows out
    of expert dispatch (``row_mask``).  At this size no expert overflows
    its capacity, so the tokens are also the target's greedy decode."""
    from nbdistributed_tpu.models import moe as jmoe
    jcfg = jmoe.tiny_moe_config(dtype=jnp.float32, use_flash=False)
    jdcfg = jmoe.tiny_moe_config(dtype=jnp.float32, use_flash=False,
                                 n_layers=1)
    cfg = tiny_moe_config(dtype=torch.float32)
    dcfg = tiny_moe_config(dtype=torch.float32, n_layers=1)
    trees = [jax.tree.map(np.asarray, jmoe.init_moe_model(
        jax.random.PRNGKey(seed), c)) for seed, c in ((0, jcfg), (1, jdcfg))]
    prompts = _prompts(7 + B, B, 6)
    params, draft = (params_from_jax(t, c, device="cpu")
                     for t, c in zip(trees, (cfg, dcfg)))
    got, acc = speculative_generate(params, draft, prompts, cfg, dcfg, 10,
                                    gamma=gamma)
    want, jacc = jspec.speculative_generate(
        *(jax.tree.map(jnp.asarray, t) for t in trees),
        jnp.asarray(prompts, jnp.int32), jcfg, jdcfg, 10, gamma=gamma)
    assert got.tolist() == np.asarray(want).tolist()
    assert acc == pytest.approx(float(jacc), abs=1e-6)
    assert got.tolist() == generate(params, prompts, cfg, 10).tolist()
