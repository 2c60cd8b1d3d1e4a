"""The plain references against the port at small sizes on the CPU, in
float32: the same weights and inputs give the same losses, gradients,
updates and logits."""

import time

import pytest
import torch

from conftest import small_serve_cell, small_train_cell
from perfkit import traffic, weights
from perfkit.context import Context
from perfkit.drivers import serve, train
from reference.common import Precision
from reference.served import served_logits


def _ctx(cell, seed=3):
    return Context(cell=cell, seed=seed, seconds=1.0, trace=False,
                   device=torch.device("cpu"), t_process=time.perf_counter())


def test_training_reference_follows_the_port_step_for_step():
    cell, cfg = small_train_cell()
    ctx = _ctx(cell)
    st = train.prepare(ctx, cfg)
    prog = st["readings"]
    ref = train.reference(ctx, st["sizes"], against=[prog])
    assert prog["losses"] == pytest.approx(ref["losses"], rel=1e-6)
    for k, v in ref["grad_err"][0].items():
        assert v <= 1e-5 * max(ref["grad_norms"][k], 1e-3), k
    for k, v in ref["grad_norms"].items():
        assert prog["grad_norms"][k] == pytest.approx(v, rel=1e-5), k
    for k, v in ref["change_norms"].items():
        assert prog["change_norms"][k] == pytest.approx(v, rel=1e-5), k


def _prompts(vocab, n=3):
    mix = small_serve_cell()[0].mix
    return [traffic.request(mix, 11, i, vocab)["prompt"] for i in range(n)]


@pytest.mark.parametrize("family", ["moe", "dense"])
def test_served_logits_equal_the_port_forward(family):
    if family == "moe":
        _, cfg = small_serve_cell()
        from nbdistributed_tpu_torch.models.moe import moe_forward

        def fwd(p, t):
            return moe_forward(p, t, cfg)[0]
    else:
        from nbdistributed_tpu_torch.models.transformer import (forward,
                                                                tiny_config)
        cfg = tiny_config(dtype=torch.float32, sliding_window=9,
                          max_seq_len=128)

        def fwd(p, t):
            return forward(p, t, cfg)
    sizes = weights.sizes_of(cfg)
    w = weights.make(sizes, 5, torch.device("cpu"))
    seqs = [(p[:-4], p[-4:]) for p in _prompts(sizes["vocab_size"])]
    got = served_logits(w, sizes, seqs, Precision("fp32"), "cpu")
    for (p, s), lg in zip(seqs, got):
        want = fwd(w, torch.tensor([p + s[:-1]]))[0, len(p) - 1:]
        torch.testing.assert_close(lg, want.float(), rtol=1e-4, atol=1e-4)


def test_the_serving_gap_reads_zero_for_the_reference_own_tokens():
    _, cfg = small_serve_cell()
    sizes = weights.sizes_of(cfg)
    w = weights.make(sizes, 5, torch.device("cpu"))
    prompts = _prompts(sizes["vocab_size"], 2)
    first = served_logits(w, sizes, [(p, [0]) for p in prompts],
                          Precision("fp32"), "cpu")
    seqs = [(p, [int(lg[0].argmax())]) for p, lg in zip(prompts, first)]
    got = served_logits(w, sizes, seqs, Precision("fp32"), "cpu")
    assert max(serve.gaps(got, seqs)) == 0.0


def test_fp8_products_differ_and_keep_their_gradients_shape():
    a = torch.randn(5, 16, requires_grad=True)
    b = torch.randn(16, 3, requires_grad=True)
    y = Precision("fp8").mm(a, b)
    assert not torch.allclose(y, a @ b, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(y, a @ b, rtol=0.2, atol=0.5)
    y.sum().backward()
    assert a.grad.shape == a.shape and b.grad.shape == b.shape
