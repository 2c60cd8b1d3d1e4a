"""The control -- the plain reference put in the program's place and
computed in fp8, the precision below the configuration's bf16 -- must
come out not correct under each cell's limits.  Here at a CPU test's
width; its readings at the cells' own size are in PERF.md."""

import time

import torch

from conftest import small_serve_cell, small_train_cell
from perfkit.context import Context, passed
from perfkit.drivers import serve, train


def _ctx(cell, seed):
    return Context(cell=cell, seed=seed, seconds=1.0, trace=False,
                   device=torch.device("cpu"), t_process=time.perf_counter())


def test_training_control_fails():
    cell, cfg = small_train_cell()
    from perfkit import weights
    sizes = weights.sizes_of(cfg)
    for seed in (1, 2, 3):
        ctx = _ctx(cell, seed)
        low = train.reference(ctx, sizes, "fp8", keep=True)
        ref = train.reference(ctx, sizes, against=[low])
        checks = train.compare(low, ref, cell.limits)
        assert not passed(checks), checks


def test_serving_control_fails():
    # The cell's depth and expert count at a small width: the control's
    # gaps grow with depth (0.03-0.04 at 2 layers, 0.17-0.23 at 16).
    # Prompts from the cell's generator, served tokens drawn from the
    # seed: the control is read at the same positions as the reference.
    from perfkit import traffic, weights
    cell, cfg = small_serve_cell(d_model=256, n_layers=16, n_heads=8,
                                 n_kv_heads=2, d_ff=512, n_experts=8,
                                 vocab_size=4096)
    sizes = weights.sizes_of(cfg)
    for seed in (1, 2, 3):
        ctx = _ctx(cell, seed)
        g = traffic.rng(seed, "check")
        seqs = [(traffic.request(cell.mix, seed, i, 4096)["prompt"],
                 g.integers(0, 4096, size=12).tolist()) for i in range(8)]
        ref = serve.reference_logits(ctx, sizes, seqs)
        low = serve.reference_logits(ctx, sizes, seqs, "fp8")
        gap = serve.mean(serve.gaps(ref, serve.top_tokens(low, seqs)))
        assert gap > cell.limits["mean_logit_gap"], gap
