"""Shared set-up of the benchmark's own tests: the benchmark directory
and the checkout on ``sys.path``, the small cells the CPU tests drive,
and the ``card`` marker, whose skip is decided inside a fixture."""

import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

KIND = "NVIDIA H100 80GB HBM3"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda", 0)


def small_train_cell():
    """The training cell with its mix cut to a CPU test's size."""
    import torch
    from nbdistributed_tpu_torch.models.transformer import tiny_config
    from perfkit import spec
    cell = spec.load_cell("mistral-7b.train.s8192")
    cell.mix = dict(cell.mix, seq_len=64,
                    documents={"median": 16, "sigma": 1.0, "min": 4,
                               "max": 64})
    cfg = tiny_config(remat=True, ce_chunk=100, dtype=torch.float32,
                      sliding_window=24, max_seq_len=128)
    return cell, cfg


def small_serve_cell(**cfg_kw):
    """The serving cell with its mix and server cut to a CPU test's
    size (``cfg_kw`` changes the tiny model)."""
    import torch
    from nbdistributed_tpu_torch.models.moe import tiny_moe_config
    from perfkit import spec
    cell = spec.load_cell("mixtral-8x7b-l16.serve.docqa")
    cell.mix = dict(cell.mix, clients=4,
                    server={"max_batch": 4, "max_len": 96},
                    prompt={"median": 24, "sigma": 0.5, "min": 8, "max": 48},
                    output={"median": 6, "sigma": 0.7, "min": 2, "max": 16},
                    warmup_steps=4, trace_steps=3, check_requests=4,
                    stall_steps=4)
    cfg = tiny_moe_config(**{**dict(dtype=torch.float32,
                                     moe_dispatch="dropless",
                                     max_seq_len=128), **cfg_kw})
    return cell, cfg


def run_small(cell, cfg, seed=7, seconds=1.0, trace=False):
    import torch
    from perfkit import runner
    return runner.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                           time.perf_counter(), cfg=cfg, kind=KIND)
