"""The program's spans (``observability.spans.maybe_span``) inside the
serving, MoE, attention and training paths: absent and free with the
tracer and the profiler off, ``torch.profiler`` ranges while a profiler
records, tracer spans while ``%dist_trace`` is on."""

import json
import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nbdistributed_tpu_torch.models.moe import init_moe_model, tiny_moe_config
from nbdistributed_tpu_torch.models.serving import DecodeServer
from nbdistributed_tpu_torch.models.transformer import (AdamW, init_params,
                                                         make_train_step,
                                                         param_leaves,
                                                         tiny_config)
from nbdistributed_tpu_torch.observability import spans
from nbdistributed_tpu_torch.parallel import expert

SERVE_SPANS = ("serve/step", "serve/decode", "serve/prefill", "sync/tokens",
               "sync/first_token", "sync/moe_counts", "moe/block",
               "attn/cached", "attn/k4")
TRAIN_SPANS = ("train/forward", "train/backward", "train/optimizer",
               "attn/k1", "attn/k2k3")


def _serve_once():
    """A tiny dropless-MoE server: one submit (prefill, first token) and
    one decode step.  Returns the host reads the expert layer made."""
    cfg = tiny_moe_config(dtype=torch.float32, moe_dispatch="dropless")
    srv = DecodeServer(init_moe_model(cfg, 0, device="cpu"), cfg,
                       max_batch=2, max_len=64, temperature=0.0)
    reads = expert._dropless_ffn.host_reads
    srv.submit([1, 2, 3, 4, 5], 4)
    srv.step()
    return expert._dropless_ffn.host_reads - reads


def _train_step():
    """A built tiny train step (remat, flash attention's plain path) and
    its batch; its first step already taken."""
    cfg = tiny_config(remat=True, dtype=torch.float32)
    params = init_params(cfg, 0, device="cpu")
    step = make_train_step(cfg, AdamW(param_leaves(params), lr=1e-3))
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 32),
                                     generator=gen)}
    step(params, batch)
    return lambda: step(params, batch)


def _profiled(fn, path):
    """``fn()`` under a CPU ``torch.profiler``; returns (its result, the
    trace's user annotations)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return out, [e for e in events if e.get("cat") == "user_annotation"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    reads, ann = _profiled(_serve_once,
                           tmp_path_factory.mktemp("serve") / "t.json")
    return reads, ann


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    step = _train_step()
    _, ann = _profiled(step, tmp_path_factory.mktemp("train") / "t.json")
    return ann


def _named(ann, name):
    return [e for e in ann if e["name"] == name]


def _inside(child, parents) -> bool:
    a, b = child["ts"], child["ts"] + child["dur"]
    return any(p["tid"] == child["tid"] and p["ts"] <= a
               and b <= p["ts"] + p["dur"] for p in parents)


def test_off_returns_the_shared_null_context():
    assert not spans.tracer().enabled
    ctx = spans.maybe_span("serve/step")
    assert ctx is spans._NULL_CTX
    with ctx as got:
        assert got is None


def test_spans_import_without_torch_and_load_nothing_when_off():
    code = ("import sys; sys.modules['torch'] = None\n"
            "from nbdistributed_tpu_torch.observability import spans\n"
            "before = set(sys.modules)\n"
            "assert spans.maybe_span('x') is spans._NULL_CTX\n"
            "assert set(sys.modules) == before\n"
            "assert sys.modules['torch'] is None\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_profiler_alone_opens_a_range_and_no_tracer_span(tmp_path):
    assert not spans.tracer().enabled

    def body():
        with spans.maybe_span("probe/range") as got:
            torch.ones(4).add_(1)
        return got
    got, ann = _profiled(body, tmp_path / "t.json")
    assert got is None
    assert len(_named(ann, "probe/range")) == 1
    assert "probe/range" not in {s["name"]
                                 for s in spans.tracer().dump()["spans"]}


@pytest.mark.parametrize("name", SERVE_SPANS)
def test_serving_emits_each_span_under_the_profiler(served, name):
    _, ann = served
    assert _named(ann, name), sorted({e["name"] for e in ann})


@pytest.mark.parametrize("child,parent", [
    ("serve/decode", "serve/step"),
    ("sync/tokens", "serve/decode"),
    ("moe/block", "serve/decode"),
    ("attn/k4", "serve/decode"),
    ("attn/cached", "serve/prefill"),
    ("moe/block", "serve/prefill"),
    ("sync/first_token", "serve/prefill"),
    ("sync/moe_counts", "moe/block"),
])
def test_serving_spans_nest_as_the_program_calls(served, child, parent):
    _, ann = served
    kids, parents = _named(ann, child), _named(ann, parent)
    assert any(_inside(k, parents) for k in kids), (child, parent)


def test_every_step_decode_read_is_inside_the_step(served):
    _, ann = served
    steps = _named(ann, "serve/step")
    assert len(steps) == 1
    assert all(_inside(e, steps) for e in _named(ann, "serve/decode")
               + _named(ann, "sync/tokens"))


def test_moe_count_reads_match_the_program_counter(served):
    reads, ann = served
    assert reads > 0
    assert len(_named(ann, "sync/moe_counts")) == reads


@pytest.mark.parametrize("name", TRAIN_SPANS)
def test_a_train_step_emits_each_span_under_the_profiler(trained, name):
    assert _named(trained, name), sorted({e["name"] for e in trained})


def test_train_spans_run_in_order_and_hold_the_kernels(trained):
    fwd, bwd, opt = (_named(trained, f"train/{p}")
                     for p in ("forward", "backward", "optimizer"))
    assert len(fwd) == len(bwd) == len(opt) == 1
    assert fwd[0]["ts"] + fwd[0]["dur"] <= bwd[0]["ts"]
    assert bwd[0]["ts"] + bwd[0]["dur"] <= opt[0]["ts"]
    # The forward's K1 lies in train/forward; the backward (K2/K3, and
    # remat's recompute of K1) runs inside train/backward's interval.
    assert any(_inside(e, fwd) for e in _named(trained, "attn/k1"))
    for e in _named(trained, "attn/k2k3"):
        assert bwd[0]["ts"] <= e["ts"] <= bwd[0]["ts"] + bwd[0]["dur"]


@pytest.fixture
def tracing():
    tr = spans.tracer()
    tr.start()
    try:
        yield tr
    finally:
        tr.stop()
        tr.clear()


@pytest.mark.parametrize("path,names", [("serve", SERVE_SPANS),
                                        ("train", TRAIN_SPANS)])
def test_the_tracer_records_the_same_spans(tracing, path, names):
    if path == "serve":
        _serve_once()
    else:
        _train_step()()
    got = {s["name"] for s in tracing.dump()["spans"]}
    assert set(names) <= got, sorted(got)


def test_tracer_and_profiler_together_record_in_both(tracing, tmp_path):
    _, ann = _profiled(_serve_once, tmp_path / "t.json")
    dumped = [s for s in tracing.dump()["spans"]
              if s["name"] == "serve/step"]
    assert len(dumped) == len(_named(ann, "serve/step")) == 1
    decode = [s for s in tracing.dump()["spans"]
              if s["name"] == "serve/decode"]
    assert decode[0]["parent_id"] == dumped[0]["span_id"]
