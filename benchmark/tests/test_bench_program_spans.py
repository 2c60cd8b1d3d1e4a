"""The readers of the metrics built on the program's own spans, on a
hand-made chrome trace with known spans, launches and kernels."""

import pytest

from perfkit import spec
from perfkit.trace import WINDOW_SPAN, TraceAnalysis

SELECT = "autograd::engine::evaluate_function: SelectBackward0"
ACCUMULATE = ("autograd::engine::evaluate_function: "
              "torch::autograd::AccumulateGrad")
NEW = ("decode_read_ms.serve", "decode_host_ms.serve",
       "cached_attn_share.serve", "stack_grad_ms.train")


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _span(name, ts, dur, tid=1):
    return _x(name, "user_annotation", ts, dur, tid)


def _launch(ts, corr, tid=1):
    return _x("cudaLaunchKernel", "cuda_runtime", ts, 2, tid,
              correlation=corr)


def _kernel(name, ts, dur, corr):
    return _x(name, "kernel", ts, dur, 7, correlation=corr)


def _serve_trace():
    """Three decode steps on thread 1: 800 us with reads of 50 + 60 + 90,
    500 us with one of 80 (and another thread's read inside its time,
    not its own), 300 us with none; a read outside every step; one
    prefill whose cached attention launched 300 us of the 500 us of
    device time."""
    return [
        _span(WINDOW_SPAN, 0, 10000),
        _span("serve/step", 100, 1000),
        _span("serve/decode", 200, 800),
        _span("sync/moe_counts", 300, 50),
        _span("sync/moe_counts", 500, 60),
        _span("sync/tokens", 900, 90),
        _span("sync/first_token", 1500, 100),
        _span("serve/decode", 2000, 500),
        _span("sync/moe_counts", 2100, 100, tid=2),
        _span("sync/tokens", 2400, 80),
        _span("serve/decode", 3000, 300),
        _span("attn/cached", 4000, 100),
        _launch(4050, 10),
        _launch(4150, 11),
        _kernel("sgemm", 4200, 300, 10),
        _kernel("softmax", 4500, 200, 11),
    ]


def _train_trace():
    """``train/backward`` on the main thread (1); autograd's ops on its
    own thread (3): the select backward launches a fill (200 us) and an
    add (300 us), the accumulation into ``.grad`` 50 us, a matmul's
    backward 250 us, and a select backward after the span 100 us."""
    return [
        _span(WINDOW_SPAN, 0, 10000),
        _span("train/forward", 1000, 4000),
        _span("train/backward", 5000, 3000),
        _x(SELECT, "cpu_op", 5100, 200, tid=3),
        _x("aten::zeros", "cpu_op", 5110, 40, tid=3),
        _launch(5120, 20, tid=3),
        _x("aten::add_", "cpu_op", 5240, 20, tid=3),
        _launch(5250, 21, tid=3),
        _x(ACCUMULATE, "cpu_op", 5400, 100, tid=3),
        _launch(5450, 22, tid=3),
        _x("autograd::engine::evaluate_function: MmBackward0", "cpu_op",
           5600, 200, tid=3),
        _launch(5650, 23, tid=3),
        _x(SELECT, "cpu_op", 8500, 100, tid=3),
        _launch(8550, 24, tid=3),
        _kernel("fill", 5200, 200, 20),
        _kernel("add", 5400, 300, 21),
        _kernel("add", 5700, 50, 22),
        _kernel("gemm", 5750, 250, 23),
        _kernel("fill", 8600, 100, 24),
    ]


def _run(events, batches=2):
    return {"record": {"profiled_batches": list(range(batches))},
            "trace": TraceAnalysis(events), "calls": {}, "peak": {}}


def _read(name, run):
    return spec.metric_reader(name).read(run)


def test_decode_steps_split_into_reads_and_host_time():
    tr = TraceAnalysis(_serve_trace())
    steps = spec.metric_reader("decode_read_ms.serve").per_step(tr)
    assert steps == pytest.approx([(0.8, 0.2), (0.5, 0.08), (0.3, 0.0)])
    run = _run(_serve_trace())
    assert _read("decode_read_ms.serve", run) == pytest.approx(0.08)
    assert _read("decode_host_ms.serve", run) == pytest.approx(0.42)


@pytest.mark.parametrize("step", range(3))
def test_read_and_host_time_add_up_to_the_step(step):
    tr = TraceAnalysis(_serve_trace())
    dur, read = spec.metric_reader("decode_read_ms.serve").per_step(tr)[step]
    one = [e for e in _serve_trace() if e["name"] != "serve/decode"
           or e["ts"] == (200, 2000, 3000)[step]]
    host = _read("decode_host_ms.serve", _run(one))
    assert _read("decode_read_ms.serve", _run(one)) + host == \
        pytest.approx(dur)
    assert host == pytest.approx(dur - read)


def test_overlapping_reads_count_once():
    ev = _serve_trace() + [_span("sync/tokens", 920, 40)]
    steps = spec.metric_reader("decode_read_ms.serve").per_step(
        TraceAnalysis(ev))
    assert steps[0] == pytest.approx((0.8, 0.2))


def test_cached_attention_share_of_device_time():
    assert _read("cached_attn_share.serve", _run(_serve_trace())) == \
        pytest.approx(100.0 * 300 / 500)


def test_stack_grad_counts_select_and_accumulate_inside_backward():
    # fill 200 + add 300 + accumulate 50 over 2 batches; the matmul's
    # backward and the select backward after the span are left out.
    assert _read("stack_grad_ms.train", _run(_train_trace())) == \
        pytest.approx(0.275)


def test_stack_grad_leaves_out_a_select_launched_outside_backward():
    ev = [e for e in _train_trace() if e["name"] != "train/backward"]
    ev.append(_span("train/backward", 8000, 1000))
    assert _read("stack_grad_ms.train", _run(ev)) == pytest.approx(0.05)


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_spans_reads_nothing(name):
    bare = [_span(WINDOW_SPAN, 0, 1000), _launch(10, 1),
            _kernel("k", 20, 100, 1)]
    assert _read(name, _run(bare)) is None
    assert _read(name, {"record": {"profiled_batches": []}, "trace": None,
                        "calls": {}, "peak": {}}) is None
