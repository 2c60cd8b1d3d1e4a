"""The trace reader on a hand-made chrome trace: kernels belong to the
span whose call launched them, on the launching thread; busy time is
the union of device intervals; gaps are named by the launching op."""

import pytest

from perfkit.trace import WINDOW_SPAN, Recorder, TraceAnalysis, host


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _trace():
    return [
        _x(WINDOW_SPAN, "user_annotation", 0, 1000),
        _x("bench.a", "user_annotation", 10, 100),
        _x("aten::mm", "cpu_op", 20, 10),
        _x("cudaLaunchKernel", "cuda_runtime", 22, 2, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 60, 2, correlation=2),
        # a span of the same name on another thread (autograd's)
        _x("bench.a", "user_annotation", 300, 50, tid=2),
        _x("aten::mul", "cpu_op", 305, 20, tid=2),
        _x("cudaLaunchKernel", "cuda_runtime", 310, 2, tid=2, correlation=3),
        # launched outside any span
        _x("cudaLaunchKernel", "cuda_runtime", 500, 2, correlation=4),
        _x("k1", "kernel", 100, 200, tid=7, correlation=1),
        _x("k2", "kernel", 250, 100, tid=8, correlation=2),
        _x("k3", "kernel", 600, 100, tid=7, correlation=3),
        _x("k4", "kernel", 900, 200, tid=7, correlation=4),
    ]


def test_span_device_time_and_busy_union():
    t = TraceAnalysis(_trace())
    assert t.window_s == pytest.approx(1000e-6)
    # k1 + k2 + k3 (k3 launched by the other thread's bench.a)
    assert t.span_device_s("bench.a") == pytest.approx(400e-6)
    assert t.span_count("bench.a") == 2
    # union: [100, 350] + [600, 700] + [900, 1000 (clipped)]
    assert t.busy_s == pytest.approx(450e-6)
    assert t.device_s == pytest.approx(500e-6)
    top = t.top_device_ops(2)
    assert [n for n, _ in top] == ["k1", "k2"]


def test_idle_gaps_are_named_by_what_launched_the_next_work():
    t = TraceAnalysis(_trace())
    gaps = t.idle_gaps(10)
    assert [round(s * 1e6) for _, s in gaps] == [250, 200, 100]
    assert gaps[0][0] == "bench.a/aten::mul"
    assert gaps[1][0] == "(python)"
    assert gaps[2][0] == "bench.a/aten::mm"


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError):
        TraceAnalysis([_x("k", "kernel", 0, 1)])


def test_recorder_keeps_small_integer_tensors_and_shapes():
    import torch
    rec = Recorder()
    f = rec._wrap("s", lambda a, b, w=None: a)
    rec.recording = True
    f(torch.zeros(3, 4), torch.arange(5), w=7)
    rec.recording = False
    f(torch.zeros(1), torch.arange(2))
    (args, kw), = rec.calls["s"]
    assert host(args) == [["tensor", [3, 4], "torch.float32"],
                          [0, 1, 2, 3, 4]]
    assert kw == {"w": 7}
