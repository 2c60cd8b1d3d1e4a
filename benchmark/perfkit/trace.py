"""Spans, the profiled sub-window and the reading of its trace.

The traced run (``--trace 1``) puts a ``torch.profiler.record_function``
span around calls into the port by replacing a module attribute with a
wrapper (``benchmark/spans/<span>.json`` names the module and the
attribute; no file of the port is edited).  While the sub-window is
profiled, each wrapped call also keeps a digest of its arguments:
shapes of tensors, small integer tensors themselves (positions, segment
ids), and plain values -- what the count functions need.

A kernel belongs to a span when the host call that launched it (the
CUDA runtime event sharing its correlation id) lies inside the span on
the same host thread.  So a span's device time is the time of the work
its call enqueued, whatever implements it.  Device busy time is the
union of the device intervals, not their sum.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
import json
import os
import tempfile
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "bench.window"


class Recorder:
    """Span wrappers and the argument digests of the calls they saw."""

    def __init__(self):
        self.calls: dict[str, list] = defaultdict(list)
        self.recording = False
        self._undo = []

    def install(self, entries: list[dict]) -> None:
        for e in entries:
            mod = importlib.import_module(e["module"])
            owner, attr = mod, e["attr"]
            *parents, attr = attr.split(".")
            for p in parents:
                owner = getattr(owner, p)
            orig = getattr(owner, attr)
            setattr(owner, attr, self._wrap(e["name"], orig))
            self._undo.append((owner, attr, orig))

    def install_method(self, obj, attr: str, name: str) -> None:
        """A span around one object's method (an instance attribute)."""
        setattr(obj, attr, self._wrap(name, getattr(obj, attr)))

    def uninstall(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()

    def _wrap(self, name: str, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if self.recording:
                self.calls[name].append(
                    ([_digest(a) for a in args],
                     {k: _digest(v) for k, v in kwargs.items()}))
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return wrapped


def _digest(x):
    if torch.is_tensor(x):
        if (not x.is_floating_point() and not x.is_complex()
                and x.numel() <= 1 << 16):
            return x.detach().clone()
        return ("tensor", tuple(x.shape), str(x.dtype))
    if isinstance(x, (int, float, bool, str, type(None))):
        return x
    return ("object", type(x).__name__)


def host(x):
    """A recorded digest with its tensors read to the host (call after
    the window)."""
    if torch.is_tensor(x):
        return x.cpu().tolist()
    if isinstance(x, (list, tuple)):
        return [host(a) for a in x]
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    return x


@contextlib.contextmanager
def profiled(recorder: Recorder | None, out: dict, device):
    """Profile the body; on exit ``out["analysis"]`` is its
    :class:`TraceAnalysis`.  The body's device work is synchronised
    before the window's span closes."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = device.type == "cuda"
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    if recorder is not None:
        recorder.recording = True
    try:
        with torch.profiler.record_function(WINDOW_SPAN):
            yield
            if cuda:
                torch.cuda.synchronize(device)
    finally:
        if recorder is not None:
            recorder.recording = False
        prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        out["analysis"] = TraceAnalysis.from_file(path)
    finally:
        os.unlink(path)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class TraceAnalysis:
    """What the metrics read from one chrome trace (times in seconds)."""

    def __init__(self, events: list[dict], window: str = WINDOW_SPAN):
        xs = [e for e in events if e.get("ph") == "X"]
        wins = [e for e in xs if e.get("name") == window]
        if not wins:
            raise ValueError(f"the trace has no {window!r} span")
        w = max(wins, key=lambda e: e["dur"])
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.device = []           # (start, end, name, correlation)
        for e in xs:
            if e.get("cat") in DEVICE_CATS:
                a = max(float(e["ts"]), self.t0)
                b = min(float(e["ts"]) + float(e.get("dur", 0)), self.t1)
                if b > a:
                    self.device.append((a, b, e.get("name", "?"),
                                        e.get("args", {}).get("correlation")))
        self.launch = {}           # correlation -> (tid, ts)
        for e in events:
            if e.get("cat") in ("cuda_runtime", "cuda_driver"):
                c = e.get("args", {}).get("correlation")
                if c is not None:
                    self.launch[c] = (e.get("tid"), float(e["ts"]))
        self.spans = defaultdict(list)   # (name, tid) -> [(ts, end)]
        self.host_ops = []               # (start, end, name, tid)
        for e in xs:
            cat = e.get("cat")
            if cat in ("user_annotation", "cpu_op"):
                iv = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                if cat == "user_annotation":
                    self.spans[(e["name"], e.get("tid"))].append(iv)
                elif cat == "cpu_op":
                    self.host_ops.append((iv[0], iv[1], e["name"],
                                          e.get("tid")))
        for v in self.spans.values():
            v.sort()
        self.busy = _merge([(a, b) for a, b, _, _ in self.device])

    @classmethod
    def from_file(cls, path: str) -> "TraceAnalysis":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) * 1e-6

    @property
    def device_s(self) -> float:
        """Summed device time (overlapping work counted once each)."""
        return sum(b - a for a, b, _, _ in self.device) * 1e-6

    def span_count(self, name: str) -> int:
        return sum(len(v) for (n, _), v in self.spans.items() if n == name)

    def span_device_s(self, name: str) -> float:
        """Device time of the work launched inside span ``name``."""
        by_tid = {tid: v for (n, tid), v in self.spans.items() if n == name}
        total = 0.0
        for a, b, _, corr in self.device:
            tid_ts = self.launch.get(corr)
            if tid_ts is None or tid_ts[0] not in by_tid:
                continue
            ivs = by_tid[tid_ts[0]]
            i = bisect.bisect_right(ivs, (tid_ts[1], float("inf"))) - 1
            # Spans of one name may nest (a recompute inside a span):
            # any enclosing interval counts once.
            while i >= 0:
                if ivs[i][0] <= tid_ts[1] <= ivs[i][1]:
                    total += b - a
                    break
                i -= 1
        return total * 1e-6

    def top_device_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for a, b, name, _ in self.device:
            by[name[:120]] += (b - a) * 1e-6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest stretches with nothing on the device, each named by
        what the host was doing: the innermost host op (with the
        innermost span around it) that launched the work ending the
        gap."""
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i + 1])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:n]
        starts = {}
        for a, _, _, corr in self.device:
            starts.setdefault(a, corr)
        return [[self._label(starts.get(end)), length * 1e-6]
                for length, end in gaps]

    def _label(self, corr) -> str:
        launch = self.launch.get(corr)
        if launch is None:
            return "(end of window)"
        tid, ts = launch
        ops = [(b - a, name) for a, b, name, t in self.host_ops
               if t == tid and a <= ts <= b]
        spans = [(b - a, name) for (name, t), ivs in self.spans.items()
                 if t == tid and name != WINDOW_SPAN
                 for a, b in ivs if a <= ts <= b]
        label = min(ops)[1] if ops else "(python)"
        if spans:
            label = f"{min(spans)[1]}/{label}"
        return label[:120]
