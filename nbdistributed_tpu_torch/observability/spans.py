"""Lightweight span tracing with cross-process id propagation.

One :class:`Tracer` per process (module singleton, :func:`tracer`),
**disabled by default**: every instrumentation site first checks
``tracer.enabled`` — a single attribute read — so the framework pays
near-zero overhead until ``%dist_trace start`` flips it on.

A span is ``(name, kind, trace_id, span_id, parent_id, t0, dur, tid,
attrs)``.  ``trace_id`` names the tracing *session* (minted by
``Tracer.start`` on the coordinator and adopted by workers from the
wire context), ``span_id`` is unique per span, and ``parent_id`` links
children — either to the thread-local *current* span in this process,
or, for worker handler spans, to the coordinator's send span whose ids
rode the request envelope (the ``tr`` codec header;
see :mod:`nbdistributed_tpu_torch.messaging.codec`).

Timestamps are ``time.time()`` wall clock — deliberately, so the
coordinator can merge per-process dumps onto one timeline after
correcting each rank by its estimated clock offset
(:mod:`~nbdistributed_tpu_torch.observability.clock`).  ``tid`` is a small
per-process thread ordinal so overlapping spans from different threads
(e.g. the magic's send helper vs the cell wrapper) render on separate
tracks instead of producing an invalid stack.

While a ``torch.profiler`` records in the process (``%dist_profile``, a
benchmark's profiled window), :func:`maybe_span` also opens a
``torch.profiler.record_function`` range of the same name: the span
lands in the profiler's Chrome trace as a ``user_annotation``, on the
profiler's clock, beside the kernels launched inside it.  torch is
looked up in ``sys.modules`` only, so this module stays stdlib-only
where torch is never loaded (the coordinator).
"""

from __future__ import annotations

import sys
import threading
import time
import uuid
from typing import Any

# Bound on retained spans: a runaway traced loop must not grow the
# coordinator without limit.  At ~200 bytes/span this is ~10 MB.
MAX_SPANS = 50_000


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


class Span:
    __slots__ = ("name", "kind", "trace_id", "span_id", "parent_id",
                 "t0", "dur", "tid", "attrs")

    def __init__(self, name: str, kind: str, trace_id: str,
                 parent_id: str | None, tid: int,
                 attrs: dict[str, Any] | None = None):
        self.name = name
        self.kind = kind
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.t0 = time.time()
        self.dur = 0.0
        self.tid = tid
        self.attrs = attrs or {}

    def as_dict(self) -> dict:
        d = {"name": self.name, "kind": self.kind, "tid": self.tid,
             "trace_id": self.trace_id, "span_id": self.span_id,
             "t0": self.t0, "dur": self.dur}
        if self.parent_id:
            d["parent_id"] = self.parent_id
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class _NullCtx:
    """Shared no-op context manager: the disabled-tracing fast path of
    :func:`maybe_span` must not allocate."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()

# torch's profiler module, whose ``_is_profiler_enabled`` is True while a
# profiler records anywhere in the process.
_PROFILER = "torch.autograd.profiler"


class _ProfiledCtx:
    """A profiler range (``record_function``) around a tracer span, or
    around :data:`_NULL_CTX` when only the profiler is on."""

    __slots__ = ("_range", "_inner")

    def __init__(self, rng, inner):
        self._range = rng
        self._inner = inner

    def __enter__(self):
        self._range.__enter__()
        return self._inner.__enter__()

    def __exit__(self, *exc):
        try:
            return self._inner.__exit__(*exc)
        finally:
            self._range.__exit__(*exc)


class _SpanCtx:
    """Context manager returned by ``Tracer.span``: activates the span
    for the duration (children parent to it) and ends it on exit."""

    __slots__ = ("_tracer", "_span", "_prev")

    def __init__(self, tr: "Tracer", span: "Span"):
        self._tracer = tr
        self._span = span

    def __enter__(self):
        tls = self._tracer._tls
        self._prev = getattr(tls, "current", None)
        tls.current = self._span
        return self._span

    def __exit__(self, exc_type, exc, tb):
        self._tracer._tls.current = self._prev
        if exc_type is not None:
            self._span.attrs.setdefault("error", exc_type.__name__)
        self._tracer.end(self._span)
        return False


class _ActivateCtx:
    """Make an already-open span the thread-local current WITHOUT
    ending it on exit — how a span opened on one thread (the cell
    wrapper) becomes the parent for work on another (the send helper
    thread; thread-locals don't cross threads by themselves)."""

    __slots__ = ("_tracer", "_span", "_prev")

    def __init__(self, tr: "Tracer", span: "Span | None"):
        self._tracer = tr
        self._span = span

    def __enter__(self):
        tls = self._tracer._tls
        self._prev = getattr(tls, "current", None)
        if self._span is not None:
            tls.current = self._span
        return self._span

    def __exit__(self, *exc):
        self._tracer._tls.current = self._prev
        return False


class Tracer:
    """Process-local span recorder.  Thread-safe; all record paths are
    no-ops while ``enabled`` is False."""

    def __init__(self):
        self.enabled = False
        self.trace_id: str | None = None
        self._lock = threading.Lock()
        self._spans: list[Span] = []
        self._instants: list[dict] = []
        self._dropped = 0
        self._tls = threading.local()
        self._thread_ids: dict[int, int] = {}

    # ------------------------------------------------------------------
    # lifecycle

    def start(self, trace_id: str | None = None) -> str:
        """Begin a tracing session: clears prior spans, mints (or
        adopts) the session trace id, enables recording."""
        with self._lock:
            self.trace_id = trace_id or _new_id()
            self._spans = []
            self._instants = []
            self._dropped = 0
            self._thread_ids = {}
            self.enabled = True
            return self.trace_id

    def stop(self) -> int:
        """Disable recording; spans stay buffered for ``dump``."""
        self.enabled = False
        with self._lock:
            return len(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans = []
            self._instants = []
            self._dropped = 0

    # ------------------------------------------------------------------
    # recording

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._thread_ids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._thread_ids.setdefault(ident,
                                                  len(self._thread_ids))
        return tid

    def begin(self, name: str, kind: str = "", *,
              trace_id: str | None = None, parent_id: str | None = None,
              attrs: dict | None = None) -> Span | None:
        """Open a span (None when disabled).  With no explicit
        ``parent_id`` the thread-local current span is the parent; an
        explicit one (from a wire context) wins and its ``trace_id``
        should come with it."""
        if not self.enabled:
            return None
        if parent_id is None:
            cur = getattr(self._tls, "current", None)
            if cur is not None:
                parent_id = cur.span_id
                trace_id = trace_id or cur.trace_id
        return Span(name, kind, trace_id or self.trace_id or _new_id(),
                    parent_id, self._tid(), attrs)

    def end(self, span: Span | None) -> None:
        if span is None:
            return
        span.dur = time.time() - span.t0
        with self._lock:
            if len(self._spans) >= MAX_SPANS:
                self._dropped += 1
                return
            self._spans.append(span)

    def span(self, name: str, kind: str = "", *,
             trace_id: str | None = None, parent_id: str | None = None,
             attrs: dict | None = None):
        """``with tracer.span("x") as s:`` — begin + activate + end.
        Returns a no-op context when disabled."""
        sp = self.begin(name, kind, trace_id=trace_id,
                        parent_id=parent_id, attrs=attrs)
        if sp is None:
            return _NULL_CTX
        return _SpanCtx(self, sp)

    def activate(self, span: Span | None):
        """Adopt ``span`` as this thread's current (no end on exit)."""
        if span is None:
            return _NULL_CTX
        return _ActivateCtx(self, span)

    def add_span(self, name: str, kind: str, t0: float, dur: float, *,
                 trace_id: str | None = None,
                 parent_id: str | None = None,
                 attrs: dict | None = None) -> None:
        """Append an already-timed span (explicit ``t0``/``dur``).
        The latency observatory computes its stage decomposition only
        AFTER a request completes, so its ``stage/*`` child spans
        cannot be opened live — they are reconstructed here under the
        request's send span."""
        if not self.enabled:
            return
        sp = Span(name, kind, trace_id or self.trace_id or _new_id(),
                  parent_id, self._tid(), attrs)
        sp.t0 = t0
        sp.dur = max(0.0, dur)
        with self._lock:
            if len(self._spans) >= MAX_SPANS:
                self._dropped += 1
                return
            self._spans.append(sp)

    def instant(self, name: str, kind: str = "",
                attrs: dict | None = None) -> None:
        """Record a zero-duration event (Chrome ``ph: "i"``)."""
        if not self.enabled:
            return
        ev = {"name": name, "kind": kind, "t0": time.time(),
              "tid": self._tid()}
        if attrs:
            ev["attrs"] = attrs
        with self._lock:
            if len(self._instants) < MAX_SPANS:
                self._instants.append(ev)

    # ------------------------------------------------------------------
    # propagation / export

    def context(self) -> dict | None:
        """Wire context for the current span — the value of the codec's
        ``tr`` header — or None when disabled (no header emitted, the
        acceptance bar for zero-overhead-off)."""
        if not self.enabled:
            return None
        cur = getattr(self._tls, "current", None)
        if cur is not None:
            return {"tid": cur.trace_id, "sid": cur.span_id}
        return {"tid": self.trace_id or _new_id()}

    def context_for(self, span: Span | None) -> dict | None:
        if span is None:
            return None
        return {"tid": span.trace_id, "sid": span.span_id}

    def dump(self) -> dict:
        """JSON-able session dump: spans + instants (+ drop count)."""
        with self._lock:
            return {"trace_id": self.trace_id,
                    "spans": [s.as_dict() for s in self._spans],
                    "instants": list(self._instants),
                    "dropped": self._dropped}

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


_TRACER = Tracer()


def tracer() -> Tracer:
    """The process-global tracer (coordinator and each worker process
    own exactly one)."""
    return _TRACER


def maybe_span(name: str, kind: str = "", attrs: dict | None = None):
    """Module-level ``with maybe_span("collective/all_reduce"):`` for
    instrumentation sites: a tracer span while ``%dist_trace`` is on,
    and a profiler range of the same name while a ``torch.profiler``
    records.  With both off it is two flag reads and returns the shared
    :data:`_NULL_CTX`, allocating nothing."""
    t = _TRACER
    prof = sys.modules.get(_PROFILER)
    if prof is not None and getattr(prof, "_is_profiler_enabled", False):
        inner = t.span(name, kind, attrs=attrs) if t.enabled else _NULL_CTX
        return _ProfiledCtx(prof.record_function(name), inner)
    if not t.enabled:
        return _NULL_CTX
    return t.span(name, kind, attrs=attrs)
