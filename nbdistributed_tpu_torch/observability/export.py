"""Merge per-process span dumps into one Chrome-trace-event JSON (a
copy of ``nbdistributed_tpu/observability/export.py``; ``%dist_trace
save`` writes it).

The output loads directly in Perfetto (ui.perfetto.dev → "Open trace
file") or ``chrome://tracing``: one *process* row per rank (``pid`` =
rank; the coordinator is ``pid`` −1, matching its sentinel rank in the
wire protocol), one *thread* track per recording thread, spans as
complete events (``ph: "X"``), and :class:`FaultPlan` decisions folded
in as instant events (``ph: "i"``) so a chaos run shows *where* the
drops and duplicates landed relative to the requests they afflicted.

Worker timestamps are corrected by the per-rank clock offset estimated
from request RTTs (:mod:`~nbdistributed_tpu_torch.observability.clock`), and
the whole merge is rebased to the earliest event so timestamps stay
small.  Span/parent ids travel in ``args`` — Perfetto surfaces them in
the detail pane, which is how a worker handler span is tied back to
the coordinator send span that caused it.
"""

from __future__ import annotations

import json
from typing import Any

COORDINATOR_PID = -1


# Tenant-tagged records (gateway pools) are rehomed onto a dedicated
# per-tenant thread track inside their process row, named
# ``tenant:<name>`` — a multi-tenant postmortem then reads as one lane
# per notebook instead of interleaved anonymous thread ids.  The base
# offset keeps tenant tids clear of real recording-thread ids.
_TENANT_TID_BASE = 1 << 20

# Served requests go one level finer: records whose attrs
# carry a ``serve_rid`` (the serving observatory's stage spans) land
# on a per-request named track ``serve:<rid>`` — a request's whole
# lifecycle reads as one lane.  The base keeps them clear of both
# thread ids and tenant tids.
_SERVE_TID_BASE = 1 << 21


def _tenant_tid(ev_attrs: dict | None,
                tenant_tids: dict[str, int] | None,
                serve_tids: dict[str, int] | None = None
                ) -> int | None:
    if not ev_attrs:
        return None
    rid = ev_attrs.get("serve_rid")
    if rid and serve_tids:
        tid = serve_tids.get(str(rid))
        if tid is not None:
            return tid
    if not tenant_tids:
        return None
    name = ev_attrs.get("tenant")
    return tenant_tids.get(name) if name else None


def _span_event(span: dict, pid: int, offset_s: float,
                base_s: float,
                tenant_tids: dict[str, int] | None = None,
                serve_tids: dict[str, int] | None = None) -> dict:
    args: dict[str, Any] = dict(span.get("attrs") or {})
    args["trace_id"] = span.get("trace_id")
    args["span_id"] = span.get("span_id")
    if span.get("parent_id"):
        args["parent_id"] = span["parent_id"]
    tid = _tenant_tid(span.get("attrs"), tenant_tids, serve_tids)
    return {
        "name": span["name"],
        "cat": span.get("kind") or "span",
        "ph": "X",
        "ts": (span["t0"] - offset_s - base_s) * 1e6,
        "dur": max(0.0, span.get("dur", 0.0)) * 1e6,
        "pid": pid,
        "tid": span.get("tid", 0) if tid is None else tid,
        "args": args,
    }


def _instant_event(ev: dict, pid: int, offset_s: float,
                   base_s: float,
                   tenant_tids: dict[str, int] | None = None,
                   serve_tids: dict[str, int] | None = None) -> dict:
    tid = _tenant_tid(ev.get("attrs"), tenant_tids, serve_tids)
    return {
        "name": ev["name"],
        "cat": ev.get("kind") or "instant",
        "ph": "i",
        "s": "t",
        "ts": (ev["t0"] - offset_s - base_s) * 1e6,
        "pid": pid,
        "tid": ev.get("tid", 0) if tid is None else tid,
        "args": dict(ev.get("attrs") or {}),
    }


def _collect_tenants(*dumps: dict | None) -> dict[str, int]:
    """Stable tenant → tid assignment across every process dump (the
    same tenant gets the same tid offset in every pid row)."""
    names: set[str] = set()
    for dump in dumps:
        for s in (dump or {}).get("spans", []):
            t = (s.get("attrs") or {}).get("tenant")
            if t:
                names.add(str(t))
        for ev in (dump or {}).get("instants", []):
            t = (ev.get("attrs") or {}).get("tenant")
            if t:
                names.add(str(t))
    return {n: _TENANT_TID_BASE + i
            for i, n in enumerate(sorted(names))}


def _collect_serve_rids(*dumps: dict | None) -> dict[str, int]:
    """Stable serve_rid → tid assignment across every process dump
    (the serving observatory's per-request stage spans)."""
    rids: set[str] = set()
    for dump in dumps:
        for s in (dump or {}).get("spans", []):
            rid = (s.get("attrs") or {}).get("serve_rid")
            if rid:
                rids.add(str(rid))
    return {r: _SERVE_TID_BASE + i
            for i, r in enumerate(sorted(rids))}


def _tenant_thread_meta(tenant_tids: dict[str, int],
                        pids: list[int],
                        serve_tids: dict[str, int] | None = None
                        ) -> list[dict]:
    out = []
    named = [(f"tenant:{n}", tid)
             for n, tid in sorted(tenant_tids.items(),
                                  key=lambda kv: kv[1])]
    named += [(f"serve:{r}", tid)
              for r, tid in sorted((serve_tids or {}).items(),
                                   key=lambda kv: kv[1])]
    for name, tid in named:
        for pid in pids:
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid,
                        "args": {"name": name}})
            out.append({"name": "thread_sort_index", "ph": "M",
                        "pid": pid, "tid": tid,
                        "args": {"sort_index": tid}})
    return out


def _fault_events(events: list[dict], pid: int, offset_s: float,
                  base_s: float) -> list[dict]:
    out = []
    for ev in events or []:
        for action in ev.get("actions", ()):
            out.append({
                "name": f"fault:{action}",
                "cat": "fault",
                "ph": "i",
                "s": "p",  # process scope: a full-height marker
                "ts": (ev["ts"] - offset_s - base_s) * 1e6,
                "pid": pid,
                "tid": 0,
                "args": {"frame_kind": ev.get("kind")},
            })
    return out


def _meta(pid: int, label: str, sort_index: int) -> list[dict]:
    return [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": label}},
        {"name": "process_sort_index", "ph": "M", "pid": pid, "tid": 0,
         "args": {"sort_index": sort_index}},
    ]


def merge_trace(coordinator: dict | None,
                ranks: dict[int, dict] | None = None,
                offsets: dict[int, float] | None = None,
                coordinator_faults: list[dict] | None = None,
                rank_faults: dict[int, list[dict]] | None = None) -> dict:
    """Build the merged Chrome trace object.

    ``coordinator`` / ``ranks[r]`` are ``Tracer.dump()`` payloads;
    ``offsets[r]`` is the estimated ``worker_clock − coordinator_clock``
    for rank ``r`` (applied as a subtraction, so every event lands on
    the coordinator's timebase); the fault lists are
    ``FaultPlan.events()``.
    """
    ranks = ranks or {}
    offsets = offsets or {}
    rank_faults = rank_faults or {}

    # Rebase to the earliest (corrected) timestamp in the merge.
    t_candidates: list[float] = []
    for dump, off in ([(coordinator, 0.0)] if coordinator else []) + [
            (ranks[r], offsets.get(r, 0.0)) for r in ranks]:
        for s in (dump or {}).get("spans", []):
            t_candidates.append(s["t0"] - off)
        for ev in (dump or {}).get("instants", []):
            t_candidates.append(ev["t0"] - off)
    for ev in coordinator_faults or []:
        t_candidates.append(ev["ts"])
    for r, evs in rank_faults.items():
        off = offsets.get(r, 0.0)
        t_candidates.extend(ev["ts"] - off for ev in evs or [])
    base_s = min(t_candidates) if t_candidates else 0.0

    # Tenant lanes (gateway pools): records whose attrs carry a
    # ``tenant`` land on a per-tenant named thread track.
    tenant_tids = _collect_tenants(coordinator,
                                   *[ranks[r] for r in ranks])
    serve_tids = _collect_serve_rids(coordinator,
                                     *[ranks[r] for r in ranks])

    events: list[dict] = []
    dropped = 0
    if coordinator:
        events += _meta(COORDINATOR_PID, "coordinator", -1)
        events += [_span_event(s, COORDINATOR_PID, 0.0, base_s,
                               tenant_tids, serve_tids)
                   for s in coordinator.get("spans", [])]
        events += [_instant_event(ev, COORDINATOR_PID, 0.0, base_s,
                                  tenant_tids, serve_tids)
                   for ev in coordinator.get("instants", [])]
        dropped += coordinator.get("dropped", 0)
    events += _fault_events(coordinator_faults or [], COORDINATOR_PID,
                            0.0, base_s)
    for r in sorted(ranks):
        off = offsets.get(r, 0.0)
        dump = ranks[r] or {}
        events += _meta(r, f"rank {r}", r)
        events += [_span_event(s, r, off, base_s, tenant_tids,
                               serve_tids)
                   for s in dump.get("spans", [])]
        events += [_instant_event(ev, r, off, base_s, tenant_tids,
                                  serve_tids)
                   for ev in dump.get("instants", [])]
        dropped += dump.get("dropped", 0)
    if tenant_tids or serve_tids:
        pids = ([COORDINATOR_PID] if coordinator else []) \
            + sorted(ranks)
        events += _tenant_thread_meta(tenant_tids, pids, serve_tids)
    for r in sorted(rank_faults):
        events += _fault_events(rank_faults[r], r,
                                offsets.get(r, 0.0), base_s)

    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "tool": "nbdistributed_tpu_torch %dist_trace",
            "base_unix_s": base_s,
            "clock_offsets_s": {str(r): offsets.get(r, 0.0)
                                for r in sorted(ranks)},
            "spans_dropped": dropped,
            "tenant_tracks": {n: t for n, t in
                              sorted(tenant_tids.items())},
            "serve_tracks": {n: t for n, t in
                             sorted(serve_tids.items())},
        },
    }


def save_trace(path: str, merged: dict) -> int:
    """Write the merged trace; returns the number of non-metadata
    events (the useful-content count surfaced by ``%dist_trace
    save``)."""
    with open(path, "w") as f:
        json.dump(merged, f)
    return sum(1 for e in merged["traceEvents"] if e.get("ph") != "M")
