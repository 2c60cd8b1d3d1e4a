"""Coordinator-side memory of pre-dispatch analysis: lint findings
and effect footprints (a copy of
``nbdistributed_tpu/analysis/preflight.py``).

**Lint findings**: when the magic layer vets a cell and
dispatches it anyway (default mode annotates, it does not block), the
findings are remembered here, keyed by the cell's source hash — the
same ``cell_sha1`` the worker computes
(runtime/collective_guard.cell_hash) and the coordinator stamps on
each pending execute request.  If a hang verdict later lands on that
cell, the watchdog, the stuck-cell doctor, and the postmortem bundle
all cite the pre-flight finding: "the analyzer told you so" is the
difference between a mystery hang and a closed loop.

**Effect footprints**: every dispatched cell's
:class:`~.effects.EffectReport` summary is recorded by ``cell_sha1``
too, in *session order* — the substrate for the per-session **cell
dependency DAG** (:func:`deps_dag`, rendered by ``%dist_lint deps``):
an edge from cell *i* to a later cell *j* for every RAW (a name *i*
binds/mutates/deletes is free-read by *j*), WAR (*i* reads a name *j*
writes), or WAW (both write one name) hazard.  An ``opaque`` cell
(exec/star-import/globals-write/unparseable) conservatively depends
on everything before it and gates everything after it (edges named
``*``).  The async in-flight window (``messaging/pipeline.py``) is
declared against exactly this DAG: cell N+1 may stream behind cell N only when no edge
connects them.

Bounded, process-local, stdlib-only.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from threading import Lock

_MAX = 256
_MAX_CELLS = 128          # session-ordered effect entries kept
_lock = Lock()
_notes: "OrderedDict[str, dict]" = OrderedDict()
_cells: list[dict] = []   # dispatched cells, session order
_seq = 0


def summarize(findings) -> str:
    """One-line human summary of a finding list (errors first)."""
    ordered = sorted(findings,
                     key=lambda f: 0 if f.severity == "error" else 1)
    if not ordered:
        return ""
    head = ordered[0]
    out = f"[{head.rule}] at L{head.line}: {head.message}"
    if len(ordered) > 1:
        rest = len(ordered) - 1
        out += f" (+{rest} more finding{'s' if rest > 1 else ''})"
    return out


def note(cell_sha1: str, findings) -> None:
    """Remember a vetted-and-dispatched cell's findings."""
    if not findings:
        return
    entry = {
        "summary": summarize(findings),
        "rules": sorted({f.rule for f in findings}),
        "errors": sum(1 for f in findings if f.severity == "error"),
        "warnings": sum(1 for f in findings
                        if f.severity == "warning"),
        "ts": time.time(),
    }
    with _lock:
        _notes.pop(cell_sha1, None)
        _notes[cell_sha1] = entry
        while len(_notes) > _MAX:
            _notes.popitem(last=False)


def lookup(cell_sha1: str | None) -> dict | None:
    if not cell_sha1:
        return None
    with _lock:
        entry = _notes.get(cell_sha1)
        return dict(entry) if entry is not None else None


def clear() -> None:
    global _seq
    with _lock:
        _notes.clear()
        del _cells[:]
        _seq = 0


# ----------------------------------------------------------------------
# effect footprints + the session dependency DAG


def note_effects(cell_sha1: str, report) -> None:
    """Record one dispatched cell's effect footprint, in session
    order.  ``report`` is an :class:`~.effects.EffectReport` (or
    anything with a compatible ``as_dict``)."""
    global _seq
    if not cell_sha1:
        return
    try:
        summary = report.as_dict()
    except Exception:
        return
    with _lock:
        entry = {"seq": _seq, "sha": cell_sha1, "ts": time.time()}
        entry.update(summary)
        _seq += 1
        _cells.append(entry)
        while len(_cells) > _MAX_CELLS:
            _cells.pop(0)


def effects_log() -> list[dict]:
    """The session's dispatched-cell footprints, oldest first."""
    with _lock:
        return [dict(e) for e in _cells]


def effects_for(cell_sha1: str | None) -> dict | None:
    """The MOST RECENT footprint recorded for this cell hash."""
    if not cell_sha1:
        return None
    with _lock:
        for e in reversed(_cells):
            if e["sha"] == cell_sha1:
                return dict(e)
    return None


def _touched(entry: dict) -> set:
    return (set(entry.get("writes") or ())
            | set(entry.get("mutates") or ())
            | set(entry.get("deletes") or ()))


def _edge_names(earlier: dict, later: dict) -> list[str]:
    """Dependency names between two recorded cells — true (RAW,
    write→read) dependencies plus the anti/output hazards that also
    forbid reordering: WAR (earlier reads a name the later cell
    writes) and WAW (both write one name, final value is
    order-defined).  ``["*"]`` when either side is opaque
    (whole-namespace poison)."""
    if earlier.get("opaque") or later.get("opaque"):
        return ["*"]
    t_early, t_late = _touched(earlier), _touched(later)
    raw = t_early & set(later.get("reads") or ())
    war = set(earlier.get("reads") or ()) & t_late
    waw = t_early & t_late
    return sorted(raw | war | waw)


def hazard_names(earlier: dict, later: dict) -> list[str]:
    """Public form of the pairwise hazard test: the RAW/WAR/WAW names
    forbidding reorder between two footprint entries (``["*"]`` when
    either is opaque), empty when the pair may overlap freely.  This
    is the exact admission predicate of the async in-flight window
    (messaging/pipeline.py) — the same function that draws
    ``deps_dag``'s edges, so "no edge" and "admissible" can never
    drift apart."""
    return _edge_names(earlier, later)


def dag_from_entries(cells: list[dict]) -> dict:
    """The dependency DAG of an explicit entry list (each entry an
    ``EffectReport.as_dict()`` summary plus ``seq``/``sha``) — the
    pure core of :func:`deps_dag`, reusable by ``nbd-lint
    --deps-dot`` over files that never entered the session store."""
    edges = []
    for j, cj in enumerate(cells):
        for i in range(j):
            names = _edge_names(cells[i], cj)
            if names:
                edges.append({"src": cells[i]["seq"],
                              "dst": cj["seq"], "names": names})
    return {"nodes": cells, "edges": edges}


def dag_to_dot(dag: dict, labels: dict | None = None) -> str:
    """Graphviz dot of a :func:`deps_dag`-shaped DAG — the visually
    auditable form of the async-dispatch substrate:
    two cells may overlap exactly when no edge joins them.  WAR/WAW
    hazard edges are included, opaque cells drawn filled; ``labels``
    overrides the per-seq node label (``nbd-lint --deps-dot`` uses
    file names)."""
    labels = labels or {}
    out = ["digraph cell_deps {",
           "  rankdir=TB;",
           "  node [shape=box, fontsize=10];",
           '  label="per-session cell dependency DAG '
           '(RAW/WAR/WAW hazards; no edge = safe to overlap)";']
    for n in dag["nodes"]:
        seq = n["seq"]
        label = labels.get(seq)
        if label is None:
            label = f"#{seq} {str(n.get('sha') or '')[:10]}"
            verdict = n.get("collective_verdict")
            if verdict:
                label += f"\\n[{verdict}]"
        attrs = [f'label="{label}"']
        if n.get("opaque"):
            attrs.append('style=filled, fillcolor="#ffdddd"')
        out.append(f'  "c{seq}" [{", ".join(attrs)}];')
    for e in dag["edges"]:
        names = ", ".join(e["names"][:4])
        extra = len(e["names"]) - 4
        if extra > 0:
            names += f" +{extra}"
        out.append(f'  "c{e["src"]}" -> "c{e["dst"]}" '
                   f'[label="{names}", fontsize=8];')
    out.append("}")
    return "\n".join(out)


def deps_dag() -> dict:
    """The per-session cell dependency DAG: ``nodes`` in session
    order, ``edges`` as ``{"src": seq_i, "dst": seq_j, "names":
    [...]}`` for every ordered pair whose reordering could change a
    result — RAW (write→read), WAR (read→write), and WAW
    (write→write) hazards all count (opaque cells connect to
    everything, names ``["*"]``).  Cell j is safe to overlap/reorder
    with cell i exactly when no edge joins them — the declared
    contract for the async in-flight window."""
    with _lock:
        cells = [dict(e) for e in _cells]
    return dag_from_entries(cells)
