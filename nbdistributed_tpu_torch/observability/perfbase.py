"""Perf-regression sentinel core (counterpart of
``nbdistributed_tpu/observability/perfbase.py``): score a loadgen report
(+ optional serving stage summary) against a checked-in baseline with
per-metric noise bands.

A baselines file pins what a load run is expected to deliver;
:func:`score` compares a fresh report against it
and names every metric that moved outside its band in the worse
direction.  The contract is deliberately simple so the gate is
auditable:

* Each watched metric has a DIRECTION (``higher``/``lower`` is
  better) and a NOISE BAND (fractional, e.g. ``0.25`` = 25%).  A
  regression is a move past the band in the worse direction;
  improvements and in-band noise pass.
* Bands live IN the baseline file — the checked-in artifact is the
  complete contract, and re-seeding (``nbd_torch_perfwatch.py --update``)
  preserves any hand-tuned band.
* The diff is machine-readable (one dict per metric: baseline,
  current, delta fraction, band, verdict) so a human can read why
  a run failed without re-running anything.

The port keeps no baselines file of its own yet, and no number taken
on another device carries over: ``tools/nbd_torch_perfwatch.py`` reads
the file that ``--baseline PATH`` (or ``NBD_PERFWATCH_BASELINE``) names;
``NBD_PERFWATCH_BAND_SCALE`` widens/narrows every band uniformly
(e.g. ``2.0`` on a noisy shared runner).

Pure host-side arithmetic on purpose: no torch, no subprocess, no
clock — ``tools/nbd_torch_perfwatch.py`` owns IO and process exit
codes, the unit tests drive these functions directly.
"""

from __future__ import annotations

import json

BASELINE_SCHEMA_VERSION = 1

# metric name -> (direction, default noise band fraction).
# Bands are sized so a real regression (the acceptance pins
# tokens/s -30% and p99 TTFT +3x) always trips while honest run-to-run
# CPU-runner noise does not.  Latency tails get wider bands than
# throughput: p99 on a small smoke is inherently jumpier.
DEFAULT_BANDS: dict[str, tuple[str, float]] = {
    "tokens_per_s": ("higher", 0.25),
    "completed": ("higher", 0.15),
    "shed_rate": ("lower", 0.10),       # absolute band (rate in [0,1])
    "ttft_ms_p99": ("lower", 1.00),
    "ttft_ms_p50": ("lower", 1.00),
    "tpot_ms_p99": ("lower", 1.00),
    "e2e_ms_p99": ("lower", 1.00),
    "stage_decode_ms_p95": ("lower", 1.50),
    "stage_queue_ms_p95": ("lower", 1.50),
}

# Metrics whose band is ABSOLUTE (same units as the metric) rather
# than a fraction of the baseline — rates near zero have no sensible
# relative band.
ABSOLUTE_BAND = frozenset({"shed_rate"})


def extract_metrics(report: dict,
                    stage_summary: dict | None = None) -> dict:
    """Flatten the watched metrics out of a pinned loadgen report
    (:mod:`~..serving_fast.loadgen`) and an optional
    :meth:`~.servingobs.ServingObservatory.summary` block.  Missing
    pieces are skipped, never invented — a baseline seeded without
    stage data simply does not gate stages."""
    out: dict[str, float] = {}
    for k in ("tokens_per_s", "completed", "shed_rate"):
        v = report.get(k)
        if v is not None:
            out[k] = float(v)
    client = report.get("client") or {}
    for src, pfx in (("ttft_ms", "ttft_ms"), ("tpot_ms", "tpot_ms"),
                     ("e2e_ms", "e2e_ms")):
        block = client.get(src) or {}
        for q in ("p50", "p99"):
            if block.get(q) is not None:
                out[f"{pfx}_{q}"] = float(block[q])
    stages = (stage_summary or {}).get("stages") or {}
    for s in ("decode", "queue"):
        st = stages.get(s) or {}
        if st.get("p95") is not None:
            out[f"stage_{s}_ms_p95"] = float(st["p95"])
    return out


def make_baseline(metrics: dict, *, source: str = "",
                  bands: dict | None = None) -> dict:
    """Build one baseline entry: watched metrics that have a known
    direction, each with its band pinned alongside the value."""
    entry: dict = {"source": source, "metrics": {}}
    for name, value in sorted(metrics.items()):
        spec = DEFAULT_BANDS.get(name)
        if spec is None:
            continue
        direction, band = spec
        if bands and name in bands:
            band = float(bands[name])
        entry["metrics"][name] = {
            "value": round(float(value), 4),
            "direction": direction,
            "band": band,
        }
    return entry


def load_baselines(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("schema") != BASELINE_SCHEMA_VERSION:
        raise ValueError(
            f"baseline schema {doc.get('schema')!r} != "
            f"{BASELINE_SCHEMA_VERSION} — re-seed with "
            f"tools/nbd_perfwatch.py --update")
    return doc


def save_baselines(path: str, doc: dict) -> None:
    doc = dict(doc, schema=BASELINE_SCHEMA_VERSION)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


def score(baseline_entry: dict, metrics: dict, *,
          band_scale: float = 1.0) -> dict:
    """Compare current ``metrics`` against one baseline entry.

    Returns ``{"pass": bool, "regressions": [names...],
    "metrics": {name: {"baseline", "current", "delta", "band",
    "direction", "verdict"}}}`` where ``delta`` is the relative move
    (absolute for :data:`ABSOLUTE_BAND` metrics) SIGNED so that
    positive always means "worse".  Metrics present in the baseline
    but missing from the run are verdict ``missing`` and FAIL — a
    report that silently stopped carrying a gated number must not
    pass the gate."""
    out: dict = {"pass": True, "regressions": [], "metrics": {}}
    base_metrics = baseline_entry.get("metrics") or {}
    for name, spec in sorted(base_metrics.items()):
        base = float(spec["value"])
        band = float(spec["band"]) * max(0.0, float(band_scale))
        direction = spec.get("direction", "lower")
        cur = metrics.get(name)
        if cur is None:
            out["metrics"][name] = {
                "baseline": base, "current": None, "delta": None,
                "band": band, "direction": direction,
                "verdict": "missing"}
            out["regressions"].append(name)
            out["pass"] = False
            continue
        cur = float(cur)
        if name in ABSOLUTE_BAND:
            delta = cur - base
        elif base != 0:
            delta = (cur - base) / abs(base)
        else:
            # Baseline of zero: any nonzero current is an infinite
            # relative move; judge it absolutely against the band.
            delta = cur
        if direction == "higher":
            delta = -delta        # positive always = worse
        if delta > band:
            verdict = "regressed"
            out["regressions"].append(name)
            out["pass"] = False
        elif delta < -band:
            verdict = "improved"
        else:
            verdict = "ok"
        out["metrics"][name] = {
            "baseline": base, "current": round(cur, 4),
            "delta": round(delta, 4), "band": band,
            "direction": direction, "verdict": verdict}
    return out


def format_diff(result: dict) -> str:
    """One line per gated metric, worst first — the human half of the
    machine-readable diff."""
    order = {"regressed": 0, "missing": 1, "improved": 2, "ok": 3}
    lines = []
    items = sorted((result.get("metrics") or {}).items(),
                   key=lambda kv: (order.get(kv[1]["verdict"], 9),
                                   kv[0]))
    for name, m in items:
        mark = {"regressed": "✗", "missing": "?", "improved": "✓",
                "ok": "·"}.get(m["verdict"], "·")
        cur = ("—" if m["current"] is None
               else f"{m['current']:g}")
        delta = ("" if m["delta"] is None
                 else f" ({m['delta'] * 100:+.1f}% worse-direction, "
                      f"band ±{m['band'] * 100:.0f}%)")
        lines.append(f" {mark} {name}: {m['baseline']:g} -> {cur}"
                     f"{delta} [{m['verdict']}]")
    verdict = "PASS" if result.get("pass") else "REGRESSION"
    lines.append(f" => {verdict}"
                 + (f": {', '.join(result['regressions'])}"
                    if result.get("regressions") else ""))
    return "\n".join(lines)
