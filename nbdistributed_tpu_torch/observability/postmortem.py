"""Crash postmortems: assemble the black boxes into one bundle (a
copy of ``nbdistributed_tpu/observability/postmortem.py``).

When a worker dies (``WorkerDied``, a supervisor restart, or on
demand via ``%dist_postmortem``), this module gathers everything the
run left behind and writes a **postmortem bundle** directory:

- ``manifest.json`` — what happened, when, which ranks died, what the
  bundle contains;
- ``flight_rank{r}.json`` / ``flight_coordinator.json`` — each
  process's flight ring, *recovered from the file* (so a SIGKILLed
  rank's last events — including the dispatch record of the message it
  died on — are present), with the torn-tail flag;
- ``telemetry.json`` — the last heartbeat-piggybacked telemetry
  snapshots per rank (the dead rank's final device-memory numbers:
  the CUDA caching allocator's, from ``telemetry.py``);
- ``trace.json`` — one Chrome-trace JSON merged through the existing
  clock-aligned export path: coordinator spans (when a ``%dist_trace``
  session was active), every recovered flight ring as instant events
  (``pid`` = rank, coordinator −1), and fault-plan decisions — loads
  directly in ui.perfetto.dev;
- ``report.txt`` — the human-readable story.

Bundles land under ``<run_dir>/postmortem-NNN/``; the newest one is
what ``%dist_postmortem --last`` shows.  Assembly is deliberately
read-only with respect to the cluster: it talks to no worker (they may
be dead) and never raises into its caller (the supervisor's heal path
must proceed even if the postmortem disk is full).
"""

from __future__ import annotations

import json
import os
import time

from . import export as obs_export
from . import flightrec
from ..utils import knobs


def flight_to_trace_dump(ring: dict | None) -> dict:
    """Shape a recovered ring as a ``Tracer.dump()`` payload whose
    instants are the flight events — the adapter that lets
    :func:`~nbdistributed_tpu_torch.observability.export.merge_trace` put
    recovered events on the same clock-aligned timeline as live
    spans."""
    instants = []
    for ev in (ring or {}).get("events", []):
        attrs = {k: v for k, v in ev.items() if k not in ("t", "ts")}
        if ring.get("torn_tail"):
            attrs.setdefault("ring_torn_tail", True)
        instants.append({"name": f"fr:{ev.get('t', '?')}",
                         "kind": "flight",
                         "t0": ev.get("ts", 0.0),
                         "tid": 0,
                         "attrs": attrs})
    return {"trace_id": None, "spans": [], "instants": instants,
            "dropped": 0}


def _merge_dump(live: dict | None, flight: dict | None) -> dict:
    """One rank's trace payload: live spans (if any) + flight
    instants."""
    live = dict(live or {"spans": [], "instants": []})
    fl = flight_to_trace_dump(flight)
    live["instants"] = list(live.get("instants", [])) + fl["instants"]
    live.setdefault("spans", [])
    return live


def _next_bundle_dir(root: str) -> str:
    os.makedirs(root, exist_ok=True)
    n = 0
    while True:
        d = os.path.join(root, f"postmortem-{n:03d}")
        if not os.path.exists(d):
            return d
        n += 1


def list_bundles(directory: str | None = None) -> list[str]:
    """Bundle directories under the run dir, oldest → newest."""
    d = directory or knobs.get_str("NBD_RUN_DIR")
    if not d or not os.path.isdir(d):
        return []
    out = [os.path.join(d, n) for n in sorted(os.listdir(d))
           if n.startswith("postmortem-")]
    return [p for p in out if os.path.isdir(p)]


def render_report(manifest: dict, rings: dict, telemetry: dict) -> str:
    """The human-readable side of the bundle."""
    lines = [
        "nbdistributed_tpu_torch postmortem",
        "=" * 34,
        f"created : {manifest.get('created')}",
        f"reason  : {manifest.get('reason') or 'on demand'}",
        f"dead    : ranks {manifest.get('dead_ranks') or '(none)'}",
        f"run dir : {manifest.get('run_dir')}",
        "",
    ]
    # Multi-host worlds: per-host grouping + link health at capture
    # time — "which link was sick" belongs next to "which rank died".
    links = manifest.get("link_stats") or {}
    if len(links.get("hosts") or {}) > 1:
        from ..resilience.partition import format_link_suffix
        lines.append("hosts / links at capture:")
        for h, hs in sorted(links["hosts"].items()):
            dead = [r for r in hs.get("ranks", ())
                    if r in (manifest.get("dead_ranks") or [])]
            lines.append(f"   {h:<14} ranks {hs.get('ranks')} · "
                         f"{format_link_suffix(hs)}"
                         + (f" · DEAD {dead}" if dead else ""))
        lines.append("")
    for key in sorted(rings, key=str):
        ring = rings[key]
        if ring is None:
            lines.append(f"-- {key}: no flight ring found")
            continue
        dead = (isinstance(key, int)
                and key in (manifest.get("dead_ranks") or []))
        tag = " [DEAD]" if dead else ""
        lines.append(
            f"-- {('rank ' + str(key)) if isinstance(key, int) else key}"
            f"{tag}: {ring['recovered']} events recovered"
            + (f", {ring['overwritten']} overwritten" if
               ring.get("overwritten") else "")
            + (", TORN final record" if ring.get("torn_tail") else ""))
        for ev in ring["events"][-8:]:
            ts = time.strftime("%H:%M:%S",
                               time.localtime(ev.get("ts", 0)))
            detail = {k: v for k, v in ev.items() if k not in ("t", "ts")}
            lines.append(f"     {ts} {ev.get('t', '?'):<22} "
                         f"{json.dumps(detail, default=str)[:120]}")
    if telemetry:
        lines.append("")
        lines.append("last telemetry per rank:")
        for r in sorted(telemetry, key=str):
            snaps = telemetry[r] or []
            last = snaps[-1] if snaps else None
            if not last:
                lines.append(f"   rank {r}: (none)")
                continue
            from .telemetry import hbm_totals
            tot = hbm_totals(last)
            mem = (f"{(tot['in_use'] or 0) / 1e9:.2f}"
                   f"/{(tot['limit'] or 0) / 1e9:.2f} GB"
                   + (f" over {tot['devices']} devices"
                      if tot["devices"] > 1 else "")
                   if tot else "n/a")
            lines.append(
                f"   rank {r}: hbm {mem} · bufs {last.get('bufs', '?')}"
                f" · compiles {last.get('compiles', '?')}"
                f" · sampled "
                f"{time.strftime('%H:%M:%S', time.localtime(last.get('ts', 0)))}")
    lines.append("")
    lines.append("files: trace.json (ui.perfetto.dev) · "
                 "flight_*.json · telemetry.json · manifest.json")
    return "\n".join(lines)


def build_bundle(out_dir: str, *, run_dir: str,
                 dead_ranks: list[int],
                 ranks: list[int],
                 coordinator_dump: dict | None = None,
                 rank_dumps: dict | None = None,
                 offsets: dict | None = None,
                 coordinator_faults: list | None = None,
                 rank_faults: dict | None = None,
                 telemetry: dict | None = None,
                 hang_report: str | None = None,
                 link_stats: dict | None = None,
                 reason: str = "") -> dict:
    """Assemble and write one bundle; returns the manifest (with
    ``"dir"`` set).  Pure function of its inputs + the ring files on
    disk — the capture front-ends (:func:`capture`, the supervisor, the
    magics) gather the live-process inputs."""
    os.makedirs(out_dir, exist_ok=True)
    rings: dict = {}
    for r in sorted(set(ranks) | set(dead_ranks)):
        rings[r] = flightrec.read_latest(run_dir, f"rank{r}")
    rings["coordinator"] = flightrec.read_latest(run_dir, "coordinator")

    telemetry = telemetry or {}
    manifest = {
        "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "created_unix": time.time(),
        "reason": reason,
        "run_dir": run_dir,
        "dead_ranks": sorted(dead_ranks),
        "ranks": sorted(set(ranks) | set(dead_ranks)),
        "rings": {str(k): {"recovered": v["recovered"],
                           "torn_tail": v["torn_tail"],
                           "overwritten": v["overwritten"],
                           "path": v["path"]}
                  for k, v in rings.items() if v is not None},
        "link_stats": link_stats or {},
        "dir": out_dir,
    }

    # Merged Chrome trace: live coordinator spans + every ring's
    # recovered events as instants, clock-corrected per rank.
    merged_ranks = {r: _merge_dump((rank_dumps or {}).get(r), rings[r])
                    for r in manifest["ranks"]}
    coord = _merge_dump(coordinator_dump, rings["coordinator"])
    merged = obs_export.merge_trace(
        coord, merged_ranks, offsets or {},
        coordinator_faults=coordinator_faults or [],
        rank_faults=rank_faults or {})
    files = {"trace.json": merged,
             "telemetry.json": {str(r): list(v or [])
                                for r, v in telemetry.items()},
             "manifest.json": manifest}
    for k, ring in rings.items():
        name = (f"flight_rank{k}.json" if isinstance(k, int)
                else f"flight_{k}.json")
        files[name] = ring if ring is not None else {"events": [],
                                                     "missing": True}
    for name, payload in files.items():
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(payload, f, default=str)
    report = render_report(manifest, rings, telemetry)
    if hang_report:
        # The stuck-cell doctor's assessment: per-rank
        # collective positions, the skew table, and stack-dump tails
        # at capture time — a hang that escalated into a death (or a
        # manual capture mid-hang) keeps its diagnosis next to the
        # black boxes.
        manifest["hang_report"] = "hang_report.txt"
        with open(os.path.join(out_dir, "hang_report.txt"), "w") as f:
            f.write(hang_report + "\n")
        report += ("\n(hang diagnosis at capture time: "
                   "hang_report.txt)")
    with open(os.path.join(out_dir, "report.txt"), "w") as f:
        f.write(report + "\n")
    return manifest


def capture(comm, dead_ranks=None, *, out_dir: str | None = None,
            reason: str = "", rank_dumps: dict | None = None,
            rank_faults: dict | None = None,
            hang_report: str | None = None) -> dict | None:
    """High-level capture against a live coordinator: pulls everything
    the coordinator holds (tracer dump, clock offsets, fault-plan
    events, piggybacked telemetry), recovers the rings from the run
    dir, writes a bundle, and returns its manifest.  Never raises —
    returns None on failure (the heal path must not die for a
    postmortem).

    ``rank_dumps`` / ``rank_faults``: optional per-rank ``trace dump``
    payloads for SURVIVING ranks (the dead ones can't answer); the
    magics pass them when a trace session is active.
    """
    try:
        run_d = flightrec.run_dir(create=False)
        dead = sorted(dead_ranks or [])
        ranks = list(range(getattr(comm, "num_workers", 0) or 0))
        telemetry = {}
        for r in ranks:
            hist = None
            get_hist = getattr(comm, "telemetry_history", None)
            if get_hist is not None:
                hist = get_hist(r)
            if hist:
                telemetry[r] = list(hist)
        plan = comm.fault_plan() if hasattr(comm, "fault_plan") else None
        try:
            links = comm.link_stats() if hasattr(comm,
                                                 "link_stats") else None
        except Exception:
            links = None
        out = out_dir or _next_bundle_dir(run_d)
        flightrec.record("postmortem", dir=out, dead=dead, reason=reason)
        manifest = build_bundle(
            out, run_dir=run_d, dead_ranks=dead, ranks=ranks,
            coordinator_dump=(comm.tracer.dump()
                              if getattr(comm, "tracer", None) is not None
                              and len(comm.tracer) else None),
            rank_dumps=rank_dumps,
            offsets=(comm.clock.offsets()
                     if getattr(comm, "clock", None) is not None else {}),
            coordinator_faults=(plan.events() if plan is not None else []),
            rank_faults=rank_faults,
            telemetry=telemetry, hang_report=hang_report,
            link_stats=links, reason=reason)
        return manifest
    except Exception:
        return None
