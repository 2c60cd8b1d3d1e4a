"""Closed-loop load generator for the serving plane (counterpart of
``nbdistributed_tpu/serving_fast/loadgen.py``).

The serving fast path's throughput and SLO claims need a harness that
can actually falsify them: offer load at a configured rate, watch
every request to a TERMINAL verdict, and score the observed latency
distributions against explicit targets.  This module is that harness'
core — deliberately dependency-free (stdlib only, no torch) so the
unit tests, ``chip_smoke.py`` and the ``tools/nbd_torch_loadgen.py``
CLI all drive the exact same code.

Three pieces:

* :func:`synth_schedule` — a DETERMINISTIC arrival/shape plan from a
  seed: Poisson (exponential gaps) or uniform arrivals at ``rps``,
  with prompt/output lengths drawn uniformly from configured ranges.
  Same config -> same schedule, byte for byte, so a chaos run and its
  solo reference offer identical work.
* :func:`run_load` — the closed loop: submit each request at its
  scheduled offset through a pluggable *transport* (the HTTP shim or
  an in-process :class:`~..gateway.client.TenantClient`), poll every
  accepted request's stream to completion, and stamp client-side
  TTFT/TPOT/e2e from token arrival times.  Every offered request ends
  in an explicit bucket — accepted→completed, accepted→shed (the
  delivered overload verdict), rejected/shed at submit, failed, or
  ``hung`` (accepted but never terminal within the drain budget,
  which FAILS the run: zero silent drops is the contract).
* :func:`score_slo` / :func:`validate_report` — pass/fail against
  p99 targets (client-observed percentiles, with the server's
  histogram summary attached for cross-checking) and the pinned
  machine-readable report schema its consumers read.
"""

from __future__ import annotations

import json
import random
import time
import urllib.error
import urllib.request

REPORT_SCHEMA_VERSION = 1

# The pinned report surface: consumers (chip_smoke.py, perfwatch)
# key on these.  Adding a field is fine; removing or renaming one is a
# breaking change the schema unit test is meant to catch.
REPORT_REQUIRED_KEYS = frozenset({
    "schema", "config", "offered", "accepted", "rejected", "shed",
    "completed", "failed", "hung", "shed_rate", "tokens_total",
    "tokens_per_s", "duration_s", "client", "server_slo", "slo",
})
CLIENT_REQUIRED_KEYS = frozenset({"ttft_ms", "tpot_ms", "e2e_ms"})
SLO_REQUIRED_KEYS = frozenset({"targets", "checks", "pass"})


class LoadConfig:
    """One load run's shape.  ``arrival`` is ``"poisson"`` (memoryless
    gaps — the bursty realistic case) or ``"uniform"`` (constant gap —
    the pure-throughput case).  Lengths are inclusive ``(lo, hi)``
    ranges sampled per request."""

    def __init__(self, *, rps: float = 4.0, duration_s: float = 15.0,
                 arrival: str = "poisson", seed: int = 0,
                 prompt_len: tuple[int, int] = (4, 16),
                 max_new: tuple[int, int] = (4, 16),
                 vocab: int = 50, priority: int = 0,
                 slo_ttft_p99_ms: float | None = None,
                 slo_tpot_p99_ms: float | None = None,
                 drain_s: float = 60.0, poll_s: float = 0.02,
                 detail: bool = False):
        if rps <= 0:
            raise ValueError(f"rps must be > 0, got {rps}")
        if duration_s <= 0:
            raise ValueError(f"duration_s must be > 0, got {duration_s}")
        if arrival not in ("poisson", "uniform"):
            raise ValueError(f"arrival must be 'poisson' or 'uniform', "
                             f"got {arrival!r}")
        for name, (lo, hi) in (("prompt_len", prompt_len),
                               ("max_new", max_new)):
            if not (1 <= lo <= hi):
                raise ValueError(f"{name} must satisfy 1 <= lo <= hi, "
                                 f"got ({lo}, {hi})")
        self.rps = float(rps)
        self.duration_s = float(duration_s)
        self.arrival = arrival
        self.seed = int(seed)
        self.prompt_len = (int(prompt_len[0]), int(prompt_len[1]))
        self.max_new = (int(max_new[0]), int(max_new[1]))
        self.vocab = int(vocab)
        self.priority = int(priority)
        self.slo_ttft_p99_ms = slo_ttft_p99_ms
        self.slo_tpot_p99_ms = slo_tpot_p99_ms
        self.drain_s = float(drain_s)
        self.poll_s = float(poll_s)
        # detail=True adds a per-request ``requests`` list to the
        # report (plan index, rid, terminal status, tokens) — the
        # chaos integration test keys exactness assertions on it.
        self.detail = bool(detail)

    def to_dict(self) -> dict:
        return {"rps": self.rps, "duration_s": self.duration_s,
                "arrival": self.arrival, "seed": self.seed,
                "prompt_len": list(self.prompt_len),
                "max_new": list(self.max_new), "vocab": self.vocab,
                "priority": self.priority,
                "slo_ttft_p99_ms": self.slo_ttft_p99_ms,
                "slo_tpot_p99_ms": self.slo_tpot_p99_ms}


def synth_schedule(cfg: LoadConfig) -> list[dict]:
    """The deterministic offered-load plan: ``[{"at", "prompt",
    "max_new"}]`` sorted by arrival offset (seconds from run start).
    A pure function of the config — replaying the same config against
    a chaos run and a solo reference offers bit-identical work."""
    rng = random.Random(cfg.seed)
    out = []
    t = 0.0
    while True:
        if cfg.arrival == "poisson":
            t += rng.expovariate(cfg.rps)
        else:
            t += 1.0 / cfg.rps
        if t >= cfg.duration_s:
            break
        plen = rng.randint(*cfg.prompt_len)
        out.append({
            "at": t,
            "prompt": [rng.randrange(1, cfg.vocab)
                       for _ in range(plen)],
            "max_new": rng.randint(*cfg.max_new),
        })
    return out


def percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile on a pre-sorted list."""
    if not sorted_vals:
        raise ValueError("empty sample")
    i = min(len(sorted_vals) - 1,
            max(0, int(q * len(sorted_vals) + 0.5) - 1))
    return sorted_vals[i]


def _stats_ms(vals: list[float]) -> dict | None:
    sv = sorted(v for v in vals if v is not None)
    if not sv:
        return None
    return {"p50": round(percentile(sv, 0.50) * 1e3, 3),
            "p99": round(percentile(sv, 0.99) * 1e3, 3),
            "mean": round(sum(sv) / len(sv) * 1e3, 3),
            "max": round(sv[-1] * 1e3, 3),
            "n": len(sv)}


# ----------------------------------------------------------------------
# transports


class HTTPTransport:
    """The shim transport (``tools/nbd_serve.py``): everything over
    the ``/v1`` JSON endpoints.  Explicit 429/503 overload verdicts
    come back as verdict dicts, never exceptions — the loadgen scores
    them, it does not retry them."""

    def __init__(self, base_url: str, *, timeout: float = 30.0):
        self.base = base_url.rstrip("/")
        self.timeout = timeout

    def _get(self, path: str) -> dict:
        with urllib.request.urlopen(self.base + path,
                                    timeout=self.timeout) as r:
            return json.loads(r.read().decode("utf-8"))

    def submit(self, prompt: list[int], max_new: int,
               priority: int = 0) -> dict:
        body = json.dumps({"prompt": prompt,
                           "max_new_tokens": max_new,
                           "priority": priority}).encode("utf-8")
        req = urllib.request.Request(
            self.base + "/v1/submit", data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout) as r:
                return json.loads(r.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            # 429/503 carry the explicit verdict as their body.
            try:
                return json.loads(e.read().decode("utf-8"))
            except Exception:
                return {"status": "failed",
                        "error": f"HTTP {e.code}"}

    def result(self, rid: str) -> dict:
        return self._get(f"/v1/result/{rid}")

    def status(self) -> dict:
        return self._get("/v1/status")


class ClientTransport:
    """In-process transport over a connected
    :class:`~..gateway.client.TenantClient` — what the tests and the
    perfwatch smoke use (no HTTP server needed; same verdict surface)."""

    def __init__(self, client):
        self.client = client

    def submit(self, prompt: list[int], max_new: int,
               priority: int = 0) -> dict:
        from ..gateway.client import CellSubmitError
        try:
            return self.client.serve_submit(prompt, max_new,
                                            priority=priority)
        except CellSubmitError as e:
            return dict(e.verdict)

    def result(self, rid: str) -> dict:
        return self.client.serve_result(rid)

    def status(self) -> dict:
        return self.client.serve_status()


# ----------------------------------------------------------------------
# the closed loop


def run_load(transport, cfg: LoadConfig, *,
             on_progress=None) -> dict:
    """Offer :func:`synth_schedule`'s plan through ``transport``,
    follow every accepted request to a terminal state, and return the
    scored report.

    Single-threaded on purpose: one loop submits due arrivals and
    polls open requests, so the harness itself cannot reorder or race
    the offered load.  Polling granularity (``cfg.poll_s``) bounds
    client-side TTFT/TPOT resolution — fine for SLO targets in the
    tens of milliseconds and above.
    """
    plan = synth_schedule(cfg)
    t0 = time.monotonic()
    nxt = 0
    open_reqs: dict[str, dict] = {}
    done_reqs: list[dict] = []
    counts = {"offered": 0, "accepted": 0, "rejected": 0, "shed": 0,
              "completed": 0, "failed": 0, "hung": 0}
    tokens_total = 0

    def poll_open() -> None:
        nonlocal tokens_total
        now = time.monotonic()
        for rid in list(open_reqs):
            st = open_reqs[rid]
            try:
                r = transport.result(rid)
            except Exception as e:
                st["error"] = f"{type(e).__name__}: {e}"
                continue
            n = len(r.get("tokens") or ())
            if n > st["seen"]:
                if st["first_tok"] is None:
                    st["first_tok"] = now
                st["last_tok"] = now
                st["seen"] = n
            if r.get("done"):
                st["end"] = now
                st["status"] = r.get("status")
                st["tokens"] = list(r.get("tokens") or ())
                tokens_total += n
                if st["status"] == "completed":
                    counts["completed"] += 1
                elif st["status"] == "shed":
                    # Accepted-then-shed: a delivered overload
                    # verdict, not a failure.
                    counts["shed"] += 1
                else:
                    counts["failed"] += 1
                done_reqs.append(st)
                del open_reqs[rid]

    while nxt < len(plan) or open_reqs:
        now = time.monotonic() - t0
        if nxt < len(plan) and now >= plan[nxt]["at"]:
            item, idx = plan[nxt], nxt
            nxt += 1
            counts["offered"] += 1
            sub_t = time.monotonic()
            try:
                v = transport.submit(item["prompt"], item["max_new"],
                                     cfg.priority)
            except Exception as e:
                counts["failed"] += 1
                done_reqs.append({"i": idx, "status": "failed",
                                  "seen": 0,
                                  "submit": sub_t, "first_tok": None,
                                  "last_tok": None, "end": sub_t,
                                  "error": f"{type(e).__name__}: {e}"})
                continue
            status = v.get("status")
            if status == "accepted":
                counts["accepted"] += 1
                open_reqs[v["rid"]] = {
                    "i": idx, "rid": v["rid"], "status": "accepted",
                    "submit": sub_t, "first_tok": None,
                    "last_tok": None, "end": None, "seen": 0}
            elif status in ("rejected", "shed"):
                counts[status] += 1
                done_reqs.append({"i": idx, "status": status,
                                  "seen": 0,
                                  "submit": sub_t, "first_tok": None,
                                  "last_tok": None, "end": sub_t})
            else:
                counts["failed"] += 1
                done_reqs.append({"i": idx, "status": "failed",
                                  "seen": 0,
                                  "submit": sub_t, "first_tok": None,
                                  "last_tok": None, "end": sub_t,
                                  "error": str(v)[:200]})
            continue   # drain the due arrivals before sleeping
        poll_open()
        if on_progress is not None:
            on_progress(counts, len(open_reqs))
        if nxt >= len(plan):
            # Drain phase: bounded — an accepted request that never
            # terminalizes is a HUNG verdict, not an infinite wait.
            if time.monotonic() - t0 > cfg.duration_s + cfg.drain_s:
                for st in open_reqs.values():
                    st["status"] = "hung"
                    st["end"] = time.monotonic()
                    counts["hung"] += 1
                    done_reqs.append(st)
                open_reqs.clear()
                break
        wake = time.monotonic() + cfg.poll_s
        if nxt < len(plan):
            wake = min(wake, t0 + plan[nxt]["at"])
        delay = wake - time.monotonic()
        if delay > 0:
            time.sleep(delay)
    wall = time.monotonic() - t0

    ttft = [st["first_tok"] - st["submit"] for st in done_reqs
            if st.get("first_tok") is not None]
    tpot = [(st["last_tok"] - st["first_tok"]) / (st["seen"] - 1)
            for st in done_reqs
            if st.get("first_tok") is not None
            and st.get("last_tok") is not None and st["seen"] > 1
            and st["last_tok"] > st["first_tok"]]
    e2e = [st["end"] - st["submit"] for st in done_reqs
           if st.get("status") == "completed"
           and st.get("end") is not None]

    try:
        server_slo = (transport.status() or {}).get("slo") or {}
    except Exception:
        server_slo = {}

    report = {
        "schema": REPORT_SCHEMA_VERSION,
        "config": cfg.to_dict(),
        **counts,
        "shed_rate": round((counts["shed"] + counts["rejected"])
                           / max(1, counts["offered"]), 4),
        "tokens_total": tokens_total,
        "tokens_per_s": round(tokens_total / wall, 2) if wall > 0
        else 0.0,
        "duration_s": round(wall, 3),
        "client": {"ttft_ms": _stats_ms(ttft),
                   "tpot_ms": _stats_ms(tpot),
                   "e2e_ms": _stats_ms(e2e)},
        "server_slo": server_slo,
    }
    if cfg.detail:
        report["requests"] = [
            {"i": st.get("i"), "rid": st.get("rid"),
             "status": st.get("status"),
             "tokens": st.get("tokens")}
            for st in sorted(done_reqs,
                             key=lambda s: s.get("i", -1))]
    report["slo"] = score_slo(report, cfg)
    return report


def score_slo(report: dict, cfg: LoadConfig) -> dict:
    """Pass/fail verdicts against the configured p99 targets, from the
    CLIENT-observed percentiles (what a user feels; the server's
    histogram summary rides along in the report for cross-checking).
    A run with hung requests fails regardless of latency — silent
    drops are never a pass."""
    checks = []
    for metric, target in (("ttft", cfg.slo_ttft_p99_ms),
                           ("tpot", cfg.slo_tpot_p99_ms)):
        if target is None:
            continue
        obs = (report["client"].get(metric + "_ms") or {}).get("p99")
        checks.append({"metric": metric + "_p99_ms",
                       "target": float(target), "observed": obs,
                       "ok": obs is not None and obs <= float(target)})
    if report.get("hung", 0):
        checks.append({"metric": "hung", "target": 0.0,
                       "observed": float(report["hung"]),
                       "ok": False})
    return {"targets": {"ttft_p99_ms": cfg.slo_ttft_p99_ms,
                        "tpot_p99_ms": cfg.slo_tpot_p99_ms},
            "checks": checks,
            "pass": all(c["ok"] for c in checks)}


def validate_report(report: dict) -> None:
    """Assert the pinned report shape; raises ``ValueError`` naming
    the first violation.  The schema tests call this on a real run's
    output, so a drifting field shows up as a test failure."""
    if not isinstance(report, dict):
        raise ValueError("report must be a dict")
    missing = REPORT_REQUIRED_KEYS - set(report)
    if missing:
        raise ValueError(f"report missing keys: {sorted(missing)}")
    if report["schema"] != REPORT_SCHEMA_VERSION:
        raise ValueError(f"unknown schema version {report['schema']!r}"
                         f" (expected {REPORT_SCHEMA_VERSION})")
    if not isinstance(report["client"], dict) \
            or CLIENT_REQUIRED_KEYS - set(report["client"]):
        raise ValueError("report.client must carry "
                         f"{sorted(CLIENT_REQUIRED_KEYS)}")
    slo = report["slo"]
    if not isinstance(slo, dict) or SLO_REQUIRED_KEYS - set(slo):
        raise ValueError("report.slo must carry "
                         f"{sorted(SLO_REQUIRED_KEYS)}")
    for k in ("offered", "accepted", "rejected", "shed", "completed",
              "failed", "hung", "tokens_total"):
        if not isinstance(report[k], int) or report[k] < 0:
            raise ValueError(f"report.{k} must be a non-negative int")
    terminal = (report["completed"] + report["failed"]
                + report["shed"] + report["rejected"]
                + report["hung"])
    if terminal != report["offered"]:
        raise ValueError(
            f"conservation broken: {terminal} terminal verdicts for "
            f"{report['offered']} offered requests — a request was "
            f"silently dropped or double-counted")
