"""Serving observatory (counterpart of
``nbdistributed_tpu/observability/servingobs.py``): per-request decode lifecycle
attribution + KV/batching utilization telemetry for the serving fast
path.

The latency observatory (:mod:`.latency`) gives every ``execute`` an
exact eight-stage decomposition; this module extends the same "every
millisecond has an address" guarantee to served tokens.  Every request
the :class:`~..gateway.serving.ServingManager` completes gets a
CONTIGUOUS stage decomposition::

    admit -> queue -> kv_alloc -> prefill -> decode_wait -> decode
          -> emit -> deliver

that sums to the observed end-to-end latency *by construction*, under
the same clock discipline latency.py pins down:

* Interval boundaries are GATEWAY wall-clock anchors (submit entry,
  ticket grant, placement, first/last emission arrival, finish), so
  adjacent stages share their boundary and the telescoping sum is
  exact — no cross-clock subtraction ever enters the sum.
* Worker-side durations (decode compute per tick, gateway emit
  handling) only SPLIT the span they live in: ``decode`` and ``emit``
  are capped to the ``[first_tok, last_emit]`` span and
  ``decode_wait`` is the remainder, so every stage is >= 0 and the
  three still sum to the span exactly (the proportional-split
  discipline latency.py uses for the wire/reply pair).
* TTFT decomposes as ``admit + queue + kv_alloc + prefill`` — again
  telescoping, so the identity is exact, not approximate.
* TPOT uses WORKER emission timestamps corrected by the NTP-style
  per-rank offset estimator (:mod:`.clock`) when stamps are present
  (cross-rank decode ticks must not mix clocks), clamped >= 0 like
  every latency.py stage, with the gateway arrival times as the
  fallback.

Records land in ``nbd_serve_stage_seconds{stage,tenant}`` histograms
(resolved through the registry at every use so tenant eviction's
``remove_label_series`` really retires them), a bounded ring behind
``%dist_serve lat`` (``NBD_SERVE_LAT`` / ``NBD_SERVE_LAT_RING``), and
``stage/*`` tracer spans that fold into the Perfetto merged trace with
per-request named tracks (``attrs["serve_rid"]``).

The second half is per-tick utilization: the serving driver feeds one
sample per decode tick (batch fill ratio, prefill-vs-decode token
split, per-rank KV block occupancy / fragmentation / defer depth) into
a time-series ring rendered by ``%dist_serve status`` and
``/latency.json``, and mirrored into gauges for scrapes.
"""

from __future__ import annotations

import threading
from collections import deque

from . import metrics as obs_metrics
from .latency import _ms, percentile
from ..utils import knobs

SERVE_STAGES = ("admit", "queue", "kv_alloc", "prefill",
                "decode_wait", "decode", "emit", "deliver")

DEFAULT_RING = 256


def largest_free_run(free_ids) -> int:
    """Longest contiguous run of block ids in ``free_ids`` — the
    fragmentation number next to the free count: a pool with 40 free
    blocks in runs of 1 behaves very differently from one 40-block
    run.  Accepts any iterable; ids need not be sorted."""
    ids = sorted(set(int(b) for b in free_ids))
    best = run = 0
    prev = None
    for b in ids:
        run = run + 1 if prev is not None and b == prev + 1 else 1
        best = max(best, run)
        prev = b
    return best


class _PendingServe:
    """Accumulating stamps for one in-flight served request.  Written
    only under the observatory lock."""

    __slots__ = ("rid", "tenant", "t_submit", "t_admit", "t_placed",
                 "rank", "kv_alloc_s", "need_blocks", "t_first",
                 "t_last", "decode_s", "emit_s", "worker_ts",
                 "n_tokens", "pf_done", "pf_total")

    def __init__(self, rid: str, tenant: str, t_submit: float):
        self.rid = rid
        self.tenant = tenant
        self.t_submit = t_submit
        self.t_admit: float | None = None
        self.t_placed: float | None = None
        self.rank: int | None = None
        self.kv_alloc_s = 0.0
        self.need_blocks = 0
        self.t_first: float | None = None
        self.t_last: float | None = None
        self.decode_s = 0.0      # worker tick compute while active
        self.emit_s = 0.0        # gateway emission-handling time
        # (corrected worker ts, cumulative token count) per emission —
        # the clock-corrected TPOT source (satellite: cross-rank
        # decode ticks must not mix clocks).
        self.worker_ts: list[tuple[float, int]] = []
        self.n_tokens = 0
        self.pf_done = 0         # prefill chunks written
        self.pf_total = 0        # prefill chunks planned


class ServingObservatory:
    """Stage attribution + utilization telemetry for one serving
    plane.  All note_* calls are cheap dict/deque writes under one
    lock; the driver calls them from its tick loop and ``submit``
    threads call begin/admit/drop — the lock is never held across IO.
    """

    def __init__(self, *, clock=None, now=None):
        self.enabled = knobs.get_bool("NBD_SERVE_LAT", True)
        ring = knobs.get_int("NBD_SERVE_LAT_RING", DEFAULT_RING)
        self._clock = clock                    # ClockEstimator | None
        import time
        self._now = now or time.time
        self._lock = threading.Lock()
        self._pending: dict[str, _PendingServe] = {}
        self._ring: deque = deque(maxlen=max(8, ring))
        self._util: deque = deque(maxlen=max(8, ring))
        self.completed = 0
        self.dropped = 0

    # ------------------------------------------------------------------
    # request lifecycle (driven by ServingManager)

    def begin(self, rid: str, tenant: str,
              t_submit: float | None = None) -> None:
        if not self.enabled:
            return
        t = self._now() if t_submit is None else t_submit
        with self._lock:
            self._pending[rid] = _PendingServe(rid, tenant, t)

    def note_admit(self, rid: str, t: float | None = None) -> None:
        """Verdict issued: journal accepted + scheduler ticket held."""
        with self._lock:
            p = self._pending.get(rid)
            if p is not None and p.t_admit is None:
                p.t_admit = self._now() if t is None else t

    def note_placed(self, rid: str, rank: int, *,
                    kv_alloc_s: float = 0.0, need_blocks: int = 0,
                    pf_total: int = 0,
                    t: float | None = None) -> None:
        """Placed on a decode rank; ``kv_alloc_s`` is the measured
        block-reservation time inside placement.  Failover re-places
        a request — only the FIRST placement ends its queue stage
        (matching ``_Req.placed_ts``), but the rank always updates so
        the record names where it finished."""
        with self._lock:
            p = self._pending.get(rid)
            if p is None:
                return
            p.rank = rank
            p.kv_alloc_s += max(0.0, kv_alloc_s)
            if need_blocks:
                p.need_blocks = need_blocks
            if pf_total:
                p.pf_total = pf_total
            if p.t_placed is None:
                p.t_placed = self._now() if t is None else t

    def note_emission(self, rid: str, rank: int, n_toks: int, *,
                      t_recv: float | None = None,
                      t_worker: float | None = None,
                      emit_s: float = 0.0) -> None:
        """Tokens arrived from a decode rank.  ``t_worker`` is the
        worker's wall clock when the tick replied; it is corrected by
        the per-rank offset estimate HERE, so every stored stamp is
        already on the gateway clock."""
        with self._lock:
            p = self._pending.get(rid)
            if p is None:
                return
            t = self._now() if t_recv is None else t_recv
            if p.t_first is None:
                p.t_first = t
            p.t_last = t
            p.n_tokens += max(0, n_toks)
            p.emit_s += max(0.0, emit_s)
            if t_worker is not None:
                off = 0.0
                if self._clock is not None:
                    try:
                        off = float(self._clock.offset(rank))
                    except Exception:
                        off = 0.0
                p.worker_ts.append((t_worker - off, p.n_tokens))

    def note_decode(self, rid: str, step_s: float) -> None:
        """Attribute one tick's decode compute to an active request.
        Continuous batching shares the forward, so every active
        request's wall time during the tick IS the whole tick — the
        per-request decode stage accumulates tick compute, and
        ``decode_wait`` absorbs the scheduling/wire remainder."""
        with self._lock:
            p = self._pending.get(rid)
            if p is not None:
                p.decode_s += max(0.0, step_s)

    def note_prefill_progress(self, rid: str, done: int,
                              total: int) -> None:
        with self._lock:
            p = self._pending.get(rid)
            if p is not None:
                p.pf_done = max(p.pf_done, int(done))
                p.pf_total = max(p.pf_total, int(total))

    def drop(self, rid: str) -> None:
        """Forget a request that will never complete here (shed,
        rejected, failed before any stage worth recording)."""
        with self._lock:
            if self._pending.pop(rid, None) is not None:
                self.dropped += 1

    def complete(self, rid: str, status: str,
                 t_finish: float | None = None,
                 tracer=None) -> dict | None:
        """Close the record: compute the contiguous stage split, push
        it onto the ring + histograms, mirror tracer spans.  Returns
        the record (``None`` when the request was never begun)."""
        with self._lock:
            p = self._pending.pop(rid, None)
        if p is None:
            return None
        t_finish = self._now() if t_finish is None else t_finish

        def pos(x: float) -> float:
            return x if x > 0.0 else 0.0

        t_admit = p.t_admit if p.t_admit is not None else p.t_submit
        t_placed = p.t_placed if p.t_placed is not None else t_admit
        t_first = p.t_first if p.t_first is not None else t_placed
        t_last = p.t_last if p.t_last is not None else t_first

        stages: dict[str, float] = {}
        stages["admit"] = pos(t_admit - p.t_submit)
        stages["queue"] = pos(t_placed - t_admit)
        # TTFT tail: [placed, first_tok] = kv_alloc + prefill.  The
        # measured allocation time is capped to the span and prefill
        # is the remainder, so ttft == admit + queue + kv_alloc +
        # prefill EXACTLY (telescoping gateway anchors).
        ttft_tail = pos(t_first - t_placed)
        stages["kv_alloc"] = min(pos(p.kv_alloc_s), ttft_tail)
        stages["prefill"] = ttft_tail - stages["kv_alloc"]
        # Decode span: worker-attributed compute and gateway emit
        # handling are capped to it; decode_wait is the remainder
        # (rank scheduling, wire, other tenants' ticks).
        span = pos(t_last - t_first)
        stages["decode"] = min(pos(p.decode_s), span)
        stages["emit"] = min(pos(p.emit_s), span - stages["decode"])
        stages["decode_wait"] = (span - stages["decode"]
                                 - stages["emit"])
        stages["deliver"] = pos(t_finish - t_last)

        e2e = pos(t_finish - p.t_submit)
        ttft = (stages["admit"] + stages["queue"]
                + stages["kv_alloc"] + stages["prefill"])
        tpot = self._tpot(p)

        rec = {
            "rid": rid,
            "tenant": p.tenant,
            "rank": p.rank,
            "status": status,
            "ts": round(t_finish, 6),
            "e2e_s": round(e2e, 6),
            "ttft_s": round(ttft, 6),
            "tpot_s": round(tpot, 6) if tpot is not None else None,
            "n_tokens": p.n_tokens,
            "need_blocks": p.need_blocks,
            "prefill_chunks": [p.pf_done, p.pf_total],
            "stages": {s: round(stages[s], 6) for s in SERVE_STAGES},
        }
        with self._lock:
            self._ring.append(rec)
            self.completed += 1

        if self.enabled:
            reg = obs_metrics.registry()
            for s in SERVE_STAGES:
                # Resolved fresh each time: tenant eviction's
                # remove_label_series must really retire these.
                reg.histogram(
                    "nbd_serve_stage_seconds",
                    "per-request serving stage durations (contiguous "
                    "decomposition summing to e2e)",
                    {"stage": s, "tenant": p.tenant},
                    buckets=obs_metrics.LATENCY_BUCKETS,
                ).observe(stages[s])
        if tracer is not None and getattr(tracer, "enabled", False):
            self._mirror_spans(tracer, p, stages, t_finish)
        return rec

    def _tpot(self, p: _PendingServe) -> float | None:
        """Mean inter-token time AFTER the first emission, from
        clock-corrected worker stamps when available (two or more
        emissions carried them), else gateway arrival times.  Clamped
        >= 0: an offset-estimate error must never surface as negative
        time."""
        stamps = p.worker_ts
        if len(stamps) >= 2:
            (t0, n0), (t1, n1) = stamps[0], stamps[-1]
            if n1 > n0:
                return max(0.0, (t1 - t0) / (n1 - n0))
        if (p.t_first is not None and p.t_last is not None
                and p.n_tokens > 1):
            return max(0.0, (p.t_last - p.t_first) / (p.n_tokens - 1))
        return None

    def _mirror_spans(self, tracer, p: _PendingServe,
                      stages: dict, t_finish: float) -> None:
        """Stage child spans for the Perfetto merged trace.  The
        ``serve_rid`` attr keys per-request named tracks in
        export.py's merge (tenant tracks already exist; request
        tracks ride the same mechanism one level finer)."""
        attrs = {"serve_rid": p.rid, "tenant": p.tenant}
        if p.rank is not None:
            attrs["rank"] = p.rank
        t = p.t_submit
        for s in SERVE_STAGES:
            dur = stages[s]
            if dur > 0:
                tracer.add_span(f"stage/{s}", "serving", t, dur,
                                attrs=attrs)
            t += dur

    # ------------------------------------------------------------------
    # utilization telemetry (per decode tick)

    def note_util(self, *, ranks: dict, prefill_toks: int = 0,
                  decode_toks: int = 0, backlog: int = 0,
                  tenant: str = "", t: float | None = None) -> None:
        """One per-tick utilization sample.  ``ranks`` maps rank ->
        ``{"placed", "slots", "kv_used", "kv_free", "frag",
        "pending"}`` (gateway-side allocator mirrors + worker-reported
        defer depth); token counts are the tick's prefill/decode
        split summed across ranks."""
        slots = sum(int(v.get("slots") or 0) for v in ranks.values())
        placed = sum(int(v.get("placed") or 0) for v in ranks.values())
        fill = (placed / slots) if slots else 0.0
        sample = {
            "ts": round(self._now() if t is None else t, 3),
            "fill": round(fill, 4),
            "prefill_toks": int(prefill_toks),
            "decode_toks": int(decode_toks),
            "backlog": int(backlog),
            "ranks": {str(r): dict(v) for r, v in ranks.items()},
        }
        with self._lock:
            self._util.append(sample)
        if not self.enabled:
            return
        reg = obs_metrics.registry()
        labels = {"tenant": tenant} if tenant else {}
        reg.gauge("nbd_serve_batch_fill_ratio",
                  "decode-slot occupancy across open ranks, last tick",
                  labels).set(round(fill, 4))
        reg.gauge("nbd_serve_tick_prefill_tokens",
                  "prompt tokens prefilled during the last decode "
                  "tick (chunked-prefill share of the tick)",
                  labels).set(int(prefill_toks))
        reg.gauge("nbd_serve_tick_decode_tokens",
                  "tokens decoded during the last decode tick",
                  labels).set(int(decode_toks))
        for r, v in ranks.items():
            rl = dict(labels, rank=str(r))
            if v.get("frag") is not None:
                reg.gauge("nbd_kv_frag_largest_run",
                          "largest contiguous free KV-block run on "
                          "this decode rank (fragmentation: compare "
                          "with nbd_kv_blocks_free)", rl
                          ).set(int(v["frag"]))
            if v.get("pending") is not None:
                reg.gauge("nbd_serve_defer_depth",
                          "requests deferred worker-side (admitted "
                          "but pending on KV blocks) on this rank",
                          rl).set(int(v["pending"]))

    # ------------------------------------------------------------------
    # readers

    def records(self, last: int | None = None) -> list[dict]:
        with self._lock:
            recs = list(self._ring)
        return recs[-last:] if last else recs

    def util_samples(self, last: int | None = None) -> list[dict]:
        with self._lock:
            recs = list(self._util)
        return recs[-last:] if last else recs

    def summary(self) -> dict:
        """Percentile table over the ring, milliseconds:
        ``{"count", "dropped", "e2e_ms": {...}, "ttft_ms": {...},
        "tpot_ms": {...}, "stages": {stage: {p50,p95,p99,mean,
        share}}}``."""
        recs = self.records()
        out: dict = {"count": len(recs), "dropped": self.dropped}
        if not recs:
            return out

        def _stats(vals: list[float]) -> dict:
            sv = sorted(vals)
            return {"p50": _ms(percentile(sv, 0.50)),
                    "p95": _ms(percentile(sv, 0.95)),
                    "p99": _ms(percentile(sv, 0.99)),
                    "mean": _ms(sum(sv) / len(sv))}

        e2e = [r["e2e_s"] for r in recs]
        out["e2e_ms"] = _stats(e2e)
        out["ttft_ms"] = _stats([r["ttft_s"] for r in recs])
        tpots = [r["tpot_s"] for r in recs if r["tpot_s"] is not None]
        if tpots:
            out["tpot_ms"] = _stats(tpots)
        mean_e2e = sum(e2e) / len(e2e)
        stages: dict[str, dict] = {}
        for s in SERVE_STAGES:
            vals = [r["stages"][s] for r in recs]
            st = _stats(vals)
            st["share"] = (round((sum(vals) / len(vals)) / mean_e2e, 4)
                           if mean_e2e > 0 else 0.0)
            stages[s] = st
        out["stages"] = stages
        return out

    def util_summary(self, window: int = 32) -> dict:
        """Recent utilization aggregate for status surfaces: mean/max
        batch fill, prefill-vs-decode token split, newest per-rank
        occupancy/fragmentation/defer sample."""
        recs = self.util_samples(window)
        if not recs:
            return {"count": 0}
        fills = [r["fill"] for r in recs]
        pf = sum(r["prefill_toks"] for r in recs)
        dc = sum(r["decode_toks"] for r in recs)
        return {
            "count": len(recs),
            "fill_mean": round(sum(fills) / len(fills), 4),
            "fill_max": round(max(fills), 4),
            "prefill_toks": pf,
            "decode_toks": dc,
            "prefill_share": (round(pf / (pf + dc), 4)
                              if (pf + dc) else 0.0),
            "ranks": recs[-1]["ranks"],
        }

    def status_block(self, records: int = 0) -> dict:
        """The machine-readable serving block for ``/latency.json``
        and ``serve_status`` replies."""
        out = {"enabled": self.enabled, "summary": self.summary(),
               "util": self.util_summary()}
        if records:
            out["records"] = self.records(records)
        return out


# ----------------------------------------------------------------------
# renderers (%dist_serve lat)


def format_serve_stage_table(summary: dict) -> str:
    """Fixed-width per-stage percentile table (milliseconds)."""
    stages = summary.get("stages") or {}
    if not stages:
        return "(no completed serving records yet)"
    lines = [f"{'stage':<12} {'p50':>9} {'p95':>9} {'p99':>9} "
             f"{'mean':>9} {'share':>7}"]
    for s in SERVE_STAGES:
        st = stages.get(s)
        if not st:
            continue
        lines.append(
            f"{s:<12} {st['p50']:>9.2f} {st['p95']:>9.2f} "
            f"{st['p99']:>9.2f} {st['mean']:>9.2f} "
            f"{st['share'] * 100:>6.1f}%")
    e2e = summary.get("e2e_ms") or {}
    ttft = summary.get("ttft_ms") or {}
    if e2e:
        lines.append(
            f"{'e2e':<12} {e2e['p50']:>9.2f} {e2e['p95']:>9.2f} "
            f"{e2e['p99']:>9.2f} {e2e['mean']:>9.2f} {'100%':>7}")
    if ttft:
        lines.append(
            f"{'ttft':<12} {ttft['p50']:>9.2f} {ttft['p95']:>9.2f} "
            f"{ttft['p99']:>9.2f} {ttft['mean']:>9.2f} {'':>7}")
    return "\n".join(lines)


def format_serve_waterfall(records: list[dict],
                           width: int = 44) -> str:
    """ASCII per-request waterfall of the stage decomposition —
    one row per record, bars proportional to stage duration within
    the longest e2e shown."""
    if not records:
        return "(no completed serving records yet)"
    glyphs = {"admit": "a", "queue": "·", "kv_alloc": "k",
              "prefill": "▒", "decode_wait": "-", "decode": "█",
              "emit": "e", "deliver": "d"}
    t_max = max(r["e2e_s"] for r in records) or 1e-9
    scale = width / t_max
    lines = ["  " + " ".join(f"{glyphs[s]}={s}"
                             for s in SERVE_STAGES)]
    for r in records:
        bar = ""
        for s in SERVE_STAGES:
            n = int(round(r["stages"][s] * scale))
            bar += glyphs[s] * n
        bar = bar[:width]
        rk = f"r{r['rank']}" if r.get("rank") is not None else "r?"
        lines.append(
            f"{r['rid']:>8} {rk:>3} {bar:<{width}} "
            f"{_ms(r['e2e_s']):>8.1f}ms "
            f"ttft {_ms(r['ttft_s']):>7.1f}ms "
            f"{r['n_tokens']:>4}tok")
    return "\n".join(lines)
