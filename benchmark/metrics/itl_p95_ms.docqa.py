"""95th percentile of the gap between consecutive output tokens, over
every gap that ended in the traced run's window and did not overlap
the profiled sub-window.  A per-layer reading: across seeds it spreads
by about 12 % (PERF.md), too wide for an end-to-end bound."""

from perfkit.serve_stats import gaps, p95


def read(run):
    v = p95(gaps(run["record"]))
    return None if v is None else v * 1e3
