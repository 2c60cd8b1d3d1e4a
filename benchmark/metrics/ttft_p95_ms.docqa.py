"""95th percentile of the time to first token over every request whose
first token came in the traced run's window, timed from when its
client sent it; requests whose wait overlapped the profiled sub-window
are left out.  A per-layer reading: across seeds it spreads by about
11 % (PERF.md), too wide for an end-to-end bound."""

from perfkit.serve_stats import p95, ttfts


def read(run):
    v = p95(ttfts(run["record"]))
    return None if v is None else v * 1e3
