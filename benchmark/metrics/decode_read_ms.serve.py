"""Median, over the decode steps of the profiled sub-window (the
program's ``serve/decode`` spans), of the host's wait on the device in
each: the time covered by the ``sync/*`` spans (the program's
device-to-host reads) that lie inside it on its thread.
``decode_host_ms.serve`` is the rest of the same span, so the two add
up to it step by step."""

import statistics

DECODE, SYNC = "serve/decode", "sync/"


def _covered(ivs) -> float:
    """Length of the union of intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(ivs):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def per_step(tr) -> list[tuple[float, float]]:
    """(duration, time in reads) in ms of every ``serve/decode`` span of
    the trace, in order of start."""
    out = []
    for (name, tid), steps in tr.spans.items():
        if name != DECODE:
            continue
        syncs = [iv for (n, t), ivs in tr.spans.items()
                 if t == tid and n.startswith(SYNC) for iv in ivs]
        for a, b in steps:
            read = _covered([(x, y) for x, y in syncs if a <= x and y <= b])
            out.append((a, (b - a) * 1e-3, read * 1e-3))
    return [(d, r) for _, d, r in sorted(out)]


def read(run):
    tr = run["trace"]
    steps = [] if tr is None else per_step(tr)
    return statistics.median(r for _, r in steps) if steps else None
