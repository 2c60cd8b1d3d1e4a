"""Median, over the decode steps of the profiled sub-window (the
program's ``serve/decode`` spans), of the host's own time in each: the
span less the ``sync/*`` reads inside it (``decode_read_ms.serve``),
the time spent issuing the step's work."""

import statistics

from perfkit import spec


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    steps = spec.metric_reader("decode_read_ms.serve").per_step(tr)
    return statistics.median(d - r for d, r in steps) if steps else None
