"""Median wall of the server's decode steps (``DecodeServer.step``; each
ends in its host read of the tokens) outside the profiled sub-window."""

import statistics

from perfkit.serve_stats import outside_profile


def read(run):
    r = run["record"]
    walls = [w for t, w, _ in r["steps"] if outside_profile(r, t)]
    return statistics.median(walls) * 1e3 if walls else None
