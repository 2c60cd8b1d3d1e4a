"""Wall of the prefills (``DecodeServer.submit``, which admits, prefills
and samples the first token) per 1000 prompt tokens, over the window
outside the profiled sub-window."""

from perfkit.serve_stats import outside_profile


def read(run):
    r = run["record"]
    wall = toks = 0
    for q in r["requests"].values():
        t0, t1 = q["submit"]
        if r["t0"] <= t0 <= r["t_end"] and outside_profile(r, t0):
            wall += t1 - t0
            toks += q["prompt_len"]
    return 1e6 * wall / toks if toks else None
