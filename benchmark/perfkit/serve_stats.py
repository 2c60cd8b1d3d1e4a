"""What the serving metrics take from a serve record: the times each
request saw, cut to the window."""

from __future__ import annotations

import statistics


def _in(r: dict, t: float) -> bool:
    return r["t0"] <= t <= r["t_end"]


def outside_profile(r: dict, t: float) -> bool:
    iv = r.get("profiled_interval")
    return iv is None or not (iv[0] <= t <= iv[1])


def profiled_seconds(r: dict) -> float:
    iv = r.get("profiled_interval")
    return 0.0 if iv is None else iv[1] - iv[0]


def tokens_in_window(r: dict) -> int:
    """Prompt tokens of the prefills whose first token came in the
    window, and every token whose time fell in it."""
    n = 0
    for q in r["requests"].values():
        if _in(r, q["times"][0]):
            n += q["prompt_len"]
        n += sum(1 for t in q["times"] if _in(r, t))
    return n


def _clear(r: dict, a: float, b: float) -> bool:
    """Whether [a, b] misses the profiled sub-window."""
    iv = r.get("profiled_interval")
    return iv is None or b < iv[0] or a > iv[1]


def ttfts(r: dict) -> list[float]:
    return [q["times"][0] - q["sent"] for q in r["requests"].values()
            if _in(r, q["times"][0]) and _clear(r, q["sent"], q["times"][0])]


def gaps(r: dict) -> list[float]:
    return [b - a for q in r["requests"].values()
            for a, b in zip(q["times"][:-1], q["times"][1:])
            if _in(r, b) and _clear(r, a, b)]


def p95(xs: list[float]) -> float | None:
    if len(xs) < 2:
        return None
    return statistics.quantiles(xs, n=20, method="inclusive")[18]
