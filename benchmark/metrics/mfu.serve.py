"""Forward FLOPs of the work served in the window outside the profiled
sub-window (two per active parameter -- attention, router, the top-k
experts -- per token processed, the attention products of the keys each
query attended, and the lm_head where logits were taken) over those
seconds, as a share of the card's bf16 peak."""

from perfkit import counts
from perfkit.serve_stats import outside_profile, profiled_seconds


def read(run):
    r = run["record"]
    s = r["sizes"]
    window = s["sliding_window"]
    tokens = keys = heads = 0
    for q in r["requests"].values():
        P, t0 = q["prompt_len"], q["submit"][0]
        if r["t0"] <= t0 <= r["t_end"] and outside_profile(r, t0):
            tokens += P
            keys += counts.doc_pairs(P, window)
            heads += 1
        for m, t in enumerate(q["times"][1:], start=1):
            if r["t0"] <= t <= r["t_end"] and outside_profile(r, t):
                tokens += 1
                keys += counts.decode_keys([P + m - 1], window)[0]
                heads += 1
    seconds = r["window_s"] - profiled_seconds(r)
    if seconds <= 0 or tokens == 0:
        return None
    flops = counts.serve_flops(s, tokens, keys, heads)
    return 100.0 * flops / seconds / run["peak"]["bf16_flops"]
