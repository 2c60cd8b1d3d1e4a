"""K2 + K3, the whole flash backward: its roofline share over the calls
of the profiled sub-window."""

from perfkit import counts


def read(run):
    tr, calls = run["trace"], run["calls"].get("bench.attn_bwd", [])
    if tr is None or not calls:
        return None
    secs = tr.span_device_s("bench.attn_bwd")
    if secs <= 0:
        return None
    flops = nbytes = 0
    for args, kw in calls:
        _, (B, S, H, Dh), _ = args[0]
        Hkv = args[1][1][2]
        seg = kw.get("segment_ids")
        lens = (counts.segments_to_lengths(seg) if seg is not None
                else [[S]] * B)
        f, b = counts.attn_bwd(B, S, H, Hkv, Dh,
                               counts.pairs(lens, kw.get("window")),
                               segmented=seg is not None)
        flops, nbytes = flops + f, nbytes + b
    return counts.roofline_share(flops, nbytes, secs, run["peak"])
