"""K1, the flash forward: its roofline share over the calls of the
profiled sub-window (forward and recompute), operations and bytes from
each call's shapes, window and documents."""

from perfkit import counts


def read(run):
    tr, calls = run["trace"], run["calls"].get("bench.attn_fwd", [])
    if tr is None or not calls:
        return None
    secs = tr.span_device_s("bench.attn_fwd")
    if secs <= 0:
        return None
    flops = nbytes = 0
    for args, kw in calls:
        _, (B, S, H, Dh), _ = args[0]
        Hkv = args[1][1][2]
        window = args[5] if len(args) > 5 else kw.get("window")
        seg = args[6] if len(args) > 6 else kw.get("segment_ids")
        lens = (counts.segments_to_lengths(seg) if seg is not None
                else [[S]] * B)
        f, b = counts.attn_fwd(B, S, H, Hkv, Dh, counts.pairs(lens, window),
                               segmented=seg is not None)
        flops, nbytes = flops + f, nbytes + b
    return counts.roofline_share(flops, nbytes, secs, run["peak"])
