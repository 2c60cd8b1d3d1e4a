"""K4, flash decode: its roofline share over the calls of the profiled
sub-window; bytes are the K/V rows each row's position needs."""

from perfkit import counts


def read(run):
    tr, calls = run["trace"], run["calls"].get("bench.decode_attn", [])
    if tr is None or not calls:
        return None
    secs = tr.span_device_s("bench.decode_attn")
    if secs <= 0:
        return None
    flops = nbytes = 0
    for args, kw in calls:
        _, (B, H, Dh), _ = args[0]
        Hkv = args[1][1][1]
        f, b = counts.attn_decode(args[3], H, Hkv, Dh, kw.get("window"))
        flops, nbytes = flops + f, nbytes + b
    return counts.roofline_share(flops, nbytes, secs, run["peak"])
