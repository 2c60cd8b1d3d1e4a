"""Share of the device time of the profiled sub-window spent in work
launched inside the program's ``attn/cached`` span: the plain fp32
attention of new queries against the cache (``_cached_attention``),
which every prefill takes."""


def read(run):
    tr = run["trace"]
    if tr is None or not tr.device or tr.span_count("attn/cached") == 0:
        return None
    return 100.0 * tr.span_device_s("attn/cached") / tr.device_s
