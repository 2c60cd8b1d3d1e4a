"""Share of the device time of the profiled sub-window spent in work
launched by the MoE feed-forward block (routing, dispatch, experts)."""


def read(run):
    tr = run["trace"]
    if tr is None or not tr.device or tr.span_count("bench.moe") == 0:
        return None
    return 100.0 * tr.span_device_s("bench.moe") / tr.device_s
