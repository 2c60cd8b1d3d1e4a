"""Device milliseconds a step inside the optimizer's step (AdamW's
update of every leaf), from the profiled sub-window."""


def read(run):
    tr, n = run["trace"], len(run["record"]["profiled_batches"])
    if tr is None or n == 0 or not tr.device:
        return None
    return tr.span_device_s("bench.adamw") / n * 1e3
