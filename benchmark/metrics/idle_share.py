"""Share of the profiled sub-window with nothing running on the device
(the union of device intervals, not their sum)."""


def read(run):
    tr = run["trace"]
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
