"""Tokens trained by the optimizer steps of the window over the
window's seconds (the window ends when the device has finished its
last step)."""


def read(run):
    r = run["record"]
    return r["steps"] * r["tokens_per_step"] / r["window_s"]
