"""Every prompt token prefilled and every token generated in the window,
over the window's seconds."""

from perfkit.serve_stats import tokens_in_window


def read(run):
    r = run["record"]
    return tokens_in_window(r) / r["window_s"]
