"""The port's count of host reads made by the dropless expert layer
(``_dropless_ffn.host_reads``) over the window, per server step."""


def read(run):
    r = run["record"]
    return r["moe_host_reads"] / len(r["steps"]) if r["steps"] else None
