"""Set-up: process start to the first timed step (imports, the kernel
build when it is not cached, weights, warm-up)."""


def read(run):
    return run["record"]["setup_s"]
