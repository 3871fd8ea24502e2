"""Seconds from process start to the window's start: loading, rendering,
weights, warm-up (and, in a checkout's first run, the kernels' build)."""


def read(run):
    return run.setup_s
