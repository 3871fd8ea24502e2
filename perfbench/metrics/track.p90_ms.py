"""The 90th percentile of every track() call's latency in the window."""

from perfbench.harness import readers


def read(run):
    return readers.call_quantile_ms(run, 90)
