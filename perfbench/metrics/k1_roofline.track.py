"""K1's bound over its time, per cent, over sampled launches while tracking."""

from perfbench.harness import readers


def read(run):
    return readers.roofline_share(run, "k1")
