"""Model FLOPs (backward twice the forward) of the window over its time and the fp32 peak, per cent."""

from perfbench.harness import readers


def read(run):
    return readers.mfu(run)
