"""Model FLOPs of the window over its time and the bf16 peak, per cent."""

from perfbench.harness import readers


def read(run):
    return readers.mfu(run)
