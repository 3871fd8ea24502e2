"""ms per train step: the window's time over its steps."""

from perfbench.harness import readers


def read(run):
    return readers.per_unit_ms(run)
