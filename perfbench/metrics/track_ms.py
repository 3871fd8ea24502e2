"""ms per tracked frame: the window's time over its frames."""

from perfbench.harness import readers


def read(run):
    return readers.per_unit_ms(run)
