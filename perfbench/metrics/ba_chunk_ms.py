"""ms per 128 edge-updates of the global BA: window time x 128 / (edges x steps)."""

from perfbench.harness import readers


def read(run):
    return readers.per_unit_ms(run)
