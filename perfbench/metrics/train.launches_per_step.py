"""Device kernels per step in the traced steps."""

from perfbench.harness import readers


def read(run):
    return readers.kernels_per_unit(run)
