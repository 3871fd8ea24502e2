"""Device kernels per frame in the traced frames."""

from perfbench.harness import readers


def read(run):
    return readers.kernels_per_unit(run)
