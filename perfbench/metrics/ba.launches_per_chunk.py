"""Device kernels per 128 edge-updates in the traced passes."""

from perfbench.harness import readers


def read(run):
    return readers.kernels_per_unit(run)
