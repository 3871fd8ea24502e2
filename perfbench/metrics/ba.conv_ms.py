"""Device ms in convolution kernels per 128 edge-updates (traced passes)."""

from perfbench.harness import readers


def read(run):
    return readers.conv_ms_per_unit(run)
