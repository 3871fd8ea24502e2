"""Device ms in convolution kernels per step (traced steps)."""

from perfbench.harness import readers


def read(run):
    return readers.conv_ms_per_unit(run)
