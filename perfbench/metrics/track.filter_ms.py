"""Device span of MotionFilter.track per frame."""

from perfbench.harness import readers


def read(run):
    return readers.span_ms_per_unit(run, "filter")
