"""Device span of dba_step per frame."""

from perfbench.harness import readers


def read(run):
    return readers.span_ms_per_unit(run, "dba")
