"""Device span of Frontend.__call__ per frame."""

from perfbench.harness import readers


def read(run):
    return readers.span_ms_per_unit(run, "frontend")
