"""Per cent of the traced steps' window with no device operation."""

from perfbench.harness import readers


def read(run):
    return readers.idle_share(run)
