"""Seconds from the start of the run's process to its first timed frame:
imports, the kernels' build or load, the pool of captures, the reference
capture's anchors and two passes of the program over the pool."""


def read(run):
    return run.setup_s
