"""Host milliseconds a frame inside the hand kernels' wrappers: the sum of
the ``kernel.*`` spans inside the frame's root span (each from the
wrapper's first check to its launch's return: checks, output and scratch
allocation, the launch), averaged over the window's frames outside the
traced slices (``benchmark.spans``). None where the run took no spans."""

from benchmark.spans import frame_mean_ms


def read(run):
    return frame_mean_ms(run, lambda s: s.get("kernel_ns"))
