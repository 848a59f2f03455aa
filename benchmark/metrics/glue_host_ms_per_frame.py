"""Host milliseconds a frame of the one-capture program outside its hand
kernels' wrappers: the frame's root span (``frame.*``) less the
``kernel.*`` spans inside it (the engine's torch ops, Python and the
gather), averaged over the window's frames outside the traced slices
(``benchmark.spans``). None where the run took no spans."""

from benchmark.spans import frame_mean_ms


def read(run):
    return frame_mean_ms(run, lambda s: s["frame_ns"] - s["kernel_ns"] if "frame_ns" in s
                         else None)
