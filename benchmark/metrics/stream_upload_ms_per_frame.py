"""Host milliseconds a frame in the stream's upload: the ``stream.upload``
span (the wait for its pinned slot, the copy into it, the enqueue of the
host-to-device copy), averaged over the window's frames outside the
traced slices (``benchmark.spans``). None where the run took no spans."""

from benchmark.spans import frame_mean_ms


def read(run):
    return frame_mean_ms(run, lambda s: s.get("upload_ns"))
