"""The blob filter's share of its byte roofline: the bytes of
``benchmark.roofline.blob_filter_bytes`` for each of the device slice's
frames at the peak rate, over the device time of the kernels below."""

from benchmark.roofline import blob_filter_bytes, share_pct

KERNELS = {"blob_filter_kernel"}  # kernel C, threshold and Canny forms


def read(run):
    s = run.slices.get("device")
    if not s:
        return None
    return share_pct(blob_filter_bytes(run.cfg), s.frames, s.kernel_s(KERNELS))
