"""The seg and ROI tails' share of their byte roofline: the bytes of
``benchmark.roofline.seg_tail_bytes`` for each of the device slice's
frames at the peak rate, over the device time of the kernels below."""

from benchmark.roofline import seg_tail_bytes, share_pct

KERNELS = {"seg_tail_kernel", "seg_roi_tail_kernel"}  # kernels A and K


def read(run):
    s = run.slices.get("device")
    if not s:
        return None
    return share_pct(seg_tail_bytes(run.cfg), s.frames, s.kernel_s(KERNELS))
