"""The whole-image route's hand kernels' share of their byte roofline: the
bytes of the seg tail, the ROI tail and the blob filter
(``benchmark.roofline.seg_tail_bytes`` + ``blob_filter_bytes``, the
functions the grid's two shares count) for each of the device slice's
frames at the peak rate, over the device time of the kernels that compute
those functions on the route: I, D and E, F, G."""

from benchmark.roofline import blob_filter_bytes, seg_tail_bytes, share_pct

KERNELS = {
    "morph_chain_kernel",  # I
    "tile_kernel", "hseam_kernel", "vseam_kernel", "compress_kernel", "out_kernel",  # D, E
    "key_kernel", "winner_kernel", "area_kernel", "finish_kernel",  # F
    "sum_kernel", "paint_kernel",  # G
}


def read(run):
    s = run.slices.get("device")
    if not s:
        return None
    return share_pct(seg_tail_bytes(run.cfg) + blob_filter_bytes(run.cfg), s.frames,
                     s.kernel_s(KERNELS))
