// seg_tail: per-unit segmentation / defect-ROI tail on Hopper (sm_90a).
//
// Replaces tpu_inspect/ops/fused_pallas.py: seg_tail_pallas (and its
// lane-paired twin seg_tail_paired_pallas, routed by seg_tail_auto). Per
// unit: optional THRESH_BINARY_INV (x <= thr) or binarize (x > 0) ->
// erode/dilate stage chain (OpenCV borders) -> optional 4-connected
// border-flood hole fill -> largest 8-connected component (OpenCV's
// block-raster tie-break) -> the mask (or the largest component alone) plus
// a stats row (area, sx, sy, has_fg, row_lo, row_hi, col_lo, col_hi).
//
// What bounds it on this card: not bytes (one 100 KB plane in, one out per
// unit) but the sequential depth of the fixpoints (flood and labeling
// rounds, each a few CTA-wide barriers) and the morphology's window reads.
// Design: one CTA per unit (grid = U), 1024 threads, per-unit scratch planes
// in global memory that stay L2-resident; fixpoints are row/column run
// sweeps plus a CTA-wide "changed" flag, so they take O(#bends) rounds, not
// O(diameter); labeling runs on the 2x2 block grid (1/4 of the pixels, and
// OpenCV's tie-break order is native there); the winner is picked by one
// 64-bit atomicMax on (area << 32) | ~key (tail.cuh, shared with kernel K,
// seg_roi_tail.cu). The TPU kernel's lane pairing,
// MXU 0/1 matmuls and root-enumeration loop have no counterpart here.

#include <cstdint>

#include <cuda_runtime.h>

#include "planes.cuh"
#include "tail.cuh"

namespace {

__global__ void __launch_bounds__(1024)
seg_tail_kernel(const uint8_t* __restrict__ x, const int* __restrict__ thr,
                const int* __restrict__ prog, uint8_t* __restrict__ out,
                int* __restrict__ stats, uint8_t* planes, int* blocks, int H,
                int W, int has_thr, int fill, int out_largest) {
  const int u = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int HW = H * W;
  const int hb = (H + 1) / 2;
  const int wb = (W + 1) / 2;
  const int nb = hb * wb;

  const uint8_t* xin = x + static_cast<size_t>(u) * HW;
  uint8_t* pa = planes + static_cast<size_t>(u) * (3 * static_cast<size_t>(HW) + nb);
  uint8_t* pb = pa + HW;
  uint8_t* pt = pb + HW;
  uint8_t* code = pt + HW;
  int* lab = blocks + static_cast<size_t>(u) * 2 * nb;
  int* area = lab + nb;

  __shared__ tik::TailShared s;

  // head: fused threshold compare, or binarize to the 0/255 domain
  const int t = has_thr ? thr[u] : 0;
  for (int i = tid; i < HW; i += nt) {
    const int v = xin[i];
    const bool on = has_thr ? (v <= t) : (v > 0);
    pa[i] = on ? 255 : 0;
  }
  __syncthreads();
  uint8_t* m = tik::apply_stages(prog, pa, pb, pt, H, W);

  if (fill) {
    tik::exterior_flood(m, pt, H, W, &s.flag);
    for (int i = tid; i < HW; i += nt) m[i] = (m[i] || !pt[i]) ? 255 : 0;
    __syncthreads();
  }

  tik::largest_tail(m, code, lab, area, out + static_cast<size_t>(u) * HW,
                    stats + 8 * u, H, W, out_largest != 0, &s);
}

}  // namespace

extern "C" int tik_seg_tail(const void* x, const void* thr, const void* prog,
                            void* out, void* stats, void* planes, void* blocks,
                            int U, int H, int W, int has_thr, int fill,
                            int out_largest, void* stream) {
  if (U > 0) {
    seg_tail_kernel<<<U, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<const int*>(thr),
        static_cast<const int*>(prog), static_cast<uint8_t*>(out),
        static_cast<int*>(stats), static_cast<uint8_t*>(planes),
        static_cast<int*>(blocks), H, W, has_thr, fill, out_largest);
  }
  return static_cast<int>(cudaGetLastError());
}
