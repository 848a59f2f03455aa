// seg_roi_tail (kernel K): the chained segmentation tail, shared exclusion
// zone and defect-ROI tail of the reference capture, on Hopper (sm_90a).
//
// Replaces tpu_inspect/ops/fused_pallas.py: seg_roi_tail_paired_pallas
// (_seg_roi_paired_body). Per unit, in one CTA, with the seg mask never
// written out and read back between the two tails:
//   x <= thr -> close+open stage chain -> 4-connected border-flood hole
//   fill -> largest 8-CC stats (area, sx, sy, has_fg: the alignment
//   anchors, taken BEFORE the zone) -> AND NOT zone (one [H, W] plane shared
//   by every unit; the reference capture's shifts are all 0) -> the seg
//   mask out -> the ROI's (2n+1)^2 erode chain -> largest 8-CC mask, stats
//   row and extents.
// Kernel A's head, stage chain and border flood (planes.cuh) and its
// label/winner/stats tail (tail.cuh, the same 64-bit atomicMax tie-break)
// run twice in one launch.
//
// What bounds it on this card: not bytes (about 14.4 MB per 48-unit image:
// the gray planes in, the seg and ROI masks out, 4.3 us at 3.35 TB/s) but,
// as for kernel A, the sequential depth of the fixpoints (border flood and
// two labelings, each a few CTA-wide barriers a round) and the
// morphology's window reads. Design: one CTA of 1024 threads per unit, the
// unit's scratch planes in global memory that stay L2-resident. The TPU
// kernel's two-unit lane pairing and its gap lanes, the reach limit that
// pairing imposes (erode_px <= 8, morph <= 9) and the [hp, wsp] padding have
// no counterpart: any stage program runs on one unit's own plane.

#include <cstdint>

#include <cuda_runtime.h>

#include "planes.cuh"
#include "tail.cuh"

namespace {

__global__ void __launch_bounds__(1024)
seg_roi_tail_kernel(const uint8_t* __restrict__ x, const int* __restrict__ thr,
                    const int* __restrict__ prog, const int* __restrict__ roi_prog,
                    const uint8_t* __restrict__ zone, uint8_t* __restrict__ seg_out,
                    int* __restrict__ seg_stats, uint8_t* __restrict__ roi_out,
                    int* __restrict__ roi_stats, uint8_t* planes, int* blocks,
                    int H, int W) {
  const int u = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int HW = H * W;
  const int nb = ((H + 1) / 2) * ((W + 1) / 2);

  const uint8_t* xin = x + static_cast<size_t>(u) * HW;
  uint8_t* pa = planes + static_cast<size_t>(u) * (3 * static_cast<size_t>(HW) + nb);
  uint8_t* pb = pa + HW;
  uint8_t* pt = pb + HW;
  uint8_t* code = pt + HW;
  int* lab = blocks + static_cast<size_t>(u) * 2 * nb;
  int* area = lab + nb;
  uint8_t* so = seg_out + static_cast<size_t>(u) * HW;

  __shared__ tik::TailShared s;

  // seg head: fused THRESH_BINARY_INV, then the stage chain and hole fill
  const int t = thr[u];
  for (int i = tid; i < HW; i += nt) pa[i] = xin[i] <= t ? 255 : 0;
  __syncthreads();
  uint8_t* m = tik::apply_stages(prog, pa, pb, pt, H, W);
  tik::exterior_flood(m, pt, H, W, &s.flag);
  for (int i = tid; i < HW; i += nt) m[i] = (m[i] || !pt[i]) ? 255 : 0;
  __syncthreads();

  // seg stats from the PRE-zone plane (the alignment anchors)
  tik::largest_tail(m, code, lab, area, nullptr, seg_stats + 8 * u, H, W, false, &s);

  // the zone, then the seg mask out; the ROI chain reads the post-zone plane
  for (int i = tid; i < HW; i += nt) {
    const uint8_t v = (m[i] && !(zone && zone[i])) ? 255 : 0;
    m[i] = v;
    so[i] = v;
  }
  __syncthreads();
  uint8_t* r = tik::apply_stages(roi_prog, m, m == pa ? pb : pa, pt, H, W);
  tik::largest_tail(r, code, lab, area, roi_out + static_cast<size_t>(u) * HW,
                    roi_stats + 8 * u, H, W, true, &s);
}

}  // namespace

extern "C" int tik_seg_roi_tail(const void* x, const void* thr, const void* prog,
                                const void* roi_prog, const void* zone, void* seg_out,
                                void* seg_stats, void* roi_out, void* roi_stats,
                                void* planes, void* blocks, int U, int H, int W,
                                void* stream) {
  if (U > 0) {
    seg_roi_tail_kernel<<<U, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<const int*>(thr),
        static_cast<const int*>(prog), static_cast<const int*>(roi_prog),
        static_cast<const uint8_t*>(zone), static_cast<uint8_t*>(seg_out),
        static_cast<int*>(seg_stats), static_cast<uint8_t*>(roi_out),
        static_cast<int*>(roi_stats), static_cast<uint8_t*>(planes),
        static_cast<int*>(blocks), H, W);
  }
  return static_cast<int>(cudaGetLastError());
}
