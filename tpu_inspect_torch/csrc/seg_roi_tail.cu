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
// as for kernel A, the sequential depth of the CTA's passes and the 48 of
// 132 SMs one CTA a unit occupies. Design: kernel A's (seg_tail.cu): one
// CTA of 1024 threads per unit, the unit's bit planes and block-grid
// parents in the CTA's shared memory (a global scratch for units too large
// for it), the morphology by doubling, the border flood by carry
// propagation and column scans, the labeling by union-find. The TPU
// kernel's two-unit lane pairing and its gap lanes, the reach limit that
// pairing imposes (erode_px <= 8, morph <= 9) and the [hp, wsp] padding have
// no counterpart: any stage program runs on one unit's own plane.

#include <cstdint>

#include <cuda_runtime.h>

#include "planes.cuh"
#include "tail.cuh"

namespace {

constexpr int kThreads = 1024;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
seg_roi_tail_kernel(const uint8_t* __restrict__ x, const int* __restrict__ thr,
                    const int* __restrict__ prog, const int* __restrict__ roi_prog,
                    const uint8_t* __restrict__ zone, uint8_t* __restrict__ seg_out,
                    int* __restrict__ seg_stats, uint8_t* __restrict__ roi_out,
                    int* __restrict__ roi_stats, uint32_t* scratch, int* err, int H, int W) {
  extern __shared__ uint32_t smem[];
  __shared__ tik::TailShared s;
  const int u = blockIdx.x;
  const tik::Bits g = tik::bits_of(H, W);
  const size_t hw = static_cast<size_t>(H) * W;
  uint32_t* base =
      kShared ? smem : scratch + static_cast<size_t>(u) * tik::tail_unit_words(H, W);
  uint32_t* P[tik::kTailPlanes];
  for (int i = 0; i < tik::kTailPlanes; ++i) P[i] = base + static_cast<size_t>(i) * g.n;
  int* par = reinterpret_cast<int*>(base + static_cast<size_t>(tik::kTailPlanes) * g.n);

  // seg head: fused THRESH_BINARY_INV, then the stage chain and hole fill
  const uint8_t* xin = x + static_cast<size_t>(u) * hw;
  const int t = thr[u];
  tik::pack(P[0], g, [&](int i) { return static_cast<int>(xin[i]) <= t; });
  __syncthreads();
  uint32_t* m = tik::apply_stages(prog, P[0], P[1], P[2], P[3], P[4], g);
  uint32_t* other = (m == P[0]) ? P[1] : P[0];
  tik::exterior(m, other, P[2], P[3], P[4], g);
  for (int w = threadIdx.x; w < g.n; w += blockDim.x) {
    m[w] |= ~other[w] & tik::word_mask(g, w % g.WW);
  }
  __syncthreads();

  // seg stats from the PRE-zone plane (the alignment anchors)
  tik::largest_tail<kShared>(m, other, par, nullptr, seg_stats + 8 * u, g, false, &s, err);

  // the zone, then the seg mask out; the ROI chain reads the post-zone plane
  if (zone) {
    tik::pack(other, g, [&](int i) { return zone[i] != 0; });
    __syncthreads();
    for (int w = threadIdx.x; w < g.n; w += blockDim.x) m[w] &= ~other[w];
    __syncthreads();
  }
  tik::unpack(m, seg_out + static_cast<size_t>(u) * hw, g);
  uint32_t* r = tik::apply_stages(roi_prog, m, other, P[2], P[3], P[4], g);
  tik::largest_tail<kShared>(r, r == m ? other : m, par, roi_out + static_cast<size_t>(u) * hw,
                             roi_stats + 8 * u, g, true, &s, err);
}

}  // namespace

// scratch: U * tail_unit_words(H, W) words, used only when a unit's layout
// does not fit a block's shared memory (scratch_words says how many the
// caller allocated); err: one int32, set by a root walk past its bound
extern "C" int tik_seg_roi_tail(const void* x, const void* thr, const void* prog,
                                const void* roi_prog, const void* zone, void* seg_out,
                                void* seg_stats, void* roi_out, void* roi_stats, void* scratch,
                                long long scratch_words, void* err, int U, int H, int W,
                                void* stream) {
  if (U <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  const long long words = tik::tail_unit_words(H, W);
  const size_t smem = static_cast<size_t>(words) * 4;
  int dev = 0;
  int optin = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const auto* in = static_cast<const uint8_t*>(x);
  const auto* th = static_cast<const int*>(thr);
  const auto* pr = static_cast<const int*>(prog);
  const auto* rp = static_cast<const int*>(roi_prog);
  const auto* z = static_cast<const uint8_t*>(zone);
  auto* so = static_cast<uint8_t*>(seg_out);
  auto* ss = static_cast<int*>(seg_stats);
  auto* ro = static_cast<uint8_t*>(roi_out);
  auto* rs = static_cast<int*>(roi_stats);
  auto* sc = static_cast<uint32_t*>(scratch);
  auto* e = static_cast<int*>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem + 256 <= static_cast<size_t>(optin)) {
    rc = cudaFuncSetAttribute(seg_roi_tail_kernel<true>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    seg_roi_tail_kernel<true><<<U, kThreads, smem, s>>>(in, th, pr, rp, z, so, ss, ro, rs, sc,
                                                        e, H, W);
  } else {
    if (scratch_words < words * U) return static_cast<int>(cudaErrorInvalidValue);
    seg_roi_tail_kernel<false><<<U, kThreads, 0, s>>>(in, th, pr, rp, z, so, ss, ro, rs, sc, e,
                                                      H, W);
  }
  return static_cast<int>(cudaGetLastError());
}
