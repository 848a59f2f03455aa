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
// unit: 5.7 us for two calls on 48 units at 3.35 TB/s) but the sequential
// depth of the CTA's passes (barriers) and, with 48 units, the 48 of 132
// SMs one CTA a unit occupies. Design: one CTA of 1024 threads per unit;
// after the head compare every plane is binary, so the unit's planes are
// bit-packed (one bit a pixel) and live with the block grid's parents in
// the CTA's shared memory (163 KB at 315x316; planes.cuh, tail.cuh): the
// morphology is word-wide AND/OR of funnel-shifted words, O(log reach) by
// doubling; the border flood closes rows by carry propagation and columns
// by a doubling scan, O(#bends) rounds; the labeling is kernel J's
// fixed-pass union-find on the 2x2 block grid, whose depth does not grow
// with how winding a component is. A unit too large for the shared layout
// runs the same code on a global scratch (the launcher picks by size). The
// TPU kernel's lane pairing, MXU 0/1 matmuls and root-enumeration loop have
// no counterpart here.

#include <cstdint>

#include <cuda_runtime.h>

#include "planes.cuh"
#include "tail.cuh"

namespace {

constexpr int kThreads = 1024;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
seg_tail_kernel(const uint8_t* __restrict__ x, const int* __restrict__ thr,
                const int* __restrict__ prog, uint8_t* __restrict__ out,
                int* __restrict__ stats, uint32_t* scratch, int* err, int H, int W,
                int has_thr, int fill, int out_largest) {
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

  // head: fused threshold compare, or binarize
  const uint8_t* xin = x + static_cast<size_t>(u) * hw;
  const int t = has_thr ? thr[u] : 0;
  if (has_thr) {
    tik::pack(P[0], g, [&](int i) { return static_cast<int>(xin[i]) <= t; });
  } else {
    tik::pack(P[0], g, [&](int i) { return xin[i] != 0; });
  }
  __syncthreads();
  uint32_t* m = tik::apply_stages(prog, P[0], P[1], P[2], P[3], P[4], g);
  uint32_t* other = (m == P[0]) ? P[1] : P[0];

  if (fill) {
    tik::exterior(m, other, P[2], P[3], P[4], g);
    for (int w = threadIdx.x; w < g.n; w += blockDim.x) {
      m[w] |= ~other[w] & tik::word_mask(g, w % g.WW);
    }
    __syncthreads();
  }

  tik::largest_tail<kShared>(m, other, par, out + static_cast<size_t>(u) * hw, stats + 8 * u,
                             g, out_largest != 0, &s, err);
}

}  // namespace

// scratch: U * tail_unit_words(H, W) words, used only when a unit's layout
// does not fit a block's shared memory (scratch_words says how many the
// caller allocated); err: one int32, set by a root walk past its bound
extern "C" int tik_seg_tail(const void* x, const void* thr, const void* prog, void* out,
                            void* stats, void* scratch, long long scratch_words, void* err,
                            int U, int H, int W, int has_thr, int fill, int out_largest,
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
  auto* o = static_cast<uint8_t*>(out);
  auto* st = static_cast<int*>(stats);
  auto* sc = static_cast<uint32_t*>(scratch);
  auto* e = static_cast<int*>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // room for the kernel's static shared variables
  if (smem + 256 <= static_cast<size_t>(optin)) {
    rc = cudaFuncSetAttribute(seg_tail_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    seg_tail_kernel<true><<<U, kThreads, smem, s>>>(in, th, pr, o, st, sc, e, H, W, has_thr,
                                                    fill, out_largest);
  } else {
    if (scratch_words < words * U) return static_cast<int>(cudaErrorInvalidValue);
    seg_tail_kernel<false><<<U, kThreads, 0, s>>>(in, th, pr, o, st, sc, e, H, W, has_thr,
                                                  fill, out_largest);
  }
  return static_cast<int>(cudaGetLastError());
}
