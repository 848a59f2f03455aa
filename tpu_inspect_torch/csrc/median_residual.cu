// median_residual: 255 where |x - medianBlur_k(x)| > thr, on Hopper (sm_90a).
//
// Replaces tpu_inspect/ops/median_pallas.py: median_residual_mask_pallas
// (_median_residual_kernel). The median value itself is never needed, only
// whether it leaves [g - thr, g + thr]: with rank = (k*k + 1) / 2,
//   median < g - thr  <=>  #{v <= g - thr - 1} >= rank
//   median > g + thr  <=>  #{v <= g + thr}     <  rank
// so each output pixel counts its k x k window twice (BORDER_REPLICATE by
// clamped loads). Rows outside [row_lo, row_hi) of a unit are written 0
// (the defect path ANDs the result with the ROI, whose rows those are not).
//
// What bounds it on this card: shared-memory reads, k*k per output pixel
// (441 for the main path's k = 21), not device memory (each input byte is
// read into shared memory about 1 + 2r/TILE_H times). Design: a thread per
// output pixel, a (TILE_H + 2r) x (TILE_W + 2r) uint8 tile per block, and
// tiles wholly outside the unit's ROI rows store zeros and stop
// (median_window.cuh, whose body kernel L's probe sweep shares). The TPU
// kernel's histogram state, bf16 band matmuls and cdf descent are dropped:
// integer counts are exact by construction.

#include <cstdint>

#include <cuda_runtime.h>

#include "median_window.cuh"

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;

__global__ void __launch_bounds__(kTileW * kTileH)
median_residual_kernel(const uint8_t* __restrict__ x,
                       const int* __restrict__ row_lo,
                       const int* __restrict__ row_hi,
                       uint8_t* __restrict__ out, int H, int W, int k, int thr) {
  tik::median_residual_tile<tik::kMedianBaseline, kTileW, kTileH>(x, row_lo, row_hi, out,
                                                                  H, W, k, thr);
}

}  // namespace

extern "C" int tik_median_residual(const void* x, const void* row_lo,
                                   const void* row_hi, void* out, int U, int H,
                                   int W, int k, int thr, void* stream) {
  if (U > 0 && H > 0 && W > 0) {
    const dim3 block(kTileW, kTileH);
    const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, U);
    median_residual_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<const int*>(row_lo),
        static_cast<const int*>(row_hi), static_cast<uint8_t*>(out), H, W, k,
        thr);
  }
  return static_cast<int>(cudaGetLastError());
}
