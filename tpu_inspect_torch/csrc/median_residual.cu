// median_residual (kernel B): 255 where |x - medianBlur_k(x)| > thr, on
// Hopper (sm_90a).
//
// Replaces tpu_inspect/ops/median_pallas.py: median_residual_mask_pallas
// (_median_residual_kernel) and median_residual_mask_tiled (the same
// function on a whole 3000x4096 plane). For odd k with k * k < 2048 (16-bit
// bins always hold k * k) and BORDER_REPLICATE, the median m of the k x k
// window of each pixel g in rows [row_lo, row_hi) of its unit is computed
// exactly and the output is |g - m| > thr: the same as the TPU kernel's two
// rank tests (m < g - thr <=> #{v <= g - thr - 1} >= rank, and m > g + thr
// <=> #{v <= g + thr} < rank, rank = (k * k + 1) / 2). The other rows of a
// unit are written 0 by the same launch (the defect path ANDs the result
// with the ROI, whose rows those are not).
//
// Design: the sliding-histogram walk of median_hist.cuh, which holds this
// kernel (kernel L launches it in ablation modes). A block is
// one warp of 32 adjacent columns of one unit (16 KB of bins: 14 blocks an
// SM), walking one strip of S ROI rows; block (x, s, u) walks rows
// row_lo + s S.. of unit u and writes the zeros of rows s S..(s + 1) S - 1
// outside [row_lo, row_hi), so the grid (ceil(H / S) strips) covers every
// row without the host reading the row bounds. S (ops/median.py:
// strip_rows) is 32 on grid units and 16 on planes above 2^20 px, the
// fastest in the rig (tools/kernel_bench.py --strips) on the H100: longer
// strips spread the k * k warm-up thinner, shorter ones fill more of the
// card, and a whole plane's ROI is a few hundred of its 3000 rows. The TPU
// kernel's bf16 band matmuls and cdf descent are dropped: integer counts.
//
// What bounds it on this card: shared-memory atomics and L1 byte reads,
// not device memory. Per output pixel at k = 21 and S = 32: 42 samples a
// step plus the 441-sample warm-up over 32 rows (about 56), each one L1
// byte read, one shared atomic and a compare-add, then 16 shared reads
// for the query; the per-pixel window design it replaced read 441 window
// bytes and made 882 compares a pixel.

#include <cstdint>

#include <cuda_runtime.h>

#include "median_hist.cuh"

extern "C" int tik_median_residual(const void* x, const void* row_lo,
                                   const void* row_hi, void* out, int U, int H,
                                   int W, int k, int thr, int strip, void* stream) {
  if (k < 1 || k > mh::kResidualMaxK || (k & 1) == 0 || strip < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (U > 0 && H > 0 && W > 0) {
    const dim3 grid((W + mh::kThreads - 1) / mh::kThreads, (H + strip - 1) / strip, U);
    median_residual_kernel<><<<grid, mh::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<const int*>(row_lo),
        static_cast<const int*>(row_hi), static_cast<uint8_t*>(out), H, W, k, thr, strip);
  }
  return static_cast<int>(cudaGetLastError());
}
