// Kernel L's body (median_probe.cu), which instantiates it in ablation
// modes and at several tile shapes: kernel B's earlier per-pixel window
// design, one thread per output pixel of a TW x TH tile, the tile plus its
// halo in shared memory, two rank counts over the k x k window. Kernel B
// itself now runs the sliding-histogram walk of median_hist.cuh; L keeps
// this design as the baseline its ablations are measured against.
//
// With rank = (k*k + 1) / 2, the median leaves [g - thr, g + thr] iff
//   #{v <= g - thr - 1} >= rank  or  #{v <= g + thr} < rank,
// so the median itself is never formed. Rows outside [row_lo, row_hi) of a
// unit are written 0.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace tik {

constexpr int kMedianMaxR = 22;  // k <= 45 (k*k < 2048), the wrappers' bound

// kMedianBaseline is the full computation. The others are kernel L's
// ablations, wrong by construction (timed, never compared):
//   kMedianNoFill   no global -> shared tile fill;
//   kMedianNoCount  no k x k count loop: the centre compare g > thr;
//   kMedianNoRows   no ROI-row early exit: every row is computed.
enum MedianMode { kMedianBaseline = 0, kMedianNoFill, kMedianNoCount, kMedianNoRows };

// Called by every thread of a (TW, TH) block; block (x, y, u) covers
// columns x * TW.., rows y * TH.. of unit u.
template <int MODE, int TW, int TH>
__device__ __forceinline__ void median_residual_tile(
    const uint8_t* __restrict__ x, const int* __restrict__ row_lo,
    const int* __restrict__ row_hi, uint8_t* __restrict__ out, int H, int W, int k,
    int thr) {
  __shared__ uint8_t tile[(TH + 2 * kMedianMaxR) * (TW + 2 * kMedianMaxR)];
  const int u = blockIdx.z;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int gx = x0 + tx;
  const int gy = y0 + ty;
  const size_t off = static_cast<size_t>(u) * H * W;
  const uint8_t* img = x + off;
  uint8_t* o = out + off;
  const int lo = MODE == kMedianNoRows ? 0 : row_lo[u];
  const int hi = MODE == kMedianNoRows ? H : row_hi[u];
  const bool inside = gx < W && gy < H;

  if (y0 + TH <= lo || y0 >= hi) {  // block-uniform: no ROI row here
    if (inside) o[gy * W + gx] = 0;
    return;
  }
  const int r = k / 2;
  const int tw = TW + 2 * r;
  const int th = TH + 2 * r;
  if (MODE != kMedianNoFill) {
    // BORDER_REPLICATE by clamped loads
    for (int j = ty * TW + tx; j < th * tw; j += TW * TH) {
      const int jy = j / tw;
      const int jx = j - jy * tw;
      const int yy = min(max(y0 - r + jy, 0), H - 1);
      const int xx = min(max(x0 - r + jx, 0), W - 1);
      tile[j] = img[yy * W + xx];
    }
  }
  __syncthreads();
  if (!inside) return;
  if (gy < lo || gy >= hi) {
    o[gy * W + gx] = 0;
    return;
  }
  const int g = tile[(ty + r) * tw + tx + r];
  if (MODE == kMedianNoCount) {
    o[gy * W + gx] = g > thr ? 255 : 0;
    return;
  }
  const int t_lo = g - thr - 1;
  const int t_hi = g + thr;
  int c_lo = 0;
  int c_hi = 0;
  for (int dy = 0; dy < k; ++dy) {
    const uint8_t* row = tile + (ty + dy) * tw + tx;
    for (int dx = 0; dx < k; ++dx) {
      const int v = row[dx];
      c_lo += v <= t_lo;
      c_hi += v <= t_hi;
    }
  }
  const int rank = (k * k + 1) / 2;
  o[gy * W + gx] = (c_lo >= rank || c_hi < rank) ? 255 : 0;
}

}  // namespace tik
