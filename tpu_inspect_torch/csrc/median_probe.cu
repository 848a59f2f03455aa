// median_probe (kernel L): the median residual in kernel B's earlier
// per-pixel window design (median_window.cuh; B itself now walks a sliding
// histogram, median_hist.cuh), templated on an ablation mode and the tile
// shape, for the sweep of the median-probe tool
// (tpu_inspect_torch/tools/median_probe.py).
//
// Replaces tools/median_probe.py: probe, the TPU's ablation probe of its
// median-residual kernel (histogram update, query mask, band matmul, output
// write). The port has none of those pieces, so the modes strip pieces of
// B's earlier per-pixel window design instead (median_window.cuh):
//   0 baseline  the whole computation, bit-exact against B's plain version
//               at every tile shape;
//   1 nofill    no global -> shared tile fill (counts read whatever the
//               shared memory holds);
//   2 nocount   no k x k count loop: the centre pixel's compare g > thr is
//               written instead;
//   3 norows    no ROI-row early exit: every row of every unit is computed.
// Modes 1-3 are wrong by construction: they are timed, never compared. The
// difference of each to the baseline attributes that design's time to
// its pieces;
// the tile shapes (TW x TH threads, one output pixel each) sweep its halo
// overhead ((TH + 2r)(TW + 2r) / (TH TW) loads a pixel) against its
// parallelism. Bound: the shared-memory reads of the count loop, not
// device memory.

#include <cstdint>

#include <cuda_runtime.h>

#include "median_window.cuh"

namespace {

template <int MODE, int TW, int TH>
__global__ void __launch_bounds__(TW * TH)
median_probe_kernel(const uint8_t* __restrict__ x, const int* __restrict__ row_lo,
                    const int* __restrict__ row_hi, uint8_t* __restrict__ out,
                    int H, int W, int k, int thr) {
  tik::median_residual_tile<MODE, TW, TH>(x, row_lo, row_hi, out, H, W, k, thr);
}

template <int MODE, int TW, int TH>
void launch(const void* x, const void* row_lo, const void* row_hi, void* out, int U,
            int H, int W, int k, int thr, cudaStream_t stream) {
  const dim3 block(TW, TH);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, U);
  median_probe_kernel<MODE, TW, TH><<<grid, block, 0, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const int*>(row_lo),
      static_cast<const int*>(row_hi), static_cast<uint8_t*>(out), H, W, k, thr);
}

template <int MODE>
bool launch_tile(int tile_w, int tile_h, const void* x, const void* row_lo,
                 const void* row_hi, void* out, int U, int H, int W, int k, int thr,
                 cudaStream_t stream) {
  if (tile_w == 32 && tile_h == 8) {
    launch<MODE, 32, 8>(x, row_lo, row_hi, out, U, H, W, k, thr, stream);
  } else if (tile_w == 32 && tile_h == 16) {
    launch<MODE, 32, 16>(x, row_lo, row_hi, out, U, H, W, k, thr, stream);
  } else if (tile_w == 64 && tile_h == 8) {
    launch<MODE, 64, 8>(x, row_lo, row_hi, out, U, H, W, k, thr, stream);
  } else if (tile_w == 16 && tile_h == 16) {
    launch<MODE, 16, 16>(x, row_lo, row_hi, out, U, H, W, k, thr, stream);
  } else {
    return false;
  }
  return true;
}

}  // namespace

// Returns cudaGetLastError() after the launch, or -1 for a mode or tile
// shape that has no instantiation (nothing is launched then).
extern "C" int tik_median_probe(const void* x, const void* row_lo, const void* row_hi,
                                void* out, int U, int H, int W, int k, int thr,
                                int mode, int tile_w, int tile_h, void* stream) {
  if (U <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (mode) {
    case 0: ok = launch_tile<0>(tile_w, tile_h, x, row_lo, row_hi, out, U, H, W, k, thr, s); break;
    case 1: ok = launch_tile<1>(tile_w, tile_h, x, row_lo, row_hi, out, U, H, W, k, thr, s); break;
    case 2: ok = launch_tile<2>(tile_w, tile_h, x, row_lo, row_hi, out, U, H, W, k, thr, s); break;
    case 3: ok = launch_tile<3>(tile_w, tile_h, x, row_lo, row_hi, out, U, H, W, k, thr, s); break;
    default: break;
  }
  return ok ? static_cast<int>(cudaGetLastError()) : -1;
}
