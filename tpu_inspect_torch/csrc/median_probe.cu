// median_probe (kernel L): kernel B's median residual in one of the walk's
// ablation modes, for the sweep of the median-probe tool
// (tpu_inspect_torch/tools/median_probe.py), on Hopper (sm_90a).
//
// Replaces tools/median_probe.py: probe, the TPU's ablation probe of its
// median-residual kernel, whose modes strip one piece of the TPU's row
// loop each (histogram update, query mask, band matmul) to attribute its
// time. Here the kernel is B's own (median_hist.cuh:
// median_residual_kernel): its body, its grid of one warp per 32 columns
// and one strip of S ROI rows per block, its 16-bit bins, its zeros
// outside [row_lo, row_hi). Each mode
// strips one piece of the sliding-histogram walk that B and H run
// (median_hist.cuh: Mode):
//   0 baseline  nothing: B's kernel, bit-exact against B's plain version
//               at every strip;
//   1 nowarm    the warm-up rows: each strip starts from zeroed bins;
//   2 noupdate  the step down: every row queries the warm-up's bins;
//   3 noatomic  the shared atomics: plain load-add-store bin updates,
//               racing between the two threads of a word;
//   4 noquery   the band query: the median emitted from registers.
// Modes 1-4 are wrong by construction: they are timed, never compared.
// (baseline - mode) / baseline at one S is that piece's share of B's time
// there. The JAX probe's nomatmul and nomask strip the bf16 band matmul and
// the query mask, which the walk does not have: no counterpart.
//
// What bounds it on this card: as kernel B (median_residual.cu), shared
// atomics and L1 byte reads, not device memory.

#include <cstdint>

#include <cuda_runtime.h>

#include "median_hist.cuh"

namespace {

template <int MODE>
int launch(const void* x, const void* row_lo, const void* row_hi, void* out, int U, int H,
           int W, int k, int thr, int strip, cudaStream_t stream) {
  const dim3 grid((W + mh::kThreads - 1) / mh::kThreads, (H + strip - 1) / strip, U);
  median_residual_kernel<MODE><<<grid, mh::kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const int*>(row_lo),
      static_cast<const int*>(row_hi), static_cast<uint8_t*>(out), H, W, k, thr, strip);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch, or -1 for a mode that has no
// instantiation (nothing is launched then).
extern "C" int tik_median_probe(const void* x, const void* row_lo, const void* row_hi,
                                void* out, int U, int H, int W, int k, int thr, int mode,
                                int strip, void* stream) {
  if (k < 1 || k > mh::kResidualMaxK || (k & 1) == 0 || strip < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode < mh::kBaseline || mode > mh::kNoQuery) return -1;
  if (U <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch<mh::kBaseline>(x, row_lo, row_hi, out, U, H, W, k, thr, strip, s);
    case 1: return launch<mh::kNoWarm>(x, row_lo, row_hi, out, U, H, W, k, thr, strip, s);
    case 2: return launch<mh::kNoUpdate>(x, row_lo, row_hi, out, U, H, W, k, thr, strip, s);
    case 3: return launch<mh::kNoAtomic>(x, row_lo, row_hi, out, U, H, W, k, thr, strip, s);
    case 4: return launch<mh::kNoQuery>(x, row_lo, row_hi, out, U, H, W, k, thr, strip, s);
    default: return -1;
  }
}
