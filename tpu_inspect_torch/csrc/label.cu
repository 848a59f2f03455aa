// label: kernel E, 8-connected min-index labeling on Hopper (sm_90a).
//
// Replaces tpu_inspect/ops/cc_pallas.py: label_components_pallas
// (_label_kernel). out[u, y, x] = the linear index y0*W + x0 of the
// raster-first pixel (y0, x0) of the 8-connected component holding (y, x), or
// kBig = 2^30 on background; int32, as the TPU kernel's.
//
// What bounds it on this card: bytes (a uint8 plane in, an int32 plane out:
// 61.4 MB on a whole 3000x4096 plane, 18 us at 3.35 TB/s; 497 KB at
// 1x315x316, below a launch's own cost, so the diagnostic path is
// launch-bound). Design: the TPU kernel iterated a min-label fixpoint of
// neighbour mins and run sweeps in VMEM; here the tiled run union-find of
// uf.cuh (namespace runs), whose root is each component's smallest global
// run start, which is its raster-first pixel, gives the label directly in
// five fixed launches. This is NOT kernels A and C's 2x2-block key, which
// orders components by OpenCV's tie-break and not by the raster-first pixel.

#include <cstdint>

#include <cuda_runtime.h>

#include "uf.cuh"

// bits: U * H * ceil(W/32) uint32; parent: U * H * W int32; err: one int32,
// zeroed by the caller
extern "C" int tik_label(const void* fg, void* out, void* parent, void* bits, void* err,
                         int U, int H, int W, void* stream) {
  if (U <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  using namespace tik::runs;
  const cudaError_t rc = run<kLabel>(
      static_cast<const uint8_t*>(fg), nullptr, static_cast<uint32_t*>(bits),
      static_cast<int*>(parent), nullptr, nullptr, static_cast<int*>(out),
      static_cast<int*>(err), U, H, W, 1, static_cast<cudaStream_t>(stream));
  return static_cast<int>(rc);
}
