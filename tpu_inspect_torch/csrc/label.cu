// label: kernel E, 8-connected min-index labeling on Hopper (sm_90a).
//
// Replaces tpu_inspect/ops/cc_pallas.py: label_components_pallas
// (_label_kernel). out[u, y, x] = the linear index y0*W + x0 of the
// raster-first pixel (y0, x0) of the 8-connected component holding (y, x), or
// kBig = 2^30 on background; int32, as the TPU kernel's.
//
// What bounds it on this card: bytes (a uint8 plane in, an int32 plane out:
// 99.5 KB + 398 KB at 1x315x316, far below a launch's own cost, so it is
// launch-bound on the diagnostic path). Design: the TPU kernel iterated a
// min-label fixpoint of neighbour mins and run sweeps in VMEM; here the
// union-find of uf.cuh, whose root is each component's smallest global
// index, gives the label directly in three fixed passes (init, link,
// resolve). This is NOT kernels A and C's 2x2-block key, which orders
// components by OpenCV's tie-break and not by the raster-first pixel.

#include <cstdint>

#include <cuda_runtime.h>

#include "uf.cuh"

namespace {

using tik::uf::kThreads;

constexpr int kBig = 1 << 30;

__global__ void __launch_bounds__(kThreads)
resolve_label_kernel(const uint8_t* __restrict__ fg, int* parent,
                     int* __restrict__ out, int* err, int hw, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!fg[i]) {
    out[i] = kBig;
    return;
  }
  const int r = tik::uf::find_root(parent, i, n, err);
  parent[i] = r;
  out[i] = r - (i / hw) * hw;  // the root lies in i's own unit
}

}  // namespace

extern "C" int tik_label(const void* fg, void* out, void* parent, void* err,
                         int U, int H, int W, void* stream) {
  const int n = U * H * W;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int grid = tik::uf::grid_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* f = static_cast<const uint8_t*>(fg);
  int* par = static_cast<int*>(parent);
  int* e = static_cast<int*>(err);
  cudaError_t rc;
  tik::uf::init_kernel<<<grid, kThreads, 0, s>>>(par, n);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  tik::uf::link_kernel<<<grid, kThreads, 0, s>>>(f, par, e, H, W, n, 1);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  resolve_label_kernel<<<grid, kThreads, 0, s>>>(f, par, static_cast<int*>(out), e,
                                                 H * W, n);
  return static_cast<int>(cudaGetLastError());
}
