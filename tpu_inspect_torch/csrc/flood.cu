// flood: kernel D, seeded 4/8-connected reachability on Hopper (sm_90a).
//
// Replaces tpu_inspect/ops/flood_pallas.py: propagate_pallas (_flood_kernel,
// both the seeded and the in-kernel border-seed form). out = the pixels of
// `domain` connected to a pixel of `seed & domain` through `domain`, per
// unit of a [U, H, W] batch; with border_seed the seed is the domain on the
// image border, made here.
//
// What bounds it on this card: bytes (two uint8 planes in, one out: 14.3 MB
// at 48x315x316, about 4.3 us at 3.35 TB/s) were it a single pass; the
// union passes add a 4-byte parent and a 1-byte flag per pixel and random
// atomics on the parent slots. Design: the TPU kernel iterated a dilate +
// run-sweep fixpoint per unit in VMEM, which on a 1-pixel-wide diagonal
// Canny edge advances about one pixel per round; here a union-find over all
// pixels of the batch (uf.cuh) resolves any shape in four fixed passes:
// init parents (and zero the root flags), link neighbours, resolve roots and
// flag the seeded ones, paint.

#include <cstdint>

#include <cuda_runtime.h>

#include "uf.cuh"

namespace {

using tik::uf::kThreads;

// Resolve each domain pixel's root (and store it, compressing the forest),
// and mark the roots of seeded pixels (flags were zeroed before the pass).
__global__ void __launch_bounds__(kThreads)
resolve_kernel(const uint8_t* __restrict__ seed, const uint8_t* __restrict__ dom,
               int* parent, uint8_t* flags, int* err, int H, int W, int n,
               int border_seed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !dom[i]) return;
  const int r = tik::uf::find_root(parent, i, n, err);
  parent[i] = r;
  bool seeded;
  if (border_seed) {
    const int p = i % (H * W);
    const int y = p / W;
    const int x = p - y * W;
    seeded = y == 0 || y == H - 1 || x == 0 || x == W - 1;
  } else {
    seeded = seed[i] != 0;
  }
  if (seeded) flags[r] = 1;  // every writer stores 1: a benign race
}

__global__ void __launch_bounds__(kThreads)
paint_kernel(const uint8_t* __restrict__ dom, const int* __restrict__ parent,
             const uint8_t* __restrict__ flags, uint8_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = (dom[i] && flags[parent[i]]) ? 1 : 0;
}

}  // namespace

extern "C" int tik_propagate(const void* seed, const void* domain, void* out,
                             void* parent, void* flags, void* err, int U, int H,
                             int W, int conn8, int border_seed, void* stream) {
  const int n = U * H * W;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int grid = tik::uf::grid_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* dom = static_cast<const uint8_t*>(domain);
  int* par = static_cast<int*>(parent);
  uint8_t* fl = static_cast<uint8_t*>(flags);
  int* e = static_cast<int*>(err);
  cudaError_t rc;
  if ((rc = cudaMemsetAsync(fl, 0, static_cast<size_t>(n), s)) != cudaSuccess) {
    return static_cast<int>(rc);
  }
  tik::uf::init_kernel<<<grid, kThreads, 0, s>>>(par, n);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  tik::uf::link_kernel<<<grid, kThreads, 0, s>>>(dom, par, e, H, W, n, conn8);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  resolve_kernel<<<grid, kThreads, 0, s>>>(static_cast<const uint8_t*>(seed), dom,
                                           par, fl, e, H, W, n, border_seed);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  paint_kernel<<<grid, kThreads, 0, s>>>(dom, par, fl, static_cast<uint8_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
