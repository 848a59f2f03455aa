// flood: kernel D, seeded 4/8-connected reachability on Hopper (sm_90a).
//
// Replaces tpu_inspect/ops/flood_pallas.py: propagate_pallas (_flood_kernel,
// both the seeded and the in-kernel border-seed form) and, on whole planes,
// propagate_pallas_tiled / _strip_sweep. out = the pixels of `domain`
// connected to a pixel of `seed & domain` through `domain`, per unit of a
// [U, H, W] batch; with border_seed the seed is the domain on the unit's
// border, made here.
//
// What bounds it on this card: bytes (two uint8 planes in, one out: 36.9 MB
// on a whole 3000x4096 plane, 11 us at 3.35 TB/s). Design: the TPU kernel
// iterated a dilate + run-sweep fixpoint per unit in VMEM, which on a
// 1-pixel-wide diagonal Canny edge advances about one pixel per round; here
// the tiled run union-find of uf.cuh (namespace runs) resolves any shape in
// five fixed launches. The tile pass marks each tile-local component that
// holds a seed run (a run with a seed pixel; in the border form a run on
// the unit's first or last row, or holding x = 0 or x = W-1); compress ORs
// those marks into the global roots; out paints dom & flag[root].

#include <cstdint>

#include <cuda_runtime.h>

#include "uf.cuh"

// bits: U * H * ceil(W/32) uint32; parent: U * H * W int32; flags: U * H * W
// bytes; err: one int32, zeroed by the caller
extern "C" int tik_propagate(const void* seed, const void* domain, void* out,
                             void* parent, void* flags, void* bits, void* err, int U,
                             int H, int W, int conn8, int border_seed, void* stream) {
  if (U <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  using namespace tik::runs;
  const auto* dom = static_cast<const uint8_t*>(domain);
  const auto* sd = static_cast<const uint8_t*>(seed);
  auto* b = static_cast<uint32_t*>(bits);
  auto* par = static_cast<int*>(parent);
  auto* fl = static_cast<uint8_t*>(flags);
  auto* o = static_cast<uint8_t*>(out);
  auto* e = static_cast<int*>(err);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      border_seed ? run<kBorder>(dom, sd, b, par, fl, o, nullptr, e, U, H, W, conn8, s)
                  : run<kSeeded>(dom, sd, b, par, fl, o, nullptr, e, U, H, W, conn8, s);
  return static_cast<int>(rc);
}
