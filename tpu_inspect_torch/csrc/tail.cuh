// The largest-component tail shared by kernel A (seg_tail.cu) and kernel K
// (seg_roi_tail.cu), and the layout of their unit's planes.
//
// The tail labels a unit's fg bit plane on the 2x2 block grid
// (planes.cuh: label_blocks), gives each root its area as a negative
// payload in its own parent slot (-1 - area: the slot is free once every
// block points at its root), picks the largest 8-connected component with
// OpenCV's block-raster tie-break (one 64-bit atomicMax on
// (area << 32) | ~root), then one pass over the plane's words for its sums
// and extents (popcounts: a word's column sum is 32k * count + the sum of
// its bit positions) and, optionally, the output plane.
//
// Executed by ALL threads of the CTA that owns the unit (planes.cuh's rule).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "planes.cuh"

namespace tik {

// A unit's layout for kernels A and K: five bit planes (the morphology's
// input, output, column window and two doubling buffers; the flood's plane
// and its three scratch planes; the tail's plane and its output) and the
// block grid's parents, in words.
constexpr int kTailPlanes = 5;

__host__ __device__ inline long long tail_unit_words(int H, int W) {
  return static_cast<long long>(kTailPlanes) * plane_words(H, W) + block_count(H, W);
}

// The CTA's shared scalars of one tail.
struct TailShared {
  unsigned long long best;
  unsigned long long sx;
  unsigned long long sy;
  int rlo, rhi, clo, chi;
};

// m: the unit's fg bit plane; par: nb ints of scratch; bestp: a scratch
// plane. Writes the stats row st[0..7] = (area, sx, sy, has_fg, row_lo,
// row_hi, col_lo, col_hi) of the largest component, and, where o is not
// null, o = 255 on the largest component (out_largest) or on every fg
// pixel, else 0. Ends with a barrier, so m and the scratch may be rewritten
// right after.
template <bool kShared>
__device__ inline void largest_tail(const uint32_t* m, uint32_t* bestp, int* par,
                                    uint8_t* o, int* st, const Bits& g, bool out_largest,
                                    TailShared* s, int* err) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if (tid == 0) {
    s->best = 0ull;
    s->sx = 0ull;
    s->sy = 0ull;
    s->rlo = g.H;
    s->rhi = 0;
    s->clo = g.W;
    s->chi = 0;
  }
  label_blocks<kShared>(m, false, par, g, err);

  // areas: each root's slot first holds -1 - its own block's count, then
  // every other block of the component subtracts its count
  for (int b = tid; b < g.nb; b += nt) {
    const int c = code_of(m, b, false, g);
    if (c && ldp<kShared>(par + b) == b) par[b] = -1 - __popc(c);
  }
  __syncthreads();
  for (int b = tid; b < g.nb; b += nt) {
    const int c = code_of(m, b, false, g);
    if (!c) continue;
    const int v = ldp<kShared>(par + b);
    if (v >= 0) atomicSub(par + v, __popc(c));
  }
  __syncthreads();
  for (int b = tid; b < g.nb; b += nt) {
    const int v = ldp<kShared>(par + b);
    if (v < 0 && code_of(m, b, false, g)) {
      const unsigned long long key =
          (static_cast<unsigned long long>(-1 - v) << 32) |
          static_cast<unsigned long long>(0xFFFFFFFFu - static_cast<unsigned>(b));
      atomicMax(&s->best, key);
    }
  }
  __syncthreads();
  const unsigned long long best = s->best;
  const bool has = best != 0ull;
  const int root =
      has ? static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(best & 0xFFFFFFFFull)) : -1;
  const int best_area = static_cast<int>(best >> 32);

  long long sx = 0;
  long long sy = 0;
  int rlo = g.H, rhi = 0, clo = g.W, chi = 0;
  for (int w = tid; w < g.n; w += nt) {
    const int y = w / g.WW;
    const int k = w - y * g.WW;
    const uint32_t mw = m[w];
    uint32_t bm = 0;
    if (has && mw) {
      // one lookup per 2-pixel block column of the word
      uint32_t pairs = (mw | (mw >> 1)) & 0x55555555u;
      const int row0 = (y >> 1) * g.wb + 16 * k;
      while (pairs) {
        const int j = (__ffs(pairs) - 1) >> 1;
        pairs &= pairs - 1;
        if (root_of<kShared>(par, row0 + j) == root) bm |= mw & (3u << (2 * j));
      }
    }
    if (out_largest) bestp[w] = bm;
    if (bm) {
      const int cnt = __popc(bm);
      sx += static_cast<long long>(32 * k) * cnt + bit_pos_sum(bm);
      sy += static_cast<long long>(y) * cnt;
      rlo = min(rlo, y);
      rhi = max(rhi, y + 1);
      clo = min(clo, 32 * k + __ffs(bm) - 1);
      chi = max(chi, 32 * k + 32 - __clz(bm));
    }
  }
  if (sx) atomicAdd(&s->sx, static_cast<unsigned long long>(sx));
  if (sy) atomicAdd(&s->sy, static_cast<unsigned long long>(sy));
  if (rlo < g.H) atomicMin(&s->rlo, rlo);
  if (rhi > 0) atomicMax(&s->rhi, rhi);
  if (clo < g.W) atomicMin(&s->clo, clo);
  if (chi > 0) atomicMax(&s->chi, chi);
  __syncthreads();
  if (tid == 0) {
    st[0] = best_area;
    st[1] = static_cast<int>(s->sx);
    st[2] = static_cast<int>(s->sy);
    st[3] = has ? 1 : 0;
    st[4] = s->rlo;
    st[5] = s->rhi;
    st[6] = s->clo;
    st[7] = s->chi;
  }
  if (o) unpack(out_largest ? bestp : m, o, g);
  __syncthreads();  // s and the planes are read above before a later tail reuses them
}

}  // namespace tik
