// The largest-component tail shared by kernel A (seg_tail.cu) and kernel K
// (seg_roi_tail.cu): label a unit's fg plane on the 2x2 block grid, pick
// the largest 8-connected component with OpenCV's block-raster tie-break
// (one 64-bit atomicMax on (area << 32) | ~root), then one pass over the
// pixels for its sums and extents and, optionally, the output plane.
//
// Executed by ALL threads of the CTA that owns the unit (planes.cuh's rule).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "planes.cuh"

namespace tik {

// The CTA's shared scalars of one tail (the fixpoints' "changed" flag too).
struct TailShared {
  int flag;
  unsigned long long best;
  unsigned long long sx;
  unsigned long long sy;
  int rlo, rhi, clo, chi;
};

// m: the unit's fg plane (any nonzero); code (nb bytes), lab and area (nb
// ints each): scratch. Writes the stats row st[0..7] = (area, sx, sy,
// has_fg, row_lo, row_hi, col_lo, col_hi) of the largest component, and,
// where o is not null, o = 255 on the largest component (out_largest) or on
// every fg pixel, else 0. Ends with a barrier, so m and the scratch may be
// rewritten right after.
__device__ inline void largest_tail(const uint8_t* __restrict__ m, uint8_t* code,
                                    int* lab, int* area, uint8_t* o, int* st,
                                    int H, int W, bool out_largest,
                                    TailShared* s) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int HW = H * W;
  const int hb = (H + 1) / 2;
  const int wb = (W + 1) / 2;
  const int nb = hb * wb;

  block_codes(m, code, H, W, wb, nb);
  for (int b = tid; b < nb; b += nt) area[b] = 0;
  if (tid == 0) {
    s->best = 0ull;
    s->sx = 0ull;
    s->sy = 0ull;
    s->rlo = H;
    s->rhi = 0;
    s->clo = W;
    s->chi = 0;
  }
  __syncthreads();
  label_blocks(code, lab, hb, wb, &s->flag);

  for (int b = tid; b < nb; b += nt) {
    const int c = code[b];
    if (c) atomicAdd(&area[lab[b]], __popc(c));
  }
  __syncthreads();
  for (int b = tid; b < nb; b += nt) {
    if (code[b] && lab[b] == b) {
      const unsigned long long key =
          (static_cast<unsigned long long>(area[b]) << 32) |
          static_cast<unsigned long long>(0xFFFFFFFFu - static_cast<unsigned>(b));
      atomicMax(&s->best, key);
    }
  }
  __syncthreads();
  const unsigned long long best = s->best;
  const bool has = best != 0ull;
  const int root =
      has ? static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(best & 0xFFFFFFFFull))
          : -1;
  const int best_area = static_cast<int>(best >> 32);

  long long sx = 0;
  long long sy = 0;
  int rlo = H, rhi = 0, clo = W, chi = 0;
  for (int i = tid; i < HW; i += nt) {
    const int y = i / W;
    const int xx = i - y * W;
    const bool fg = m[i] != 0;
    const bool in_best = fg && lab[(y >> 1) * wb + (xx >> 1)] == root;
    if (in_best) {
      sx += xx;
      sy += y;
      rlo = min(rlo, y);
      rhi = max(rhi, y + 1);
      clo = min(clo, xx);
      chi = max(chi, xx + 1);
    }
    if (o) o[i] = (out_largest ? in_best : fg) ? 255 : 0;
  }
  if (sx) atomicAdd(&s->sx, static_cast<unsigned long long>(sx));
  if (sy) atomicAdd(&s->sy, static_cast<unsigned long long>(sy));
  if (rlo < H) atomicMin(&s->rlo, rlo);
  if (rhi > 0) atomicMax(&s->rhi, rhi);
  if (clo < W) atomicMin(&s->clo, clo);
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
  __syncthreads();  // s is read above before a later tail resets it
}

}  // namespace tik
