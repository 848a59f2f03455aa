// cc_stats: kernel F, the largest 8-connected component's mask and stats
// from given labels, on Hopper (sm_90a).
//
// Replaces tpu_inspect/ops/cc_pallas.py: tile_component_tables_pallas (the
// per-tile (key, fragment area, min block rank) tables of the whole-image
// largest_component_sums_tiled, cc.py:439-714) and component_stats_pallas
// (the same function on a resident plane, cc.py:368). Per unit of a
// [U, H, W] batch, given kernel E's labels (the raster-first pixel index of
// each component of fg): the component with the largest area, ties going to
// the smallest minimum OpenCV 2x2-block raster rank; its mask, and the row
// (area, sx, sy, has_fg, row_lo, row_hi, col_lo, col_hi) in int64 (sx and sy
// reach about 5e10 on a 4096x3000 plane). An empty unit gives
// (0, 0, 0, 0, H, 0, W, 0).
//
// What bounds it on this card: bytes (an int32 label plane and a uint8 fg
// plane in, a uint8 mask out: 6 bytes a pixel, 74 MB at 1x3000x4096, about
// 22 us at 3.35 TB/s), and contention: a mold mask is a few huge components,
// so per-pixel atomics would serialise on a few addresses. Design: no tiles
// and no cross-tile merge, which existed only because a whole plane does not
// fit a TPU core's VMEM. Four passes over the whole batch:
//   1. area and minimum block rank per root slot u*H*W + label: each thread
//      walks a 32-pixel row segment and flushes one atomic pair per run of
//      one label (block rank grows along a row, so a run's first pixel holds
//      its minimum); the run still open at the segment's end is merged over
//      the warp's lanes of the same slot before its atomics;
//   2. per root, a 64-bit atomicMax of (area << 32) | ~min_rank per unit,
//      reduced over the warp first;
//   3. per pixel, the winner's mask (its label is the label at the pixel of
//      the winning minimum rank, decoded from the key), with the int64
//      coordinate sums and the extents reduced per block before one atomic
//      each;
//   4. per unit, the stats row.
// Every sum is an integer, so the order of the atomics cannot change the
// result. A label outside its plane sets *err = 3 (the wrapper raises).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSeg = 32;  // pixels of a row per thread in pass 1
constexpr unsigned kFull = 0xFFFFFFFFu;

// per-unit scratch row (int64): the winner key, sx, sy, row_lo, row_hi,
// col_lo, col_hi, unused
enum { kKey = 0, kSx, kSy, kRowLo, kRowHi, kColLo, kColHi, kUnitCols = 8 };

__device__ inline unsigned block_rank(int y, int x, int bw) {
  return static_cast<unsigned>(((y >> 1) * bw + (x >> 1)) * 4 + (y & 1) * 2 + (x & 1));
}

__global__ void init_units_kernel(long long* __restrict__ units, int U, int H, int W) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= U) return;
  long long* r = units + static_cast<size_t>(u) * kUnitCols;
  r[kKey] = 0;
  r[kSx] = 0;
  r[kSy] = 0;
  r[kRowLo] = H;
  r[kRowHi] = 0;
  r[kColLo] = W;
  r[kColHi] = 0;
  r[7] = 0;
}

// pass 1: grid over row segments of all units (whole warps: every lane
// reaches the warp-wide merge)
__global__ void __launch_bounds__(kThreads)
area_kernel(const int* __restrict__ labels, const uint8_t* __restrict__ fg,
            int* __restrict__ area, unsigned* __restrict__ min_rank, int* err,
            int U, int H, int W, int segs) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int hw = H * W;
  int slot = -1;
  unsigned cnt = 0, first = 0xFFFFFFFFu;
  if (t < static_cast<long long>(U) * H * segs) {
    const int row = static_cast<int>(t / segs);  // u * H + y
    const int s = static_cast<int>(t - static_cast<long long>(row) * segs);
    const int u = row / H;
    const int y = row - u * H;
    const int base = u * hw;
    const int bw = (W + 1) / 2;
    const int x1 = min(s * kSeg + kSeg, W);
    for (int x = s * kSeg; x < x1; ++x) {
      const int i = base + y * W + x;
      int cur = -1;
      if (fg[i]) {
        const int l = labels[i];
        if (l < 0 || l >= hw) {
          atomicExch(err, 3);
        } else {
          cur = base + l;
        }
      }
      if (cur != slot) {
        if (slot >= 0) {
          atomicAdd(area + slot, static_cast<int>(cnt));
          atomicMin(min_rank + slot, first);
        }
        slot = cur;
        cnt = 0;
        first = block_rank(y, x, bw);
      }
      cnt += cur >= 0;
    }
  }
  const unsigned peers = __match_any_sync(kFull, slot);
  unsigned total = 0, low = 0xFFFFFFFFu;
  for (int j = 0; j < 32; ++j) {
    const unsigned cj = __shfl_sync(kFull, cnt, j);
    const unsigned rj = __shfl_sync(kFull, first, j);
    if ((peers >> j) & 1u) {
      total += cj;
      low = min(low, rj);
    }
  }
  const int lane = threadIdx.x & 31;
  if (slot >= 0 && lane == __ffs(peers) - 1) {
    atomicAdd(area + slot, static_cast<int>(total));
    atomicMin(min_rank + slot, low);
  }
}

// pass 2: grid (pixel blocks of a unit, U); a root is a fg pixel whose
// label is its own index
__global__ void __launch_bounds__(kThreads)
key_kernel(const int* __restrict__ labels, const uint8_t* __restrict__ fg,
           const int* __restrict__ area, const unsigned* __restrict__ min_rank,
           long long* __restrict__ units, int hw) {
  const int u = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long key = 0;
  if (p < hw) {
    const size_t i = static_cast<size_t>(u) * hw + p;
    if (fg[i] && labels[i] == p) {
      key = (static_cast<unsigned long long>(area[i]) << 32) |
            static_cast<unsigned long long>(0xFFFFFFFFu - min_rank[i]);
    }
  }
  for (int d = 16; d > 0; d >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, key, d);
    key = o > key ? o : key;
  }
  if ((threadIdx.x & 31) == 0 && key != 0) {
    atomicMax(reinterpret_cast<unsigned long long*>(units + static_cast<size_t>(u) * kUnitCols + kKey),
              key);
  }
}

template <typename T, typename Op>
__device__ inline T block_reduce(T v, Op op, T* shared) {
  for (int d = 16; d > 0; d >>= 1) v = op(v, __shfl_xor_sync(kFull, v, d));
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // shared may hold a previous reduction's values
  if ((threadIdx.x & 31) == 0) shared[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < static_cast<int>(blockDim.x >> 5); ++k) v = op(v, shared[k]);
  }
  return v;  // valid in thread 0
}

// pass 3: grid (pixel blocks of a unit, U), each thread striding over the
// unit's pixels
__global__ void __launch_bounds__(kThreads)
winner_kernel(const int* __restrict__ labels, const uint8_t* __restrict__ fg,
              uint8_t* __restrict__ mask, long long* __restrict__ units, int H, int W) {
  __shared__ long long s_red[kThreads / 32];
  const int u = blockIdx.y;
  const int hw = H * W;
  const size_t base = static_cast<size_t>(u) * hw;
  long long* r = units + static_cast<size_t>(u) * kUnitCols;
  const unsigned long long key = static_cast<unsigned long long>(r[kKey]);
  int win = -1;
  if (key != 0) {
    // the pixel of the winner's minimum block rank lies in the winner
    const unsigned rank = 0xFFFFFFFFu - static_cast<unsigned>(key & 0xFFFFFFFFull);
    const int bw = (W + 1) / 2;
    const int b = static_cast<int>(rank >> 2);
    const int y = (b / bw) * 2 + static_cast<int>((rank >> 1) & 1u);
    const int x = (b % bw) * 2 + static_cast<int>(rank & 1u);
    win = labels[base + y * W + x];
  }
  long long sx = 0, sy = 0;
  long long rlo = H, rhi = 0, clo = W, chi = 0;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < hw; p += gridDim.x * blockDim.x) {
    const size_t i = base + p;
    const bool m = win >= 0 && fg[i] && labels[i] == win;
    mask[i] = m;
    if (m) {
      const int y = p / W;
      const int x = p - y * W;
      sx += x;
      sy += y;
      rlo = min(rlo, static_cast<long long>(y));
      rhi = max(rhi, static_cast<long long>(y) + 1);
      clo = min(clo, static_cast<long long>(x));
      chi = max(chi, static_cast<long long>(x) + 1);
    }
  }
  if (win < 0) return;  // block-uniform
  auto add = [](long long a, long long b) { return a + b; };
  auto lo = [](long long a, long long b) { return a < b ? a : b; };
  auto hi = [](long long a, long long b) { return a > b ? a : b; };
  sx = block_reduce(sx, add, s_red);
  sy = block_reduce(sy, add, s_red);
  rlo = block_reduce(rlo, lo, s_red);
  rhi = block_reduce(rhi, hi, s_red);
  clo = block_reduce(clo, lo, s_red);
  chi = block_reduce(chi, hi, s_red);
  if (threadIdx.x == 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(r + kSx), static_cast<unsigned long long>(sx));
    atomicAdd(reinterpret_cast<unsigned long long*>(r + kSy), static_cast<unsigned long long>(sy));
    atomicMin(r + kRowLo, rlo);
    atomicMax(r + kRowHi, rhi);
    atomicMin(r + kColLo, clo);
    atomicMax(r + kColHi, chi);
  }
}

// pass 4: one thread per unit
__global__ void finish_kernel(const long long* __restrict__ units,
                              long long* __restrict__ stats, int U, int H, int W) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= U) return;
  const long long* r = units + static_cast<size_t>(u) * kUnitCols;
  long long* s = stats + static_cast<size_t>(u) * 8;
  const long long a = static_cast<long long>(static_cast<unsigned long long>(r[kKey]) >> 32);
  const bool has = a > 0;
  s[0] = a;
  s[1] = has ? r[kSx] : 0;
  s[2] = has ? r[kSy] : 0;
  s[3] = has;
  s[4] = has ? r[kRowLo] : H;
  s[5] = has ? r[kRowHi] : 0;
  s[6] = has ? r[kColLo] : W;
  s[7] = has ? r[kColHi] : 0;
}

}  // namespace

extern "C" int tik_component_stats(const void* labels, const void* fg, void* mask,
                                   void* stats, void* slots, void* units, void* err,
                                   int U, int H, int W, void* stream) {
  const int n = U * H * W;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const uint8_t* f = static_cast<const uint8_t*>(fg);
  int* area = static_cast<int*>(slots);
  unsigned* rank = reinterpret_cast<unsigned*>(area + n);
  long long* un = static_cast<long long*>(units);
  const int hw = H * W;
  cudaError_t rc;
  if ((rc = cudaMemsetAsync(area, 0, sizeof(int) * static_cast<size_t>(n), s)) != cudaSuccess ||
      (rc = cudaMemsetAsync(rank, 0xFF, sizeof(unsigned) * static_cast<size_t>(n), s)) !=
          cudaSuccess) {
    return static_cast<int>(rc);
  }
  init_units_kernel<<<(U + 127) / 128, 128, 0, s>>>(un, U, H, W);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  const int segs = (W + kSeg - 1) / kSeg;
  const long long nseg = static_cast<long long>(U) * H * segs;
  area_kernel<<<static_cast<int>((nseg + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      lab, f, area, rank, static_cast<int*>(err), U, H, W, segs);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  const dim3 pix_grid((hw + kThreads - 1) / kThreads, U);
  key_kernel<<<pix_grid, kThreads, 0, s>>>(lab, f, area, rank, un, hw);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  // 8 pixels a thread: enough blocks to fill the card at one whole plane
  const dim3 win_grid((hw + 8 * kThreads - 1) / (8 * kThreads), U);
  winner_kernel<<<win_grid, kThreads, 0, s>>>(lab, f, static_cast<uint8_t*>(mask), un, H, W);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  finish_kernel<<<(U + 127) / 128, 128, 0, s>>>(un, static_cast<long long*>(stats), U, H, W);
  return static_cast<int>(cudaGetLastError());
}
