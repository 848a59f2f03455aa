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
// fit a TPU core's VMEM, and no table the size of the plane. Under
// 8-connectivity the fg pixels of a 2x2 block are one component, so the
// block of a component's root pixel (its label) is its own: a table of one
// 8-byte slot (area, 0xFFFFFFFF - min block rank) per 2x2 block holds every
// component, zeroed with the per-unit rows in one memset. Four launches,
// each a grid of whole CTAs striding over rows of one unit, a thread on 4
// consecutive pixels (16-byte label loads, 4-byte fg loads and mask stores
// where W % 4 == 0):
//   1. area per root slot: each thread flushes one atomic a run of one
//      label, its last run merged over the warp's lanes of the same label
//      first; a run in its component's first block row (the rows of its
//      label's block row: the minimum rank lies there) also takes an
//      atomicMax of its first pixel's inverted rank;
//   2. per slot, the key (area << 32) | inverted rank; the maximum over the
//      unit's slots, one 64-bit atomicMax a CTA;
//   3. per pixel, the winner's mask (its label is the label at the pixel of
//      the winning minimum rank, decoded from the key), with the int64
//      coordinate sums and the extents reduced per CTA before one atomic
//      each (the extents' minima as maxima of H - y and W - x, so a zeroed
//      row is the empty unit's);
//   4. per unit, the stats row.
// Every sum is an integer, so the order of the atomics cannot change the
// result. A label outside its plane sets *err = 3 (the wrapper raises).

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSeg = 4 * kThreads;  // pixels of a row a CTA takes at a time
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kCtas = 4 * 132;      // CTAs a pass aims for over the batch

// per-unit scratch row (int64), zeroed: the winner key, sx, sy, max(H - y),
// max(y + 1), max(W - x), max(x + 1), unused
enum { kKey = 0, kSx, kSy, kRowLo, kRowHi, kColLo, kColHi, kUnitCols = 8 };

__device__ inline unsigned block_rank(int y, int x, int bw) {
  return static_cast<unsigned>(((y >> 1) * bw + (x >> 1)) * 4 + (y & 1) * 2 + (x & 1));
}

// labels and fg of the 4 pixels at i (n >= 1 of them in the row), 16-/4-byte
// loads where the row start is aligned (W % 4 == 0)
__device__ inline void load4(const int* __restrict__ labels, const uint8_t* __restrict__ fg,
                             size_t i, int n, bool vec, int (&l)[4], bool (&f)[4]) {
  if (vec && n == 4) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(labels + i));
    const uchar4 b = __ldg(reinterpret_cast<const uchar4*>(fg + i));
    l[0] = a.x, l[1] = a.y, l[2] = a.z, l[3] = a.w;
    f[0] = b.x, f[1] = b.y, f[2] = b.z, f[3] = b.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[j] = false;
    l[j] = 0;
    if (j < n && fg[i + j]) {
      f[j] = true;
      l[j] = labels[i + j];
    }
  }
}

// pass 1: grid (CTAs of a unit, U), each striding over row segments
__global__ void __launch_bounds__(kThreads)
area_kernel(const int* __restrict__ labels, const uint8_t* __restrict__ fg,
            unsigned long long* __restrict__ slots, int* err, int H, int W, int vec) {
  const int u = blockIdx.y;
  const int hw = H * W;
  const int bw = (W + 1) >> 1;
  const size_t base = static_cast<size_t>(u) * hw;
  unsigned long long* uslots = slots + static_cast<size_t>(u) * ((H + 1) >> 1) * bw;
  const int segs = (W + kSeg - 1) / kSeg;
  const int lane = threadIdx.x & 31;
  // a run of label l in row y: its pixel count and first x; a label at or
  // past `pair` has its first block row (the minimum rank's) in y's
  auto flush = [&](int l, unsigned cnt, int x0, int y, int pair) {
    const int ly = l / W;
    unsigned* slot = reinterpret_cast<unsigned*>(uslots + (ly >> 1) * bw + ((l - ly * W) >> 1));
    atomicAdd(slot, cnt);
    if (l >= pair) atomicMax(slot + 1, 0xFFFFFFFFu - block_rank(y, x0, bw));
  };
  for (int item = blockIdx.x; item < H * segs; item += gridDim.x) {
    const int y = item / segs;
    const int x = (item - y * segs) * kSeg + 4 * threadIdx.x;
    const int n = max(0, min(4, W - x));
    const int pair = (y & ~1) * W;
    // a thread past the row's end loads nothing (with n == 0 left to
    // load4, nvcc 12.8 took its 16-byte branch there and read past the
    // plane)
    int l[4] = {0, 0, 0, 0};
    bool f[4] = {false, false, false, false};
    if (n > 0) load4(labels, fg, base + static_cast<size_t>(y) * W + x, n, vec, l, f);
    int cur = -1, x0 = 0;
    unsigned cnt = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int lj = -1;
      if (f[j]) {
        if (l[j] < 0 || l[j] >= hw) {
          atomicExch(err, 3);
        } else {
          lj = l[j];
        }
      }
      if (lj != cur) {
        if (cur >= 0) flush(cur, cnt, x0, y, pair);
        cur = lj;
        cnt = 0;
        x0 = x + j;
      }
      cnt += lj >= 0;
    }
    // the open run, merged over the warp's lanes of the same label (one
    // row: the lowest lane holds the run's first pixel)
    const unsigned peers = __match_any_sync(kFull, cur);
    unsigned total = 0;
    if (peers == kFull) {  // warp-uniform: one label (or none) over the warp
      total = __reduce_add_sync(kFull, cnt);
    } else {
      for (int j = 0; j < 32; ++j) {
        const unsigned cj = __shfl_sync(kFull, cnt, j);
        if ((peers >> j) & 1u) total += cj;
      }
    }
    if (cur >= 0 && lane == __ffs(peers) - 1) flush(cur, total, x0, y, pair);
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
    for (int k = 1; k < kThreads / 32; ++k) v = op(v, shared[k]);
  }
  return v;  // valid in thread 0
}

// pass 2: grid (CTAs of a unit, U) over the unit's slots
__global__ void __launch_bounds__(kThreads)
key_kernel(const unsigned long long* __restrict__ slots, long long* __restrict__ units, int nb) {
  __shared__ unsigned long long s_red[kThreads / 32];
  const int u = blockIdx.y;
  const unsigned long long* us = slots + static_cast<size_t>(u) * nb;
  unsigned long long key = 0;
  for (int b = blockIdx.x * kThreads + threadIdx.x; b < nb; b += gridDim.x * kThreads) {
    const unsigned long long s = us[b];
    const unsigned long long area = s & 0xFFFFFFFFull;
    const unsigned long long k = (area << 32) | (s >> 32);
    key = area && k > key ? k : key;
  }
  auto hi = [](unsigned long long a, unsigned long long b) { return a > b ? a : b; };
  key = block_reduce(key, hi, s_red);
  if (threadIdx.x == 0 && key != 0) {
    atomicMax(reinterpret_cast<unsigned long long*>(units + static_cast<size_t>(u) * kUnitCols + kKey),
              key);
  }
}

// pass 3: grid (CTAs of a unit, U), each striding over row segments
__global__ void __launch_bounds__(kThreads)
winner_kernel(const int* __restrict__ labels, const uint8_t* __restrict__ fg,
              uint8_t* __restrict__ mask, long long* __restrict__ units, int H, int W, int vec) {
  __shared__ long long s_red[kThreads / 32];
  const int u = blockIdx.y;
  const size_t base = static_cast<size_t>(u) * H * W;
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
    win = labels[base + static_cast<size_t>(y) * W + x];
  }
  const int segs = (W + kSeg - 1) / kSeg;
  long long sx = 0, sy = 0;
  int rlo = 0, rhi = 0, clo = 0, chi = 0;  // max(H - y), max(y + 1), max(W - x), max(x + 1)
  for (int item = blockIdx.x; item < H * segs; item += gridDim.x) {
    const int y = item / segs;
    const int x = (item - y * segs) * kSeg + 4 * threadIdx.x;
    const int n = max(0, min(4, W - x));
    if (n == 0) continue;
    const size_t i = base + static_cast<size_t>(y) * W + x;
    int l[4];
    bool f[4];
    load4(labels, fg, i, n, vec, l, f);
    uint8_t m[4];
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      m[j] = win >= 0 && f[j] && l[j] == win;
      if (m[j]) {
        ++cnt;
        sx += x + j;
        clo = max(clo, W - x - j);
        chi = max(chi, x + j + 1);
      }
    }
    if (cnt) {
      sy += static_cast<long long>(cnt) * y;
      rlo = max(rlo, H - y);
      rhi = max(rhi, y + 1);
    }
    if (vec && n == 4) {
      *reinterpret_cast<uchar4*>(mask + i) = make_uchar4(m[0], m[1], m[2], m[3]);
    } else {
      for (int j = 0; j < n; ++j) mask[i + j] = m[j];
    }
  }
  if (!__syncthreads_or(rhi > 0)) return;  // block-uniform
  auto add = [](long long a, long long b) { return a + b; };
  auto hi = [](long long a, long long b) { return a > b ? a : b; };
  sx = block_reduce(sx, add, s_red);
  sy = block_reduce(sy, add, s_red);
  const long long e0 = block_reduce(static_cast<long long>(rlo), hi, s_red);
  const long long e1 = block_reduce(static_cast<long long>(rhi), hi, s_red);
  const long long e2 = block_reduce(static_cast<long long>(clo), hi, s_red);
  const long long e3 = block_reduce(static_cast<long long>(chi), hi, s_red);
  if (threadIdx.x == 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(r + kSx), static_cast<unsigned long long>(sx));
    atomicAdd(reinterpret_cast<unsigned long long*>(r + kSy), static_cast<unsigned long long>(sy));
    atomicMax(r + kRowLo, e0);
    atomicMax(r + kRowHi, e1);
    atomicMax(r + kColLo, e2);
    atomicMax(r + kColHi, e3);
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
  s[0] = a;
  s[1] = r[kSx];
  s[2] = r[kSy];
  s[3] = a > 0;
  s[4] = H - r[kRowLo];
  s[5] = r[kRowHi];
  s[6] = W - r[kColLo];
  s[7] = r[kColHi];
}

}  // namespace

// scratch: U * 8 int64 unit rows, then U * ceil(H/2) * ceil(W/2) 8-byte
// slots (ops/cc.py: component_stats allocates it); zeroed here
extern "C" int tik_component_stats(const void* labels, const void* fg, void* mask,
                                   void* stats, void* scratch, void* err, int U, int H, int W,
                                   void* stream) {
  if (U <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const uint8_t* f = static_cast<const uint8_t*>(fg);
  long long* un = static_cast<long long*>(scratch);
  auto* slots = reinterpret_cast<unsigned long long*>(un + static_cast<size_t>(U) * kUnitCols);
  const int nb = ((H + 1) >> 1) * ((W + 1) >> 1);
  const size_t bytes = 8 * (static_cast<size_t>(U) * kUnitCols + static_cast<size_t>(U) * nb);
  cudaError_t rc = cudaMemsetAsync(scratch, 0, bytes, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int vec = (W % 4 == 0) && (reinterpret_cast<uintptr_t>(labels) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(fg) & 3) == 0 &&
                  (reinterpret_cast<uintptr_t>(mask) & 3) == 0;
  const int segs = (W + kSeg - 1) / kSeg;
  const int per_unit = std::max(1, std::min((kCtas + U - 1) / U, H * segs));
  const dim3 pix_grid(per_unit, U);
  area_kernel<<<pix_grid, kThreads, 0, s>>>(lab, f, slots, static_cast<int*>(err), H, W, vec);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  const dim3 key_grid(std::max(1, std::min((kCtas + U - 1) / U, (nb + kThreads - 1) / kThreads)),
                      U);
  key_kernel<<<key_grid, kThreads, 0, s>>>(slots, un, nb);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  winner_kernel<<<pix_grid, kThreads, 0, s>>>(lab, f, static_cast<uint8_t*>(mask), un, H, W, vec);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  finish_kernel<<<(U + 127) / 128, 128, 0, s>>>(un, static_cast<long long*>(stats), U, H, W);
  return static_cast<int>(cudaGetLastError());
}
