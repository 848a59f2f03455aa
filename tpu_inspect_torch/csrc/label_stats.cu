// label_stats: kernel J, 8-connected labeling and the largest component's
// mask and stats in one launch, on Hopper (sm_90a).
//
// Replaces tpu_inspect/ops/cc_pallas.py: largest_component_stats_pallas
// (_label_stats_kernel: the label fixpoint and the root enumeration with the
// labels VMEM-resident), reached from cc.largest_component_sums
// (cc.py:346-349). Per unit of a [U, H, W] batch: the component with the
// largest area, ties going to the smallest minimum OpenCV 2x2-block raster
// rank (cv2 numbers components by first appearance in that order); its
// mask, and the row (area, sx, sy, has_fg, row_lo, row_hi, col_lo, col_hi)
// in int64. An empty unit gives (0, 0, 0, 0, H, 0, W, 0). The result is
// exactly kernel E then kernel F (label.cu, cc_stats.cu), with no label
// plane written.
//
// What bounds it on this card: latency, not bytes (1 byte in and 1 out a
// pixel: 61 ns at 315x316 at 3.35 TB/s, far below a launch); the erosion
// preview runs one unit. Design: one unit on a thread-block CLUSTER of up to
// cmax CTAs (the wrapper's choice: more for fewer units), each owning a
// band of the unit's 2x2 block rows, so the passes run on cmax SMs, not
// one. The union-find runs on the block grid: under 8-connectivity a
// block's fg pixels are one component, so a root is its component's minimum
// block index, which is OpenCV's tie-break order. A band's slots (parent,
// area a block) live in its CTA's shared memory; another CTA reaches them
// through distributed shared memory (cluster.map_shared_rank; the owner of
// block b is b / band slots). A unit whose band slots do not fit a CTA's
// shared memory keeps them in a global scratch (in L2) instead; the code is
// the same. Passes:
//   1. pack: the band's pixel rows plus the first row below it (a halo
//      row) into bits, a thread a 32-pixel word (16- or 4-byte loads where
//      aligned); the bits are the CTA's own.
//   2. runs: a warp a block row; the block row's east-connected runs are
//      the runs of its two pixel rows' OR (a block pair joins east iff
//      pixel columns 2bx+1 and 2bx+2 hold a pixel), so each block gets its
//      run's first block as parent in one step (a warp max-scan of the
//      words' last run starts): a run is one node, no thread walks a row.
//   3. the unions inside the band, in its own shared memory: block rows by
//      and by+1 join where pixel rows 2by+1 and 2by+2 are 8-connected,
//      united at pixel-run starts only (uf.cuh's S1/S2 rules, its lock-free
//      union: atomicMin hangs the larger root under the smaller).
//   4. each run start under its band root (a walk that stores nothing, then
//      one store into its own slot: a root slot is stored only by a pass
//      that stores nothing else), then every other block under its parent's
//      (a run start's) root; each band root's area by shared atomics merged
//      over a warp's lanes of one root; parents made unit-global.
//   -- cluster barrier; from here a walk may cross CTAs --
//   5. the seams: the band's last block row with the next band's first
//      (through the halo row), united by their band roots, so no plain
//      block's slot is ever stored by another CTA.
//   6. each band root under its unit root (a walk; one store into its own
//      slot), its area added to the unit root's: one remote atomic a band
//      root, not one a block.
//   7. the winner: per CTA the largest (area << 32) | ~root of its unit
//      roots, then every CTA takes the maximum over the cluster's CTAs.
//   8. the winner's pixels as bits (a thread per block-row word: its 16
//      blocks' roots read once for both pixel rows) and the int64
//      coordinate sums and extents from popcounts and bit positions,
//      reduced per CTA and sent to the leader CTA, which writes the stats.
//   9. the mask bytes, a thread per 16 bytes of the band's rows (16-byte
//      stores; a chunk's first pixel by one division, then word shifts).
// Every sum is an integer, so the order of the atomics cannot change the
// result; a walk or union past its bound sets *err (the wrapper raises).
// Units above 2^20 px are the wrapper's to refuse.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "planes.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxCluster = 16;  // CTAs a unit at most (above 8: non-portable)
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr size_t kStaticSmem = 4096;  // kept free for the kernel's static shared variables

// A unit's split into bands of 2x2 block rows, one band a CTA.
struct Bands {
  int H, W, WW;    // the unit; 32-pixel words a row
  int hb, wb, nb;  // the block grid
  int C;           // CTAs (bands) a unit
  int BR;          // block rows a band
  int bb;          // block slots a band, BR * wb
  int rows;        // pixel rows of a band's bit plane, 2 * BR + 1 (a halo row below)
};

// cmax: the CTAs a unit may take (1 .. kMaxCluster; the wrapper's choice)
__host__ __device__ inline Bands bands_of(int H, int W, int cmax) {
  Bands g;
  g.H = H;
  g.W = W;
  g.WW = (W + 31) >> 5;
  g.hb = (H + 1) >> 1;
  g.wb = (W + 1) >> 1;
  g.nb = g.hb * g.wb;
  g.BR = (g.hb + cmax - 1) / cmax;
  g.C = (g.hb + g.BR - 1) / g.BR;  // every band holds a block row
  g.bb = g.BR * g.wb;
  g.rows = 2 * g.BR + 1;
  return g;
}

// shared memory of a CTA holding its band's slots (parents, areas) and bits
__host__ __device__ inline size_t shared_bytes(const Bands& g) {
  return 8 * static_cast<size_t>(g.bb) + 4 * static_cast<size_t>(g.rows) * g.WW;
}

// int32 words of global scratch a unit takes when its slots do not fit
__host__ __device__ inline size_t unit_scratch_words(const Bands& g) {
  return static_cast<size_t>(g.C) * (2 * static_cast<size_t>(g.bb) +
                                     static_cast<size_t>(g.rows) * g.WW);
}

// slot loads and stores (uf.cuh): volatile in shared memory, where other
// CTAs' links land, past L1 in the global scratch; rd where every store to
// the slot is behind a barrier (a plain load in shared memory: loads may
// batch)
template <bool kShared>
__device__ inline int ld(const int* p) {
  return tik::uf::load_parent<kShared>(p, 0);
}

template <bool kShared>
__device__ inline int rd(const int* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldcg(p);
  }
}

template <bool kShared>
__device__ inline void st(int* p, int v) {
  tik::uf::store_parent<kShared>(p, 0, v);
}

// This CTA's view of its unit: its own arrays and the way to any block's
// slot in its owner's.
template <bool kShared>
struct Unit {
  Bands g;
  int rank;     // this CTA's band
  int* par;     // this band's parent slots (bb)
  int* area;    // this band's area slots (bb)
  uint32_t* bits;  // this band's pixel rows, rows * WW words

  // the slot of unit-global block b in array a (par or area) of b's owner
  __device__ int* at(int* a, int b) const {
    if constexpr (kShared) {
      const int r = b / g.bb;
      int* p = a + (b - r * g.bb);
      return r == rank ? p : cg::this_cluster().map_shared_rank(p, r);
    } else {
      return a + (b - rank * g.bb);  // the bands' arrays are consecutive
    }
  }

  // uf.cuh's union and walk over the unit's slots
  __device__ void unite(int a, int b, int* err) const {
    tik::uf::unite_at<kShared>([this](int i) { return at(par, i); }, a, b, g.nb, err);
  }

  __device__ int walk(int x, int* err) const {
    return tik::root_walk_at<kShared>([this](int i) { return at(par, i); }, x, g.nb, err);
  }

  // pixel (band-local row ry, column c) of the bit rows; 0 off the plane
  __device__ uint32_t bit(int ry, int c) const {
    if (c < 0 || c >= g.W) return 0u;
    return (bits[ry * g.WW + (c >> 5)] >> (c & 31)) & 1u;
  }
};

// the nonzero bytes of the n (<= 32) pixels at src as a word: 16-byte loads
// where src is 16-byte aligned, 4-byte loads where 4-byte aligned
__device__ inline uint32_t pack_word(const uint8_t* __restrict__ src, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  uint32_t v = 0;
  if (n == 32 && (a & 15) == 0) {
    const uint4 p = __ldg(reinterpret_cast<const uint4*>(src));
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(src) + 1);
    v = tik::nz4(p.x) | tik::nz4(p.y) << 4 | tik::nz4(p.z) << 8 | tik::nz4(p.w) << 12 |
        tik::nz4(q.x) << 16 | tik::nz4(q.y) << 20 | tik::nz4(q.z) << 24 | tik::nz4(q.w) << 28;
  } else if (n == 32 && (a & 3) == 0) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
#pragma unroll
    for (int j = 0; j < 8; ++j) v |= tik::nz4(__ldg(s + j)) << (4 * j);
  } else {
    for (int j = 0; j < n; ++j) v |= static_cast<uint32_t>(src[j] != 0) << j;
  }
  return v;
}

__device__ inline unsigned long long warp_max64(unsigned long long v) {
  for (int d = 16; d > 0; d >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, v, d);
    v = o > v ? o : v;
  }
  return v;
}

template <typename T, typename Op>
__device__ inline T warp_reduce(T v, Op op) {
  for (int d = 16; d > 0; d >>= 1) v = op(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

// stats partials a CTA sends its leader: sx, sy, row_lo, row_hi, col_lo,
// col_hi
constexpr int kParts = 6;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
label_stats_kernel(const uint8_t* __restrict__ fg, uint8_t* __restrict__ mask,
                   long long* __restrict__ stats, int* __restrict__ scratch, int* err,
                   Bands g) {
  extern __shared__ __align__(16) int smem[];
  __shared__ unsigned long long s_key;    // this CTA's best key
  __shared__ unsigned long long s_best;   // the unit's
  __shared__ long long s_parts[kMaxCluster][kParts];  // the leader's: every CTA's
  __shared__ long long s_acc[kParts];     // this CTA's partials
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int u = blockIdx.x / g.C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int H = g.H, W = g.W, WW = g.WW, wb = g.wb;
  const size_t hw = static_cast<size_t>(H) * W;
  const uint8_t* f = fg + u * hw;

  Unit<kShared> un;
  un.g = g;
  un.rank = rank;
  if constexpr (kShared) {
    un.par = smem;
    un.area = smem + g.bb;
    un.bits = reinterpret_cast<uint32_t*>(smem + 2 * g.bb);
  } else {
    int* base = scratch + u * unit_scratch_words(g);
    un.par = base + rank * g.bb;
    un.area = base + g.C * g.bb + rank * g.bb;
    un.bits = reinterpret_cast<uint32_t*>(base + 2 * g.C * g.bb) +
              static_cast<size_t>(rank) * g.rows * WW;
  }
  const int b0 = rank * g.BR;               // the band's block rows [b0, b1)
  const int b1 = min(g.hb, b0 + g.BR);
  const int nbr = b1 - b0;
  const int y0 = 2 * b0;                    // its bit rows [y0, y0 + nrows)
  const int nrows = min(H, 2 * b1 + 1) - y0;
  const int nblk = nbr * wb;
  const int gb0 = b0 * wb;                  // its first block (unit-global)

  // 1. pack, and zero the area slots
  for (int w = tid; w < nrows * WW; w += kThreads) {
    const int ry = w / WW;
    const int x0 = (w - ry * WW) << 5;
    un.bits[w] = pack_word(f + static_cast<size_t>(y0 + ry) * W + x0, min(32, W - x0));
  }
  for (int l = tid; l < nblk; l += kThreads) st<kShared>(un.area + l, 0);
  if (tid == 0) {
    s_key = 0ull;
    s_acc[0] = s_acc[1] = 0;
    s_acc[2] = H;
    s_acc[3] = 0;
    s_acc[4] = W;
    s_acc[5] = 0;
  }
  __syncthreads();

  // 2. runs: a warp a block row, a lane a word (32 at a time); a block's
  // parent is the first block of its run (band-local indices until pass 5;
  // its own index when empty)
  for (int br = warp; br < nbr; br += kThreads / 32) {
    const bool two = y0 + 2 * br + 1 < H;
    int last = -1;        // the last run start (pixel column) before this chunk
    uint32_t carry = 0u;  // the previous chunk's last column bit
    for (int k0 = 0; k0 < WW; k0 += 32) {
      const int k = k0 + lane;
      uint32_t col = 0u;
      if (k < WW) {
        col = un.bits[2 * br * WW + k];
        if (two) col |= un.bits[(2 * br + 1) * WW + k];
      }
      const uint32_t prev = __shfl_up_sync(kFull, col, 1);
      const uint32_t starts = col & ~((col << 1) | ((lane ? prev : carry) >> 31));
      // the last run start before each lane's word: a warp max-scan
      const int own = starts ? (k << 5) + tik::runs::top_bit(starts) : -1;
      const int ex = max(tik::runs::warp_excl_max(own), last);
      if (k < WW) {
        const int bx0 = k << 4;
        const int n = min(16, wb - bx0);
        int* row = un.par + br * wb;
        for (int j = 0; j < n; ++j) {
          if (!((col >> (2 * j)) & 3u)) {
            st<kShared>(row + bx0 + j, br * wb + bx0 + j);
            continue;
          }
          const uint32_t m = starts & tik::runs::upto(2 * j + 1);
          const int s = m ? (k << 5) + tik::runs::top_bit(m) : ex;
          st<kShared>(row + bx0 + j, br * wb + (s >> 1));
        }
      }
      last = __shfl_sync(kFull, max(ex, own), 31);
      carry = __shfl_sync(kFull, col, 31);
    }
  }
  __syncthreads();

  // the unions of block row br of the band with br + 1 (the halo row's
  // blocks for the band's last row) at block bx: at the pixel-run starts of
  // pixel rows 2br+1 (upper) and 2br+2 (lower) in its two columns
  auto unions = [&](int br, int bx, auto&& unite) {
    const int up = 2 * br + 1, lo = 2 * br + 2;
    for (int c = 2 * bx; c <= min(2 * bx + 1, W - 1); ++c) {
      const uint32_t uc = un.bit(up, c), up1 = un.bit(up, c - 1);
      const uint32_t lc = un.bit(lo, c), lp1 = un.bit(lo, c - 1);
      // S1: a run of the upper row starts at c and touches the lower row
      if (uc && !up1 && (lc || lp1)) unite(bx, (lc ? c : c - 1) >> 1);
      // S2: a run of the lower row starts at c and touches the upper row at c-1
      if (lc && !lp1 && up1) unite((c - 1) >> 1, bx);
    }
  };

  // 3. the unions inside the band, in its own slots (uf.cuh)
  for (int l = tid; l < nblk; l += kThreads) {
    const int br = l / wb;
    if (br + 1 >= nbr) continue;
    unions(br, l - br * wb, [&](int ux, int lx) {
      tik::uf::unite<kShared>(un.par, br * wb + ux, (br + 1) * wb + lx, nblk, err);
    });
  }
  __syncthreads();

  // 4. each block under its band root. The roots are run starts and a
  // plain block's parent is always a run start (halving hangs a node under
  // its grandparent), so the run starts walk (a walk that stores nothing,
  // then one store into its own slot: a root slot is stored only by a pass
  // that stores nothing else), then every other block takes its parent's
  // root; each band root's area by shared atomics, merged over a warp's
  // lanes of one root (trip counts warp-uniform)
  auto run_start = [&](int br, int bx) {  // block (br, bx) starts a run
    const int k = bx >> 4;
    const bool two = y0 + 2 * br + 1 < H;
    auto col = [&](int kk) {
      return un.bits[2 * br * WW + kk] | (two ? un.bits[(2 * br + 1) * WW + kk] : 0u);
    };
    const uint32_t c = col(k);
    const uint32_t starts = c & ~((c << 1) | (k ? col(k - 1) >> 31 : 0u));
    return ((starts >> (2 * (bx & 15))) & 3u) != 0u;
  };
  for (int l = tid; l < nblk; l += kThreads) {
    const int br = l / wb;
    if (run_start(br, l - br * wb)) {
      st<kShared>(un.par + l, tik::root_walk<kShared>(un.par, l, nblk, err));
    }
  }
  __syncthreads();
  for (int base = 0; base < nblk; base += kThreads) {
    const int l = base + tid;
    int root = -1;
    int cnt = 0;
    if (l < nblk) {
      const int br = l / wb;
      const int bx = l - br * wb;
      cnt = un.bit(2 * br, 2 * bx) + un.bit(2 * br, 2 * bx + 1);
      if (y0 + 2 * br + 1 < H) cnt += un.bit(2 * br + 1, 2 * bx) + un.bit(2 * br + 1, 2 * bx + 1);
      if (cnt) {
        root = rd<kShared>(un.par + l);
        if (!run_start(br, bx)) {
          root = rd<kShared>(un.par + root);
          st<kShared>(un.par + l, root);
        }
      }
    }
    const unsigned peers = __match_any_sync(kFull, root);
    int total = 0;
    if (peers == kFull) {  // warp-uniform: one root (or none) over the warp
      total = __reduce_add_sync(kFull, cnt);
    } else {
      for (int j = 0; j < 32; ++j) {
        const int cj = __shfl_sync(kFull, cnt, j);
        if ((peers >> j) & 1u) total += cj;
      }
    }
    if (root >= 0 && lane == __ffs(peers) - 1) atomicAdd(un.area + root, total);
  }
  __syncthreads();
  // parents to unit-global indices
  for (int l = tid; l < nblk; l += kThreads) st<kShared>(un.par + l, rd<kShared>(un.par + l) + gb0);
  cluster.sync();

  // 5. the seams: the band's last block row with the next band's first,
  // united by their band roots (so that no walk stores into a plain block's
  // slot) through the owners' slots
  if (b1 < g.hb) {
    const int rl = gb0 + (nbr - 1) * wb;  // the last row's first block
    for (int bx = tid; bx < wb; bx += kThreads) {
      unions(nbr - 1, bx, [&](int ux, int lx) {
        un.unite(ld<kShared>(un.at(un.par, rl + ux)), ld<kShared>(un.at(un.par, rl + wb + lx)),
                 err);
      });
    }
  }
  cluster.sync();

  // 6. each band root (the blocks with an area) under its unit root (a walk
  // that stores nothing, one store into its own slot), its area added to the
  // unit root's
  for (int l = tid; l < nblk; l += kThreads) {
    const int a = ld<kShared>(un.area + l);
    if (!a) continue;
    const int r = un.walk(gb0 + l, err);
    if (r != gb0 + l) {
      st<kShared>(un.par + l, r);
      atomicAdd(un.at(un.area, r), a);
    }
  }
  cluster.sync();

  // 7. the winner: the largest area, then the smallest root
  unsigned long long key = 0ull;
  for (int l = tid; l < nblk; l += kThreads) {
    const int a = rd<kShared>(un.area + l);
    if (a && rd<kShared>(un.par + l) == gb0 + l) {
      const unsigned long long k =
          (static_cast<unsigned long long>(a) << 32) |
          static_cast<unsigned long long>(0xFFFFFFFFu - static_cast<unsigned>(gb0 + l));
      key = k > key ? k : key;
    }
  }
  key = warp_max64(key);
  if (lane == 0 && key) atomicMax(&s_key, key);
  cluster.sync();
  if (warp == 0) {
    unsigned long long k = 0ull;
    if (lane < g.C) k = *cluster.map_shared_rank(&s_key, lane);
    k = warp_max64(k);
    if (lane == 0) s_best = k;
  }
  __syncthreads();
  const unsigned long long best = s_best;
  const bool has = best != 0ull;
  const int root = has ? static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(best)) : -1;

  // 8. the winner's pixels, in place of the band's bit rows: a thread per
  // (block row, word), the word's blocks tested once for both rows (a block
  // -> its band root -> the unit root, both slots this band's; a band root
  // holds its unit root); the stats partials from the words (popcounts and
  // bit positions)
  long long sx = 0, sy = 0;
  int rlo = H, rhi = 0, clo = W, chi = 0;
  for (int w = tid; w < nbr * WW; w += kThreads) {
    const int br = w / WW;
    const int k = w - br * WW;
    uint32_t* r0 = un.bits + 2 * br * WW + k;
    const bool two = y0 + 2 * br + 1 < H;
    const uint32_t col = *r0 | (two ? r0[WW] : 0u);
    uint32_t bm = 0;
    const int bx0 = k << 4;
    for (int j = 0; j < 16 && has; ++j) {
      if (bx0 + j >= wb || !((col >> (2 * j)) & 3u)) continue;
      const int l = br * wb + bx0 + j;
      int r = rd<kShared>(un.par + l);
      if (!rd<kShared>(un.area + l)) r = rd<kShared>(un.par + r - gb0);
      if (r == root) bm |= 3u << (2 * j);
    }
    for (int q = 0; q < (two ? 2 : 1); ++q) {
      const uint32_t m = r0[q * WW] & bm;
      r0[q * WW] = m;
      if (m) {
        const int y = y0 + 2 * br + q;
        const int n = __popc(m);
        sx += static_cast<long long>(k << 5) * n + tik::bit_pos_sum(m);
        sy += static_cast<long long>(y) * n;
        rlo = min(rlo, y);
        rhi = max(rhi, y + 1);
        clo = min(clo, (k << 5) + __ffs(m) - 1);
        chi = max(chi, (k << 5) + tik::runs::top_bit(m) + 1);
      }
    }
  }
  sx = warp_reduce<long long>(sx, [](long long a, long long b) { return a + b; });
  sy = warp_reduce<long long>(sy, [](long long a, long long b) { return a + b; });
  rlo = warp_reduce<int>(rlo, [](int a, int b) { return min(a, b); });
  rhi = warp_reduce<int>(rhi, [](int a, int b) { return max(a, b); });
  clo = warp_reduce<int>(clo, [](int a, int b) { return min(a, b); });
  chi = warp_reduce<int>(chi, [](int a, int b) { return max(a, b); });
  if (lane == 0 && rhi > 0) {
    using ull = unsigned long long;
    atomicAdd(reinterpret_cast<ull*>(&s_acc[0]), static_cast<ull>(sx));
    atomicAdd(reinterpret_cast<ull*>(&s_acc[1]), static_cast<ull>(sy));
    atomicMin(&s_acc[2], static_cast<long long>(rlo));
    atomicMax(&s_acc[3], static_cast<long long>(rhi));
    atomicMin(&s_acc[4], static_cast<long long>(clo));
    atomicMax(&s_acc[5], static_cast<long long>(chi));
  }
  __syncthreads();
  if (tid < kParts) {
    // the leader's slot for this CTA's partial
    cluster.map_shared_rank(&s_parts[0][0], 0)[rank * kParts + tid] = s_acc[tid];
  }

  // 9. the mask bytes of the band's rows [y0, min(H, 2 * b1)): a thread per
  // 16 bytes (16-byte stores where aligned), its first pixel by one
  // division, its bits taken from at most a few rows' words
  const long long ub = static_cast<long long>(u) * static_cast<long long>(hw);
  const long long o0 = ub + static_cast<long long>(y0) * W;
  const long long o1 = ub + static_cast<long long>(min(H, 2 * b1)) * W;
  for (long long c0 = (o0 & ~15ll) + 16ll * tid; c0 < o1; c0 += 16ll * kThreads) {
    const int p0 = static_cast<int>((c0 < o0 ? o0 : c0) - ub);  // unit-relative
    const int pe = static_cast<int>((c0 + 16 < o1 ? c0 + 16 : o1) - ub);
    const int pos0 = static_cast<int>(ub + p0 - c0);  // p0's bit in the chunk
    uint32_t v = 0;
    int y = p0 / W;
    int x = p0 - y * W;
    for (int p = p0, pos = pos0; p < pe && has; y += 1, x = 0) {
      const int n = min(pe - p, W - x);
      const uint32_t* row = un.bits + (y - y0) * WW;
      const int kk = x >> 5, sh = x & 31;
      uint32_t word = row[kk];
      if (sh) word = __funnelshift_r(word, kk + 1 < WW ? row[kk + 1] : 0u, sh);
      v |= (word & ((1u << n) - 1u)) << pos;
      pos += n;
      p += n;
    }
    uint32_t q[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) q[t] = tik::bytes4(v >> (4 * t));
    uint8_t* m = mask + c0;
    if (pos0 == 0 && pe - p0 == 16 && (reinterpret_cast<uintptr_t>(m) & 15) == 0) {
      *reinterpret_cast<uint4*>(m) = make_uint4(q[0], q[1], q[2], q[3]);
    } else {
      for (int j = pos0; j < pos0 + pe - p0; ++j) m[j] = static_cast<uint8_t>((v >> j) & 1u);
    }
  }
  cluster.sync();
  if (rank == 0 && tid == 0) {
    long long r[kParts];
    for (int q = 0; q < kParts; ++q) r[q] = s_parts[0][q];
    for (int c = 1; c < g.C; ++c) {
      r[0] += s_parts[c][0];
      r[1] += s_parts[c][1];
      r[2] = min(r[2], s_parts[c][2]);
      r[3] = max(r[3], s_parts[c][3]);
      r[4] = min(r[4], s_parts[c][4]);
      r[5] = max(r[5], s_parts[c][5]);
    }
    long long* out = stats + static_cast<size_t>(u) * 8;
    out[0] = static_cast<long long>(best >> 32);
    out[1] = r[0];
    out[2] = r[1];
    out[3] = has;
    out[4] = r[2];
    out[5] = r[3];
    out[6] = r[4];
    out[7] = r[5];
  }
}

}  // namespace

// Once per device: the kernels' attributes (the shared memory a block may
// opt into, clusters above the portable size of 8); out[0]: that shared
// memory in bytes, out[1]: the largest cluster the launches may take (16
// where a cluster of 16 fits the card with that shared memory, else 8).
extern "C" int tik_label_stats_setup(void* out) {
  int dev = 0;
  int optin = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  const int dyn = optin - static_cast<int>(kStaticSmem);
  if (rc == cudaSuccess) {
    rc = cudaFuncSetAttribute(label_stats_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              dyn);
  }
  for (const void* k : {reinterpret_cast<const void*>(label_stats_kernel<true>),
                        reinterpret_cast<const void*>(label_stats_kernel<false>)}) {
    if (rc == cudaSuccess) {
      rc = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
  }
  int clusters = 0;
  if (rc == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kMaxCluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = dyn;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kMaxCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (cudaOccupancyMaxActiveClusters(&clusters, label_stats_kernel<true>, &cfg) != cudaSuccess) {
      clusters = 0;
      cudaGetLastError();  // a refused query only means the smaller cluster
    }
  }
  static_cast<int*>(out)[0] = optin;
  static_cast<int*>(out)[1] = clusters > 0 ? kMaxCluster : 8;
  return static_cast<int>(rc);
}

namespace {
bool fits_shared(const Bands& g, int optin) {
  return shared_bytes(g) + kStaticSmem <= static_cast<size_t>(optin);
}
}  // namespace

// *words: the int32 words of global scratch a [U, H, W] batch needs (0 when
// its bands fit shared memory)
extern "C" int tik_label_stats_scratch(int U, int H, int W, int cmax, int optin, void* words) {
  long long n = 0;
  if (U > 0 && H > 0 && W > 0) {
    const Bands g = bands_of(H, W, cmax);
    if (!fits_shared(g, optin)) n = static_cast<long long>(U) * unit_scratch_words(g);
  }
  *static_cast<long long*>(words) = n;
  return 0;
}

// One launch: a cluster of up to cmax CTAs a unit (1 <= cmax <=
// kMaxCluster). scratch as tik_label_stats_scratch says; err: one int32,
// zeroed by the caller; optin from the setup.
extern "C" int tik_label_stats(const void* fg, void* mask, void* stats, void* scratch,
                               void* err, int U, int H, int W, int cmax, int optin,
                               void* stream) {
  if (U <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  if (cmax < 1 || cmax > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  const Bands g = bands_of(H, W, cmax);
  const bool shared = fits_shared(g, optin);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(U * g.C));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = shared ? shared_bytes(g) : 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(g.C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const auto* in = static_cast<const uint8_t*>(fg);
  auto* out = static_cast<uint8_t*>(mask);
  auto* st = static_cast<long long*>(stats);
  auto* sc = static_cast<int*>(scratch);
  auto* e = static_cast<int*>(err);
  cudaError_t rc =
      shared ? cudaLaunchKernelEx(&cfg, label_stats_kernel<true>, in, out, st, sc, e, g)
             : cudaLaunchKernelEx(&cfg, label_stats_kernel<false>, in, out, st, sc, e, g);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

namespace {
__global__ void floor_kernel(uint8_t* out) { *out = 0; }
}  // namespace

// One launch of a one-thread kernel that stores one zero byte: the floor a
// one-unit launch cannot beat, timed beside J by the kernel rig.
extern "C" int tik_launch_floor(void* out, void* stream) {
  floor_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
