// Union-find shared by kernels D (flood.cu, seeded reachability) and E
// (label.cu, min-index labels), and the find and union that kernel J
// (label_stats.cu) and kernels A, C and K (planes.cuh: label_blocks) run over
// one unit's 2x2 block grid inside one CTA.
//
// A union always hangs the larger root under the smaller (atomicMin on the
// parent slot, Playne & Hawick's lock-free union), so parent indices
// strictly decrease along every path and each component's root is its
// smallest index. Every loop is bounded by the node count; a walk or a
// union past its bound sets *err (the wrapper raises) instead of returning
// a silently wrong plane.
//
// Kernels D and E (namespace runs, below) label the ROW RUNS of a [U, H, W]
// batch, not its pixels, in five fixed launches (no fixpoint: a thin
// 8-connected curve costs nothing extra):
//
// 1. tile: one CTA per tile of TH rows x TWW words (32 px a word, TH * TWW
//    <= 256 words, TWW <= 16; a tile never crosses a unit). The domain is
//    packed into bits with a warp ballot (and written to a global bit plane
//    for the later passes); a run starts at b & ~(b << 1), the previous
//    word's last bit carried in except at the tile's first column, so runs
//    are tile-local. Runs are numbered in raster order of their start
//    pixels (a block scan of the per-word counts), the runs of adjacent
//    rows are united in shared memory (union rules below), and each run's
//    start pixel gets ONE global parent slot: the global index of its
//    tile-local root's start. As run ids follow raster order, that root is
//    the run holding the tile part's raster-first pixel.
// 2. horizontal seams: a thread per (seam between tile rows, word, bit)
//    unites the runs of the two rows by the same rules, in global memory.
// 3. vertical seams: a thread per (row, seam between tile columns) unites
//    the pairs across the seam: east, and with 8-connectivity the two
//    diagonals (which also covers the corner where four tiles meet). The
//    tile pass gives each row's last pixel before a seam a slot of its own,
//    so no pair needs a search for its run's start.
// 4. compress: a thread per bit hangs each run start directly under its
//    root (a walk that stores nothing, then one store of the final root
//    into the start's own slot) and, for D, ORs the start's seed flag into
//    the root's. Seams and compress run a thread a bit, not a word: their
//    unions and walks are chains of dependent L2 round trips, and the
//    starts of one word then run side by side.
// 5. out: a warp per 32 words of a row finds each pixel's run start by a
//    warp max-scan of the words' last starts, and writes the root's flag
//    (D) or the root minus the unit offset (E: the raster-first pixel
//    index y*W + x of the component, kBig on background).
//
// Union rules for a run A = [s, e] of row r and B = [t, f] of row r-1 in
// one tile column: they touch (8-connected) iff t <= e+1 and f >= s-1.
// Either t lies in [s, e+1], i.e. b_r[t] or b_r[t-1] (S1 = starts_{r-1} &
// (b_r | b_r << 1): unite B with the run holding t, or t-1), or s-1 lies in
// B (S2 = starts_r & (b_{r-1} << 1): unite A with the run holding s-1).
// 4-connected: S1 = starts_{r-1} & b_r, S2 = starts_r & b_{r-1}. A run's
// id (or start) at bit i of a word is the last start at or before i, so
// each union costs a popcount or a count-leading-zeros, no search.
//
// Path halving (each node a find passes hung under its grandparent) runs
// in shared and in global memory alike. It is safe beside concurrent
// unions: the store only replaces a non-root's parent with one of its
// ancestors, so indices still decrease along every path, and a union whose
// atomicMin it overwrites has seen a non-root and retries with that node's
// parent. The passes that store roots (tile's compress step, compress)
// store nothing else, so no halving store can overwrite a final root with
// an ancestor (the race an anti-diagonal staircase showed in kernel A's
// resolve).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace tik {
namespace uf {

// Parent reads bypass L1 (ld.global.cg): other threads' atomicMin links
// land in L2, and a stale L1 line would only cost extra retries. With
// kShared the parents live in the CTA's shared memory: volatile reads, so
// every step sees the other threads' links.
template <bool kShared = false>
__device__ inline int load_parent(const int* parent, int x) {
  if constexpr (kShared) {
    return *reinterpret_cast<const volatile int*>(parent + x);
  } else {
    return __ldcg(parent + x);
  }
}

template <bool kShared = false>
__device__ inline void store_parent(int* parent, int x, int v) {
  if constexpr (kShared) {
    *reinterpret_cast<volatile int*>(parent + x) = v;
  } else {
    __stcg(parent + x, v);
  }
}

// The root of x, halving the path on the way. at(i) is the address of node
// i's parent slot (a kernel whose slots are not one array passes its own:
// label_stats.cu's lie in the shared memory of several CTAs).
template <bool kShared, class At>
__device__ inline int find_root_at(At at, int x, int n, int* err) {
  int p = load_parent<kShared>(at(x), 0);
  for (int steps = 0; p != x; ++steps) {
    if (steps > n) {
      atomicExch(err, 1);
      break;
    }
    const int gp = load_parent<kShared>(at(p), 0);
    if (gp != p) {
      store_parent<kShared>(at(x), 0, gp);
      p = gp;
    }
    x = p;
    p = load_parent<kShared>(at(x), 0);
  }
  return x;
}

template <bool kShared, class At>
__device__ inline void unite_at(At at, int a, int b, int n, int* err) {
  for (int iter = 0; iter <= n; ++iter) {
    a = find_root_at<kShared>(at, a, n, err);
    b = find_root_at<kShared>(at, b, n, err);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(at(b), a);
    if (old == b) return;  // b was still a root: now hung under a
    // b had been linked to `old` meanwhile: join a with that tree too
    b = old;
  }
  atomicExch(err, 2);
}

template <bool kShared = false>
__device__ inline int find_root(int* parent, int x, int n, int* err) {
  return find_root_at<kShared>([parent](int i) { return parent + i; }, x, n, err);
}

template <bool kShared = false>
__device__ inline void unite(int* parent, int a, int b, int n, int* err) {
  unite_at<kShared>([parent](int i) { return parent + i; }, a, b, n, err);
}

}  // namespace uf

// The root of x by a walk that stores nothing (the roots must be final);
// past its bound it sets *err. at as for uf::find_root_at.
template <bool kShared, class At>
__device__ inline int root_walk_at(At at, int x, int n, int* err) {
  int p = uf::load_parent<kShared>(at(x), 0);
  for (int steps = 0; p != x; ++steps) {
    if (steps > n) {
      atomicExch(err, 1);
      break;
    }
    x = p;
    p = uf::load_parent<kShared>(at(x), 0);
  }
  return x;
}

template <bool kShared>
__device__ inline int root_walk(const int* par, int x, int n, int* err) {
  return root_walk_at<kShared>([par](int i) { return par + i; }, x, n, err);
}

namespace runs {

constexpr int kTileWords = 256;  // words a tile, at most
constexpr int kColWords = 16;    // words a tile row, at most (512 px)
constexpr int kThreads = 256;    // a tile CTA: one thread per word
constexpr int kBig = 1 << 30;

// what a tile marks as seeded: nothing (E), runs holding a seed pixel (D),
// runs on the unit's border (D's border form)
enum Mode { kLabel = 0, kSeeded = 1, kBorder = 2 };

struct Geo {
  int U, H, W;
  int WW;      // words a row
  int TWW;     // words a tile row
  int TH;      // rows a tile
  int tx, ty;  // tiles across and down a unit
};

__host__ __device__ inline Geo geo_of(int U, int H, int W) {
  Geo g;
  g.U = U;
  g.H = H;
  g.W = W;
  g.WW = (W + 31) >> 5;
  g.TWW = g.WW < kColWords ? g.WW : kColWords;
  g.TH = kTileWords / g.TWW;
  g.tx = (g.WW + g.TWW - 1) / g.TWW;
  g.ty = (H + g.TH - 1) / g.TH;
  return g;
}

// bits 0..i of a word (none for i < 0)
__device__ inline uint32_t upto(int i) { return i < 0 ? 0u : (2u << i) - 1u; }

__device__ inline uint32_t starts_of(uint32_t w, uint32_t cin) {
  return w & ~((w << 1) | cin);
}

// the position of a word's highest set bit (the word is not 0)
__device__ inline int top_bit(uint32_t m) { return 31 - __clz(m); }

// the largest v of the lanes below this one (-1 for lane 0)
__device__ inline int warp_excl_max(int v) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(~0u, v, o);
    if (lane >= o) v = max(v, t);
  }
  const int e = __shfl_up_sync(~0u, v, 1);
  return lane ? e : -1;
}

// dynamic shared memory of a tile CTA: bits, starts, seed bits, the
// per-word prefix, then per run (at most 16 a word) parent and start, and
// for D a seed flag
__host__ __device__ inline size_t tile_smem(int mode, int words) {
  const size_t runs = 16 * static_cast<size_t>(words);
  return 4 * (4 * static_cast<size_t>(words) + 1) + 8 * runs + (mode != kLabel ? runs : 0);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const uint8_t* __restrict__ dom, const uint8_t* __restrict__ seed,
            uint32_t* __restrict__ gbits, int* __restrict__ parent,
            uint8_t* __restrict__ flags, int* err, Geo g, int conn8) {
  extern __shared__ uint32_t smem[];
  __shared__ int warp_sums[kThreads / 32];
  const int per_unit = g.tx * g.ty;
  const int u = blockIdx.x / per_unit;
  const int t = blockIdx.x - u * per_unit;
  const int ty = t / g.tx;
  const int y0 = ty * g.TH;
  const int k0 = (t - ty * g.tx) * g.TWW;
  const int th = min(g.TH, g.H - y0);
  const int tww = min(g.TWW, g.WW - k0);
  const int nw = th * tww;
  const int nmax = g.TH * g.TWW;
  uint32_t* bits = smem;
  uint32_t* st = bits + nmax;
  uint32_t* sd = st + nmax;
  int* pre = reinterpret_cast<int*>(sd + nmax);
  int* par = pre + nmax + 1;
  int* gst = par + 16 * nmax;
  uint8_t* seeded = reinterpret_cast<uint8_t*>(gst + 16 * nmax);
  const int ubase = u * g.H * g.W;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  // pack: a warp per kPack words of a row, one byte a lane a word (32
  // bytes a load instruction, coalesced), the kPack loads in flight before
  // the ballots
  constexpr int kPack = 8;
  const int groups = (tww + kPack - 1) / kPack;
  for (int i = warp; i < th * groups; i += nwarps) {
    const int r = i / groups;
    const int k = (i - r * groups) * kPack;
    const int rowp = ubase + (y0 + r) * g.W;
    bool v[kPack], s[kPack];
#pragma unroll
    for (int j = 0; j < kPack; ++j) {
      const int x = ((k0 + k + j) << 5) + lane;
      v[j] = k + j < tww && x < g.W && dom[rowp + x] != 0;
      s[j] = kMode == kSeeded && v[j] && seed[rowp + x] != 0;
    }
#pragma unroll
    for (int j = 0; j < kPack; ++j) {
      const uint32_t b = __ballot_sync(~0u, v[j]);
      const uint32_t sb = __ballot_sync(~0u, s[j]);
      if (lane == 0 && k + j < tww) {
        const int w = r * tww + k + j;
        bits[w] = b;
        sd[w] = sb;
        gbits[static_cast<size_t>(u * g.H + y0 + r) * g.WW + k0 + k + j] = b;
      }
    }
  }
  __syncthreads();

  // run starts and their count, a thread per word; ids by a block scan
  const int w = threadIdx.x;
  const int r = w / tww;
  const int k = w - r * tww;
  int cnt = 0;
  uint32_t b = 0, sb = 0;
  if (w < nw) {
    b = bits[w];
    sb = starts_of(b, k ? bits[w - 1] >> 31 : 0u);
    st[w] = sb;
    cnt = __popc(sb);
  }
  int incl = cnt;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(~0u, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < nwarps ? warp_sums[lane] : 0;
    int inc = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(~0u, inc, o);
      if (lane >= o) inc += x;
    }
    if (lane < nwarps) warp_sums[lane] = inc - v;
  }
  __syncthreads();
  const int first = warp_sums[warp] + incl - cnt;
  if (w < nw) pre[w] = first;
  if (w == nw - 1) pre[nw] = first + cnt;
  if (w < nw) {
    const int rowp = ubase + (y0 + r) * g.W + ((k0 + k) << 5);
    uint32_t s = sb;
    for (int id = first; s; ++id, s &= s - 1) {
      par[id] = id;
      gst[id] = rowp + __ffs(s) - 1;
      if (kMode != kLabel) seeded[id] = 0;
    }
  }
  __syncthreads();
  const int R = pre[nw];
  // the id of the run holding bit i of word v (i = -1: the previous word's
  // last bit)
  auto run_id = [&](int v, int i) { return pre[v] + __popc(st[v] & upto(i)) - 1; };

  if (kMode == kSeeded && w < nw) {
    for (uint32_t s = sd[w]; s; s &= s - 1) seeded[run_id(w, __ffs(s) - 1)] = 1;
  }
  if (kMode == kBorder && w < nw) {
    const int y = y0 + r;
    const int kg = k0 + k;
    if (y == 0 || y == g.H - 1) {
      for (int id = first; id < first + cnt; ++id) seeded[id] = 1;
    }
    if (kg == 0 && (b & 1u)) seeded[first] = 1;
    const int i = (g.W - 1) & 31;
    if (kg == g.WW - 1 && ((b >> i) & 1u)) seeded[run_id(w, i)] = 1;
  }
  // unions of each row's runs with the row above's
  if (w < nw && r > 0) {
    const int v = w - tww;
    const uint32_t a = bits[v];
    const uint32_t sa = st[v];
    if (conn8) {
      const uint32_t bsh = (b << 1) | (k ? bits[w - 1] >> 31 : 0u);
      const uint32_t ash = (a << 1) | (k ? bits[v - 1] >> 31 : 0u);
      for (uint32_t s = sa & (b | bsh); s; s &= s - 1) {
        const int i = __ffs(s) - 1;
        const int A = ((b >> i) & 1u) ? run_id(w, i) : run_id(w, i - 1);
        uf::unite<true>(par, A, run_id(v, i), R, err);
      }
      for (uint32_t s = sb & ash; s; s &= s - 1) {
        const int i = __ffs(s) - 1;
        uf::unite<true>(par, run_id(w, i), run_id(v, i - 1), R, err);
      }
    } else {
      for (uint32_t s = sa & b; s; s &= s - 1) {
        const int i = __ffs(s) - 1;
        uf::unite<true>(par, run_id(w, i), run_id(v, i), R, err);
      }
      for (uint32_t s = sb & a; s; s &= s - 1) {
        const int i = __ffs(s) - 1;
        uf::unite<true>(par, run_id(w, i), run_id(v, i), R, err);
      }
    }
  }
  __syncthreads();
  // every run straight under its root: walks that store nothing, then only
  // final roots are stored
  for (int id = threadIdx.x; id < R; id += blockDim.x) {
    uf::store_parent<true>(par, id, root_walk<true>(par, id, R, err));
  }
  __syncthreads();
  if (kMode != kLabel) {
    for (int id = threadIdx.x; id < R; id += blockDim.x) {
      if (seeded[id]) seeded[par[id]] = 1;
    }
    __syncthreads();
  }
  for (int id = threadIdx.x; id < R; id += blockDim.x) {
    const int root = par[id];
    parent[gst[id]] = gst[root];
    if (kMode != kLabel) flags[gst[id]] = seeded[root];
  }
  // a slot for each row's last pixel too, where a tile column follows: the
  // vertical seam pass then unites that pixel itself, with no search for
  // its run's start (the slot holds the same root as the start's)
  if (k0 + tww < g.WW && w < th) {
    const int v = w * tww + tww - 1;
    if (bits[v] >> 31) {
      parent[ubase + (y0 + w) * g.W + ((k0 + tww) << 5) - 1] = gst[par[run_id(v, 31)]];
    }
  }
}

// x of the first pixel of the tile-local run holding pixel 32k + i of a
// row (set; i = -1: the previous word's last bit), whose tile column starts
// at word k0: one past the last clear bit before it, or the column's start
__device__ inline int run_start(const uint32_t* row, int k, int i, int k0) {
  uint32_t z = ~row[k] & upto(i);
  while (!z && k > k0) z = ~row[--k];
  return z ? (k << 5) + top_bit(z) + 1 : k0 << 5;
}

// a thread per (unit, seam between tile rows, word, bit): the tile pass's
// unions of the seam's two rows (S1 and S2 at this bit), in global memory.
// A thread a bit, not a word, so that the dependent L2 round trips of the
// unions of one word run side by side.
static __global__ void __launch_bounds__(256)
hseam_kernel(const uint32_t* __restrict__ gbits, int* parent, int* err, Geo g, int conn8,
             int n) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int seams = g.ty - 1;
  if (t >= 32LL * g.U * seams * g.WW) return;
  const int i = static_cast<int>(t & 31);
  int rest = static_cast<int>(t >> 5);
  const int k = rest % g.WW;
  rest /= g.WW;
  const int u = rest / seams;
  const int y = (rest - u * seams + 1) * g.TH;
  const int k0 = k - k % g.TWW;
  const uint32_t* rowb = gbits + static_cast<size_t>(u * g.H + y) * g.WW;
  const uint32_t* rowa = rowb - g.WW;
  const uint32_t b = rowb[k];
  const uint32_t a = rowa[k];
  const uint32_t bp = k > k0 ? rowb[k - 1] >> 31 : 0u;
  const uint32_t ap = k > k0 ? rowa[k - 1] >> 31 : 0u;
  const bool sb = (starts_of(b, bp) >> i) & 1u;
  const bool sa = (starts_of(a, ap) >> i) & 1u;
  if (!sa && !sb) return;
  const bool bi = (b >> i) & 1u;
  const int x = (k << 5) + i;
  const int base_b = u * g.H * g.W + y * g.W;
  const int base_a = base_b - g.W;
  if (conn8) {
    // b_r[t-1], b_{r-1}[s-1]: the bit before, within the tile column
    const bool b1 = i ? (b >> (i - 1)) & 1u : bp;
    const bool a1 = i ? (a >> (i - 1)) & 1u : ap;
    if (sa && (bi || b1)) {
      uf::unite(parent, base_b + run_start(rowb, k, bi ? i : i - 1, k0), base_a + x, n, err);
    }
    if (sb && a1) uf::unite(parent, base_b + x, base_a + run_start(rowa, k, i - 1, k0), n, err);
  } else {
    if (sa && bi) uf::unite(parent, base_b + run_start(rowb, k, i, k0), base_a + x, n, err);
    if (sb && ((a >> i) & 1u)) {
      uf::unite(parent, base_b + x, base_a + run_start(rowa, k, i, k0), n, err);
    }
  }
}

// a thread per (unit, row, seam between tile columns): the pairs across the
// seam, east and (8-connected) south-east and south-west
static __global__ void __launch_bounds__(256)
vseam_kernel(const uint32_t* __restrict__ gbits, int* parent, int* err, Geo g, int conn8,
             int n) {
  const int seams = g.tx - 1;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.U * g.H * seams) return;
  const int q = i / seams;  // u * H + y
  const int kk = (i - q * seams + 1) * g.TWW;
  const int y = q % g.H;
  const int x0 = kk << 5;
  const uint32_t* row = gbits + static_cast<size_t>(q) * g.WW;
  const int base = q * g.W;
  const bool a = row[kk - 1] >> 31;
  const bool b = row[kk] & 1u;
  // x0 starts a run; x0 - 1 has its own slot (the tile pass's last-pixel
  // slot)
  if (a && b) uf::unite(parent, base + x0 - 1, base + x0, n, err);
  if (!conn8 || y + 1 >= g.H) return;
  const uint32_t* row1 = row + g.WW;
  if (a && (row1[kk] & 1u)) uf::unite(parent, base + x0 - 1, base + g.W + x0, n, err);
  if (b && (row1[kk - 1] >> 31)) uf::unite(parent, base + x0, base + g.W + x0 - 1, n, err);
}

// a thread per (bit-plane word, byte): each run start in the byte hung
// straight under its root; with flags, its seed flag ORed into the root's.
// (A thread a word chains up to 16 walks on a thin curve's words; a thread
// a bit spends more on its index arithmetic than on the walks.)
static __global__ void __launch_bounds__(256)
compress_kernel(const uint32_t* __restrict__ gbits, int* parent, uint8_t* flags, int* err,
                Geo g, int n) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= 4LL * g.U * g.H * g.WW) return;
  const int wi = static_cast<int>(t >> 2);
  const int q = wi / g.WW;
  const int k = wi - q * g.WW;
  const uint32_t s0 = starts_of(gbits[wi], (k % g.TWW) ? gbits[wi - 1] >> 31 : 0u) &
                      (0xFFu << (8 * (t & 3)));
  const int base = q * g.W + (k << 5);
  for (uint32_t s = s0; s; s &= s - 1) {
    const int p = base + __ffs(s) - 1;
    const int root = root_walk<false>(parent, p, n, err);
    uf::store_parent<false>(parent, p, root);
    if (flags && flags[p]) flags[root] = 1;
  }
}

// a warp per (unit, row, 32 words): each pixel's run start from the last
// start at or before it (in its word, else the warp's max-scan), then its
// root's flag (D: out8) or root minus the unit's offset (E: out32)
static __global__ void __launch_bounds__(256)
out_kernel(const uint32_t* __restrict__ gbits, const int* __restrict__ parent,
           const uint8_t* __restrict__ flags, uint8_t* __restrict__ out8,
           int* __restrict__ out32, Geo g) {
  const int item = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int chunks = (g.WW + 31) >> 5;
  if (item >= g.U * g.H * chunks) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int q = item / chunks;
  const int c0 = (item - q * chunks) << 5;  // the chunk's first word
  const int k = c0 + lane;
  const uint32_t w = k < g.WW ? gbits[static_cast<size_t>(q) * g.WW + k] : 0u;
  const uint32_t wp = __shfl_up_sync(~0u, w, 1);
  const uint32_t s = starts_of(w, (lane && (k % g.TWW)) ? wp >> 31 : 0u);
  const int ex = warp_excl_max(s ? (k << 5) + top_bit(s) : -1);
  const int rowp = q * g.W;
  const int ubase = (q / g.H) * g.H * g.W;
  const int nwords = min(32, g.WW - c0);
  for (int j = 0; j < nwords; ++j) {
    const uint32_t wj = __shfl_sync(~0u, w, j);
    const uint32_t sj = __shfl_sync(~0u, s, j);
    const int ej = __shfl_sync(~0u, ex, j);
    const int x = ((c0 + j) << 5) + lane;
    if (x >= g.W) continue;
    const int p = rowp + x;
    if ((wj >> lane) & 1u) {
      const uint32_t m = sj & upto(lane);
      const int root = parent[rowp + (m ? ((c0 + j) << 5) + top_bit(m) : ej)];
      if (out8) {
        out8[p] = flags[root];
      } else {
        out32[p] = root - ubase;
      }
    } else if (out8) {
      out8[p] = 0;
    } else {
      out32[p] = kBig;
    }
  }
}

inline int blocks_for(long long threads) { return static_cast<int>((threads + 255) / 256); }

// The five launches on stream s. gbits: U * H * ceil(W/32) words; parent: U
// * H * W ints; flags: U * H * W bytes (D only). No buffer needs zeroing:
// each slot a pass reads was written by an earlier one.
template <int kMode>
inline cudaError_t run(const uint8_t* dom, const uint8_t* seed, uint32_t* gbits, int* parent,
                       uint8_t* flags, uint8_t* out8, int* out32, int* err, int U, int H,
                       int W, int conn8, cudaStream_t s) {
  const Geo g = geo_of(U, H, W);
  const int n = U * H * W;
  const size_t smem = tile_smem(kMode, g.TH * g.TWW);
  cudaError_t rc = cudaFuncSetAttribute(tile_kernel<kMode>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(smem));
  if (rc != cudaSuccess) return rc;
  tile_kernel<kMode><<<U * g.tx * g.ty, kThreads, smem, s>>>(dom, seed, gbits, parent, flags,
                                                             err, g, conn8);
  if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  const long long hbits = 32LL * U * (g.ty - 1) * g.WW;
  if (hbits > 0) {
    hseam_kernel<<<blocks_for(hbits), 256, 0, s>>>(gbits, parent, err, g, conn8, n);
    if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  }
  const long long vthreads = static_cast<long long>(U) * H * (g.tx - 1);
  if (vthreads > 0) {
    vseam_kernel<<<blocks_for(vthreads), 256, 0, s>>>(gbits, parent, err, g, conn8, n);
    if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  }
  compress_kernel<<<blocks_for(4LL * U * H * g.WW), 256, 0, s>>>(
      gbits, parent, flags, err, g, n);
  if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  const long long owarps = static_cast<long long>(U) * H * ((g.WW + 31) >> 5);
  out_kernel<<<blocks_for(32 * owarps), 256, 0, s>>>(gbits, parent, flags, out8, out32, g);
  return cudaGetLastError();
}

}  // namespace runs
}  // namespace tik
