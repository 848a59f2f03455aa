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
// pixel: 61 ns at 315x316 at 3.35 TB/s, far below a launch). Design: one
// CTA of 1024 threads per unit. The union-find (uf.cuh's lock-free union,
// which hangs the larger root under the smaller) runs on the unit's 2x2
// block grid (planes.cuh: block_codes and the block graph's edges): under
// 8-connectivity a block's fg pixels are one component, so a root is its
// component's minimum block index, which is OpenCV's tie-break order. The
// parents, per-root areas and block codes take 9 bytes a block and sit in
// shared memory (225 KB at 315x316); a unit too large for that uses a
// global scratch, which stays in L2. Passes, with __syncthreads between:
// codes; each block row's east-connected runs hung under their first block
// (plain stores, a thread per row); the south and diagonal unions (the
// root walks halve their paths in shared memory); resolve (each block to
// its root) with each root's area by atomicAdd; the winner by one 64-bit
// atomicMax on (area << 32) | ~root; then the mask and the int64
// coordinate sums and extents. Units above
// 2^20 px are the wrapper's to refuse. Every sum is an integer, so the
// order of the atomics cannot change the result; a root walk past its bound
// sets *err (the wrapper raises).

#include <cstdint>

#include <cuda_runtime.h>

#include "planes.cuh"
#include "uf.cuh"

namespace {

constexpr int kThreads = 1024;

template <bool kShared>
__device__ inline int load(const int* p) {
  return tik::uf::load_parent<kShared>(p, 0);
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
label_stats_kernel(const uint8_t* __restrict__ fg, uint8_t* __restrict__ mask,
                   long long* __restrict__ stats, int* __restrict__ scratch,
                   int* err, int H, int W) {
  extern __shared__ int smem[];
  __shared__ unsigned long long s_best, s_sx, s_sy;
  __shared__ int s_rlo, s_rhi, s_clo, s_chi;
  const int hw = H * W;
  const int hb = (H + 1) / 2;
  const int wb = (W + 1) / 2;
  const int nb = hb * wb;
  const size_t base = static_cast<size_t>(blockIdx.x) * hw;
  const uint8_t* f = fg + base;
  // parent, area (per root) and code per block
  int* par = kShared ? smem : scratch + static_cast<size_t>(blockIdx.x) * 3 * nb;
  int* area = par + nb;
  uint8_t* code = reinterpret_cast<uint8_t*>(area + nb);
  const int tid = threadIdx.x;

  tik::block_codes(f, code, H, W, wb, nb);
  for (int b = tid; b < nb; b += kThreads) {
    par[b] = b;
    area[b] = 0;
  }
  if (tid == 0) {
    s_best = 0ull;
    s_sx = 0ull;
    s_sy = 0ull;
    s_rlo = H;
    s_rhi = 0;
    s_clo = W;
    s_chi = 0;
  }
  __syncthreads();

  // the east edges: a thread per block row hangs each run of east-connected
  // blocks under its first block, with plain stores (no other thread
  // touches the row's parents yet), so the unions below start from trees
  // of depth 1
  for (int by = tid; by < hb; by += kThreads) {
    int start = -1;
    for (int b = by * wb, e = b + wb; b < e; ++b) {
      const int c = code[b];
      if (!c) {
        start = -1;
      } else if (start >= 0 && tik::conn_e(code[b - 1], c)) {
        par[b] = start;
      } else {
        start = b;
      }
    }
  }
  __syncthreads();

  // link each block to its south, south-east and south-west neighbours
  // where the block graph has the edge
  for (int b = tid; b < nb; b += kThreads) {
    const int c = code[b];
    if (!c) continue;
    const int by = b / wb;
    const int bx = b - by * wb;
    if (by + 1 >= hb) continue;
    const int s = b + wb;
    if (tik::conn_s(c, code[s])) tik::uf::unite<kShared>(par, b, s, nb, err);
    if (bx + 1 < wb && tik::conn_se(c, code[s + 1])) {
      tik::uf::unite<kShared>(par, b, s + 1, nb, err);
    }
    if (bx > 0 && tik::conn_sw(c, code[s - 1])) {
      tik::uf::unite<kShared>(par, b, s - 1, nb, err);
    }
  }
  __syncthreads();

  // resolve: every block to its root (roots are final now), and the area;
  // the walk stores nothing (a halving store racing with a block's own
  // store of its root could leave a non-root in the slot)
  for (int b = tid; b < nb; b += kThreads) {
    const int c = code[b];
    if (!c) continue;
    const int r = tik::root_walk<kShared>(par, b, nb, err);
    par[b] = r;
    atomicAdd(area + r, __popc(c));
  }
  __syncthreads();

  // the winner: the largest area, then the smallest root
  for (int b = tid; b < nb; b += kThreads) {
    if (code[b] && load<kShared>(par + b) == b) {
      const unsigned long long key =
          (static_cast<unsigned long long>(load<kShared>(area + b)) << 32) |
          static_cast<unsigned long long>(0xFFFFFFFFu - static_cast<unsigned>(b));
      atomicMax(&s_best, key);
    }
  }
  __syncthreads();
  const unsigned long long best = s_best;
  const bool has = best != 0ull;
  const int root =
      has ? static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(best & 0xFFFFFFFFull)) : -1;

  long long sx = 0, sy = 0;
  int rlo = H, rhi = 0, clo = W, chi = 0;
  uint8_t* o = mask + base;
  for (int i = tid; i < hw; i += kThreads) {
    const int y = i / W;
    const int x = i - y * W;
    const bool in = has && f[i] && load<kShared>(par + (y >> 1) * wb + (x >> 1)) == root;
    o[i] = in;
    if (in) {
      sx += x;
      sy += y;
      rlo = min(rlo, y);
      rhi = max(rhi, y + 1);
      clo = min(clo, x);
      chi = max(chi, x + 1);
    }
  }
  if (sx) atomicAdd(&s_sx, static_cast<unsigned long long>(sx));
  if (sy) atomicAdd(&s_sy, static_cast<unsigned long long>(sy));
  if (rlo < H) atomicMin(&s_rlo, rlo);
  if (rhi > 0) atomicMax(&s_rhi, rhi);
  if (clo < W) atomicMin(&s_clo, clo);
  if (chi > 0) atomicMax(&s_chi, chi);
  __syncthreads();
  if (tid == 0) {
    long long* st = stats + static_cast<size_t>(blockIdx.x) * 8;
    st[0] = static_cast<long long>(best >> 32);
    st[1] = static_cast<long long>(s_sx);
    st[2] = static_cast<long long>(s_sy);
    st[3] = has;
    st[4] = s_rlo;
    st[5] = s_rhi;
    st[6] = s_clo;
    st[7] = s_chi;
  }
}

}  // namespace

// scratch: 3 * U * ceil(H/2) * ceil(W/2) int32, used only by units whose
// 9 bytes a block do not fit a block's shared memory; err: one int32, zeroed
// by the caller
extern "C" int tik_label_stats(const void* fg, void* mask, void* stats, void* scratch,
                               void* err, int U, int H, int W, void* stream) {
  if (U <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  const size_t nb = static_cast<size_t>((H + 1) / 2) * ((W + 1) / 2);
  const size_t smem = 9 * nb;
  int dev = 0;
  int optin = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  // room for the kernel's static shared variables
  const bool shared = smem + 256 <= static_cast<size_t>(optin);
  const auto* in = static_cast<const uint8_t*>(fg);
  auto* out = static_cast<uint8_t*>(mask);
  auto* st = static_cast<long long*>(stats);
  auto* sc = static_cast<int*>(scratch);
  auto* e = static_cast<int*>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shared) {
    rc = cudaFuncSetAttribute(label_stats_kernel<true>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    label_stats_kernel<true><<<U, kThreads, smem, s>>>(in, out, st, sc, e, H, W);
  } else {
    label_stats_kernel<false><<<U, kThreads, 0, s>>>(in, out, st, sc, e, H, W);
  }
  return static_cast<int>(cudaGetLastError());
}
