// blob_select: kernel G, the per-blob Green's-theorem filter and filled
// paint given the fill regions, on Hopper (sm_90a).
//
// Replaces tpu_inspect/ops/cc_pallas.py: tile_sum_tables_pallas (per-tile
// (key, signed Green's sum) tables) and tile_paint_pallas (paint the kept
// keys per tile), the whole-image _green_filter_tiled of contour.py:192-539
// with the seed flood that follows it (contour.py:684-698), and
// tpu_inspect/ops/blob_pallas.py: blob_select_pallas (the same function on a
// resident plane). Per unit of a [U, H, W] batch, given the fill-region
// labels (kernel E on ~ext: each region's raster-first pixel index, BIG on
// the exterior), the top-level blob pixels and the exterior:
//   twice the OpenCV contourArea of each top-level blob = the sum of its
//   crack-vertex contributions from CONTOUR_TABLE_X2 (states 2 top-level,
//   1 exterior, 0 other; out of plane is exterior), attributed to the region
//   of the top-level pixels in the vertex's 2x2 window; a region is kept
//   when min_x2 <= |sum| <= max_x2[u]; kept regions are painted 255 (filled
//   drawContours) and their pixels counted.
//
// What bounds it on this card: bytes (an int32 label plane and two uint8
// planes in, a uint8 plane out: 7 bytes a pixel, 86 MB at 1x3000x4096, about
// 26 us at 3.35 TB/s). Design: no tiles, no per-tile tables and no table
// merge, which existed only because a whole plane does not fit a TPU core's
// VMEM; two passes over the whole batch:
//   1. sum: one thread per crack vertex, (H+1)*(W+1) per unit; warps with no
//      contribution leave at once, the others merge their lanes of the same
//      region before one 64-bit atomicAdd into the region's root slot (one
//      contribution is at most 1 + W + H, but a region's partial sums reach
//      about 1e11 before they cancel, so they are int64);
//   2. paint: one thread per pixel, the keep test on its region's sum, the
//      painted pixels reduced per block before one atomicAdd per unit.
// The table lives in constant memory. A fill label outside its plane sets
// *err = 3 (the wrapper raises).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

__constant__ int c_table[81 * 3];

// 2 top-level blob, 1 exterior (and out of plane), 0 hole or nested blob
__device__ inline int state_at(const uint8_t* top, const uint8_t* ext, int y, int x,
                               int H, int W) {
  if (y < 0 || x < 0 || y >= H || x >= W) return 1;
  const int i = y * W + x;
  return top[i] ? 2 : (ext[i] ? 1 : 0);
}

__device__ inline int top_label(const uint8_t* top, const int* lab, int y, int x, int H,
                                int W) {
  if (y < 0 || x < 0 || y >= H || x >= W) return -1;
  const int i = y * W + x;
  return top[i] ? lab[i] : -1;
}

// pass 1: grid (vertex blocks of a unit, U)
__global__ void __launch_bounds__(kThreads)
sum_kernel(const int* __restrict__ fill_labels, const uint8_t* __restrict__ top,
           const uint8_t* __restrict__ ext, long long* __restrict__ sums, int* err,
           int H, int W) {
  const int u = blockIdx.y;
  const int vw = W + 1;
  const int nv = (H + 1) * vw;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  const int hw = H * W;
  const size_t base = static_cast<size_t>(u) * hw;
  const uint8_t* t = top + base;
  const uint8_t* e = ext + base;
  const int* lab = fill_labels + base;
  int key = -1;
  int contrib = 0;
  if (v < nv) {
    const int vy = v / vw;
    const int vx = v - vy * vw;
    const int cfg = state_at(t, e, vy - 1, vx - 1, H, W) + 3 * state_at(t, e, vy - 1, vx, H, W) +
                    9 * state_at(t, e, vy, vx - 1, H, W) + 27 * state_at(t, e, vy, vx, H, W);
    contrib = c_table[3 * cfg] + c_table[3 * cfg + 1] * vx + c_table[3 * cfg + 2] * vy;
    if (contrib != 0) {
      // the window's top-level pixels all belong to one region; take the
      // max of their labels, as the plain version does
      const int a = max(max(top_label(t, lab, vy - 1, vx - 1, H, W),
                            top_label(t, lab, vy - 1, vx, H, W)),
                        max(top_label(t, lab, vy, vx - 1, H, W), top_label(t, lab, vy, vx, H, W)));
      if (a >= hw) {
        atomicExch(err, 3);
      } else {
        key = a;
      }
    }
  }
  if (__ballot_sync(kFull, key >= 0) == 0) return;  // warp-uniform
  const unsigned peers = __match_any_sync(kFull, key);
  long long total = 0;
  for (int j = 0; j < 32; ++j) {
    const int cj = __shfl_sync(kFull, contrib, j);
    if ((peers >> j) & 1u) total += cj;
  }
  if (key >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1 && total != 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(sums + base + key),
              static_cast<unsigned long long>(total));
  }
}

// pass 2: grid (pixel blocks of a unit, U)
__global__ void __launch_bounds__(kThreads)
paint_kernel(const int* __restrict__ fill_labels, const uint8_t* __restrict__ ext,
             const long long* __restrict__ sums, const int* __restrict__ max_x2,
             uint8_t* __restrict__ out, int* __restrict__ area, int* err, int hw,
             long long min_x2) {
  __shared__ int s_cnt[kThreads / 32];
  const int u = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t base = static_cast<size_t>(u) * hw;
  int keep = 0;
  if (p < hw) {
    if (!ext[base + p]) {
      const int l = fill_labels[base + p];
      if (l < 0 || l >= hw) {
        atomicExch(err, 3);
      } else {
        const long long a2 = llabs(sums[base + l]);
        keep = a2 >= min_x2 && a2 <= static_cast<long long>(max_x2[u]);
      }
    }
    out[base + p] = keep ? 255 : 0;
  }
  int c = keep;
  for (int d = 16; d > 0; d >>= 1) c += __shfl_xor_sync(kFull, c, d);
  if ((threadIdx.x & 31) == 0) s_cnt[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int k = 0; k < kThreads / 32; ++k) total += s_cnt[k];
    if (total) atomicAdd(area + u, total);
  }
}

}  // namespace

extern "C" int tik_blob_select(const void* fill_labels, const void* top, const void* ext,
                               const void* max_x2, const void* table, void* out,
                               void* area, void* sums, void* err, int U, int H, int W,
                               int min_x2, void* stream) {
  const int hw = H * W;
  if (U <= 0 || hw <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if ((rc = cudaMemcpyToSymbolAsync(c_table, table, sizeof(int) * 81 * 3, 0,
                                    cudaMemcpyDeviceToDevice, s)) != cudaSuccess ||
      (rc = cudaMemsetAsync(sums, 0, sizeof(long long) * static_cast<size_t>(U) * hw, s)) !=
          cudaSuccess ||
      (rc = cudaMemsetAsync(area, 0, sizeof(int) * static_cast<size_t>(U), s)) != cudaSuccess) {
    return static_cast<int>(rc);
  }
  const int* lab = static_cast<const int*>(fill_labels);
  const uint8_t* e = static_cast<const uint8_t*>(ext);
  long long* sm = static_cast<long long*>(sums);
  int* ef = static_cast<int*>(err);
  const int nv = (H + 1) * (W + 1);
  sum_kernel<<<dim3((nv + kThreads - 1) / kThreads, U), kThreads, 0, s>>>(
      lab, static_cast<const uint8_t*>(top), e, sm, ef, H, W);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  paint_kernel<<<dim3((hw + kThreads - 1) / kThreads, U), kThreads, 0, s>>>(
      lab, e, sm, static_cast<const int*>(max_x2), static_cast<uint8_t*>(out),
      static_cast<int*>(area), ef, hw, min_x2);
  return static_cast<int>(cudaGetLastError());
}
