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
// VMEM; a memset and two passes over the whole batch, each thread on 16
// pixels (16-byte loads and stores where a unit's rows are 16-byte aligned,
// W % 16 == 0):
//   0. the region sums: ONE int64 slot per 2x2 block of the label's pixel
//      (the fill labels are 8-connected components of ~ext and a 2x2
//      block's pixels are 8-adjacent, so no block holds two regions' first
//      pixels; kernel F's table rests on the same argument), zeroed in one
//      memset (24.6 MB at a whole capture, a quarter of a slot a pixel).
//   1. sum: a thread per 16 crack vertices of a vertex row: the top-level
//      bytes of its two pixel rows first, and nothing more where they hold
//      no top-level pixel (the table gives a window without one 0), which
//      is almost every vertex; else the exterior bytes, the vertex states,
//      and a label only where a vertex contributes. A thread's consecutive
//      contributions to one region add up in a register, the open run is
//      merged over the warp's lanes of the same region, and each reaches
//      its slot by one 64-bit atomicAdd (one contribution is at most
//      1 + W + H, but a region's partial sums reach about 1e11 before they
//      cancel, so they are int64).
//   2. paint: a thread per 16 pixels: the exterior bytes, and where one of
//      them is not exterior the labels (16-byte loads of the 4-pixel
//      groups that need them), the keep test on the region's slot (once
//      per run of one label), 16-byte stores of the 0/255 bytes, the
//      painted pixels reduced per CTA before one atomicAdd per unit.
// The table lives in constant memory, copied once per device
// (tik_blob_select_setup). A fill label outside its plane sets *err = 3
// (the wrapper raises).

#include <cstdint>

#include <cuda_runtime.h>

#include "planes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;  // pixels (vertices) a thread
constexpr unsigned kFull = 0xFFFFFFFFu;

__constant__ int c_table[81 * 3];

// the nonzero bytes of v as 16 bits
__device__ inline uint32_t nz16(uint4 v) {
  return tik::nz4(v.x) | tik::nz4(v.y) << 4 | tik::nz4(v.z) << 8 | tik::nz4(v.w) << 12;
}

// The nonzero bytes of row `row` (W px) at columns x0 - 1 .. x0 + 15 as a
// 17-bit mask (bit 0: column x0 - 1), columns off the plane set to `off`
// (0 or 1). vec: x0 and the row start are 16-byte aligned.
__device__ inline uint32_t row17(const uint8_t* __restrict__ row, int x0, int W, bool vec,
                                 uint32_t off) {
  uint32_t m = 0;
  if (vec && x0 + kVec <= W) {
    m = nz16(__ldg(reinterpret_cast<const uint4*>(row + x0))) << 1;
  } else {
    for (int j = 0; j < kVec; ++j) {
      const int x = x0 + j;
      m |= (x < W ? static_cast<uint32_t>(row[x] != 0) : off) << (j + 1);
    }
  }
  return m | (x0 > 0 ? static_cast<uint32_t>(row[x0 - 1] != 0) : off);
}

// the slot of label l: its pixel's 2x2 block
__device__ inline int slot_of(int l, int W, int wb) {
  const int ly = l / W;
  return (ly >> 1) * wb + ((l - ly * W) >> 1);
}

// pass 1: grid (vertex chunks of a unit, U); a chunk is 16 vertices of a
// vertex row, ceil((W + 1) / 16) a row
__global__ void __launch_bounds__(kThreads)
sum_kernel(const int* __restrict__ fill_labels, const uint8_t* __restrict__ top,
           const uint8_t* __restrict__ ext, long long* __restrict__ sums,
           int* __restrict__ area, int* err, int H, int W, int vec) {
  const int u = blockIdx.y;
  if (blockIdx.x == 0 && threadIdx.x == 0) area[u] = 0;  // the paint pass counts here
  const int chunks = (W + kVec) / kVec;
  const int item = blockIdx.x * kThreads + threadIdx.x;
  const int vy = item / chunks;
  const int vx0 = (item - vy * chunks) * kVec;
  const size_t hw = static_cast<size_t>(H) * W;
  const size_t base = u * hw;
  const uint8_t* t = top + base;
  const uint8_t* e = ext + base;
  const int* lab = fill_labels + base;
  // the top-level bits of pixel rows vy - 1 (a) and vy (b)
  uint32_t ta = 0, tb = 0;
  if (vy <= H) {
    if (vy > 0) ta = row17(t + static_cast<size_t>(vy - 1) * W, vx0, W, vec, 0u);
    if (vy < H) tb = row17(t + static_cast<size_t>(vy) * W, vx0, W, vec, 0u);
  }
  if (!__any_sync(kFull, ta | tb)) return;  // warp-uniform: no contour here
  const int wb = (W + 1) >> 1;
  long long* us = sums + static_cast<size_t>(u) * ((H + 1) >> 1) * wb;
  int cur = -1;  // the slot of the open run of contributions, and its sum
  long long run = 0;
  if (ta | tb) {
    const uint32_t ea = vy > 0 ? row17(e + static_cast<size_t>(vy - 1) * W, vx0, W, vec, 1u)
                               : 0x1FFFFu;
    const uint32_t eb = vy < H ? row17(e + static_cast<size_t>(vy) * W, vx0, W, vec, 1u)
                               : 0x1FFFFu;
    const int n = min(kVec, W + 1 - vx0);
    for (int j = 0; j < n; ++j) {
      if (!(((ta | tb) >> j) & 3u)) continue;  // no top-level pixel: contributes 0
      auto state = [&](uint32_t tm, uint32_t em, int b) {
        return ((tm >> b) & 1u) ? 2 : static_cast<int>((em >> b) & 1u);
      };
      const int cfg = state(ta, ea, j) + 3 * state(ta, ea, j + 1) + 9 * state(tb, eb, j) +
                      27 * state(tb, eb, j + 1);
      const int vx = vx0 + j;
      const int contrib = c_table[3 * cfg] + c_table[3 * cfg + 1] * vx + c_table[3 * cfg + 2] * vy;
      if (contrib == 0) continue;
      // the window's top-level pixels all belong to one region; take the
      // max of their labels, as the plain version does
      int a = -1;
      if ((ta >> j) & 1u) a = max(a, lab[static_cast<size_t>(vy - 1) * W + vx - 1]);
      if ((ta >> (j + 1)) & 1u) a = max(a, lab[static_cast<size_t>(vy - 1) * W + vx]);
      if ((tb >> j) & 1u) a = max(a, lab[static_cast<size_t>(vy) * W + vx - 1]);
      if ((tb >> (j + 1)) & 1u) a = max(a, lab[static_cast<size_t>(vy) * W + vx]);
      if (a < 0 || static_cast<size_t>(a) >= hw) {
        atomicExch(err, 3);
        continue;
      }
      const int s = slot_of(a, W, wb);
      if (s != cur) {
        if (cur >= 0 && run != 0) {
          atomicAdd(reinterpret_cast<unsigned long long*>(us + cur),
                    static_cast<unsigned long long>(run));
        }
        cur = s;
        run = 0;
      }
      run += contrib;
    }
  }
  // the open runs, merged over the warp's lanes of the same slot
  const unsigned peers = __match_any_sync(kFull, cur);
  long long total = 0;
  for (int j = 0; j < 32; ++j) {
    const long long rj = __shfl_sync(kFull, run, j);
    if ((peers >> j) & 1u) total += rj;
  }
  if (cur >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1 && total != 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(us + cur),
              static_cast<unsigned long long>(total));
  }
}

// pass 2: grid (16-pixel chunks of a unit, U)
__global__ void __launch_bounds__(kThreads)
paint_kernel(const int* __restrict__ fill_labels, const uint8_t* __restrict__ ext,
             const long long* __restrict__ sums, const int* __restrict__ max_x2,
             uint8_t* __restrict__ out, int* __restrict__ area, int* err, int H, int W,
             long long min_x2, int vec) {
  __shared__ int s_cnt[kThreads / 32];
  const int u = blockIdx.y;
  const size_t hw = static_cast<size_t>(H) * W;
  const size_t p0 = (static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  const size_t base = u * hw;
  const int wb = (W + 1) >> 1;
  const long long* us = sums + static_cast<size_t>(u) * ((H + 1) >> 1) * wb;
  const long long hi = max_x2[u];
  int kept = 0;
  if (p0 < hw) {
    const int n = static_cast<int>(hw - p0 < kVec ? hw - p0 : kVec);
    const bool full = vec && n == kVec;
    uint32_t em = 0;  // exterior bits
    if (full) {
      em = nz16(__ldg(reinterpret_cast<const uint4*>(ext + base + p0)));
    } else {
      for (int j = 0; j < n; ++j) em |= static_cast<uint32_t>(ext[base + p0 + j] != 0) << j;
    }
    uint32_t km = 0;  // kept bits
    if (em != (1u << n) - 1u) {
      int l[kVec];
      if (full) {
        const int4* lp = reinterpret_cast<const int4*>(fill_labels + base + p0);
#pragma unroll
        for (int q = 0; q < kVec / 4; ++q) {
          if (((em >> (4 * q)) & 0xFu) == 0xFu) continue;  // all exterior: not needed
          const int4 v = __ldg(lp + q);
          l[4 * q] = v.x, l[4 * q + 1] = v.y, l[4 * q + 2] = v.z, l[4 * q + 3] = v.w;
        }
      }
      int last = -1;
      bool keep = false;
      for (int j = 0; j < n; ++j) {
        if ((em >> j) & 1u) continue;
        const int lj = full ? l[j] : fill_labels[base + p0 + j];
        if (lj < 0 || static_cast<size_t>(lj) >= hw) {
          atomicExch(err, 3);
          continue;
        }
        if (lj != last) {
          const long long a2 = llabs(us[slot_of(lj, W, wb)]);
          keep = a2 >= min_x2 && a2 <= hi;
          last = lj;
        }
        km |= static_cast<uint32_t>(keep) << j;
      }
      kept = __popc(km);
    }
    if (full) {
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = tik::bytes4(km >> (4 * q)) * 0xFFu;  // 0 / 255
      *reinterpret_cast<uint4*>(out + base + p0) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      for (int j = 0; j < n; ++j) out[base + p0 + j] = ((km >> j) & 1u) ? 255 : 0;
    }
  }
  int c = __reduce_add_sync(kFull, kept);
  if ((threadIdx.x & 31) == 0) s_cnt[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int k = 0; k < kThreads / 32; ++k) total += s_cnt[k];
    if (total) atomicAdd(area + u, total);
  }
}

}  // namespace

// Once per device: the contour table (81 x 3 int32, host memory) into
// constant memory.
extern "C" int tik_blob_select_setup(const void* table) {
  return static_cast<int>(cudaMemcpyToSymbol(c_table, table, sizeof(int) * 81 * 3));
}

// sums: U * ceil(H/2) * ceil(W/2) int64 slots, zeroed here; area: [U]
// int32, written here
extern "C" int tik_blob_select(const void* fill_labels, const void* top, const void* ext,
                               const void* max_x2, void* out, void* area, void* sums,
                               void* err, int U, int H, int W, int min_x2, void* stream) {
  const long long hw = static_cast<long long>(H) * W;
  if (U <= 0 || hw <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t slots = static_cast<size_t>(U) * ((H + 1) / 2) * ((W + 1) / 2);
  cudaError_t rc = cudaMemsetAsync(sums, 0, sizeof(long long) * slots, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  // every row start and 16-pixel chunk 16-byte aligned
  const int vec = W % kVec == 0 && aligned(fill_labels) && aligned(top) && aligned(ext) &&
                  aligned(out);
  const int* lab = static_cast<const int*>(fill_labels);
  const uint8_t* e = static_cast<const uint8_t*>(ext);
  long long* sm = static_cast<long long*>(sums);
  int* ar = static_cast<int*>(area);
  int* ef = static_cast<int*>(err);
  const long long vitems = static_cast<long long>(H + 1) * ((W + kVec) / kVec);
  sum_kernel<<<dim3(static_cast<unsigned>((vitems + kThreads - 1) / kThreads), U), kThreads, 0,
               s>>>(lab, static_cast<const uint8_t*>(top), e, sm, ar, ef, H, W, vec);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  const long long pitems = (hw + kVec - 1) / kVec;
  paint_kernel<<<dim3(static_cast<unsigned>((pitems + kThreads - 1) / kThreads), U), kThreads, 0,
                 s>>>(lab, e, sm, static_cast<const int*>(max_x2), static_cast<uint8_t*>(out), ar,
                      ef, H, W, min_x2, vec);
  return static_cast<int>(cudaGetLastError());
}
