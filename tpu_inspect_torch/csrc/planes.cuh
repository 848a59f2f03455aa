// Per-unit plane primitives shared by the seg-tail and blob-filter kernels
// (kernel J, label_stats.cu, uses the 2x2 block grid's codes and edges).
//
// Every function here is executed by ALL threads of one CTA, which owns one
// unit: work is strided over the CTA's threads and phases are separated by
// __syncthreads(). Planes are row-major uint8 [H, W] in per-unit global
// scratch (a 315x316 unit is ~100 KB per plane; the whole batch's scratch
// stays in the 50 MB L2).
//
// Connected components run on the 2x2 BLOCK grid: under 8-connectivity the
// fg pixels of one 2x2 block are mutually adjacent, so pixel components are
// exactly the components of the block graph whose edges follow from the
// blocks' sub-cell patterns. A component's key is its minimum block-raster
// index, which is also OpenCV's labeling order (cv2 numbers components by
// first appearance in 2x2-block raster order).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace tik {

constexpr int kBig = 1 << 30;

// ---------------------------------------------------------------------------
// Morphology: a program of erode/dilate stages with OpenCV's clip-to-image
// border (out-of-image = 255 for erode, 0 for dilate).
//
// prog layout (int32): n_stages, then per stage: op (0 erode, 1 dilate),
// n_groups, then per group: lo, hi, n_dy, dy_0 .. dy_{n_dy-1}. A group is a
// set of SE rows sharing the column window [lo, hi]: one horizontal sliding
// reduction per group, then one vertical combine per row offset (a rect SE
// is one group, i.e. separable).
//
// `a` holds the input; `b` and `t` are scratch. Returns the plane holding
// the result (a or b).
// ---------------------------------------------------------------------------
__device__ inline uint8_t* apply_stages(const int* __restrict__ prog,
                                        uint8_t* a, uint8_t* b, uint8_t* t,
                                        int H, int W) {
  const int HW = H * W;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  int p = 0;
  const int n_stages = prog[p++];
  for (int s = 0; s < n_stages; ++s) {
    const bool erode = prog[p++] == 0;
    const int n_groups = prog[p++];
    const int neutral = erode ? 255 : 0;
    for (int i = tid; i < HW; i += nt) b[i] = static_cast<uint8_t>(neutral);
    for (int g = 0; g < n_groups; ++g) {
      const int lo = prog[p++];
      const int hi = prog[p++];
      const int nd = prog[p++];
      const int* dys = prog + p;
      p += nd;
      __syncthreads();  // b initialised / previous group done reading t
      for (int i = tid; i < HW; i += nt) {
        const int y = i / W;
        const int x = i - y * W;
        const int x0 = max(0, x + lo);
        const int x1 = min(W - 1, x + hi);
        const uint8_t* row = a + y * W;
        int r = neutral;
        if (erode) {
          for (int xx = x0; xx <= x1; ++xx) r = min(r, static_cast<int>(row[xx]));
        } else {
          for (int xx = x0; xx <= x1; ++xx) r = max(r, static_cast<int>(row[xx]));
        }
        t[i] = static_cast<uint8_t>(r);
      }
      __syncthreads();
      for (int i = tid; i < HW; i += nt) {
        const int y = i / W;
        const int x = i - y * W;
        int r = b[i];
        for (int j = 0; j < nd; ++j) {
          const int yy = y + dys[j];
          if (yy >= 0 && yy < H) {
            const int v = t[yy * W + x];
            r = erode ? min(r, v) : max(r, v);
          }
        }
        b[i] = static_cast<uint8_t>(r);
      }
    }
    __syncthreads();
    uint8_t* tmp = a;
    a = b;
    b = tmp;
  }
  return a;
}

// ---------------------------------------------------------------------------
// Exterior: background (m == 0) 4-connected to the plane border.
// ext[i] = 1 on the exterior, else 0. Row sweeps (a thread per row) then
// column sweeps (a thread per column) carry reachability across whole free
// runs, repeated until nothing changes: O(#bends) rounds, deterministic.
// ---------------------------------------------------------------------------
__device__ inline void exterior_flood(const uint8_t* __restrict__ m,
                                      uint8_t* ext, int H, int W,
                                      int* s_flag) {
  const int HW = H * W;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int i = tid; i < HW; i += nt) {
    const int y = i / W;
    const int x = i - y * W;
    const bool border = y == 0 || y == H - 1 || x == 0 || x == W - 1;
    ext[i] = (m[i] == 0 && border) ? 1 : 0;
  }
  // every round reaches at least one new pixel, so HW + 1 rounds bound it
  for (int iter = 0; iter <= HW; ++iter) {
    if (tid == 0) *s_flag = 0;
    __syncthreads();
    int changed = 0;
    for (int y = tid; y < H; y += nt) {
      const uint8_t* mr = m + y * W;
      uint8_t* er = ext + y * W;
      int carry = 0;
      for (int x = 0; x < W; ++x) {
        if (mr[x]) {
          carry = 0;
        } else if (er[x]) {
          carry = 1;
        } else if (carry) {
          er[x] = 1;
          changed = 1;
        }
      }
      carry = 0;
      for (int x = W - 1; x >= 0; --x) {
        if (mr[x]) {
          carry = 0;
        } else if (er[x]) {
          carry = 1;
        } else if (carry) {
          er[x] = 1;
          changed = 1;
        }
      }
    }
    __syncthreads();
    for (int x = tid; x < W; x += nt) {
      int carry = 0;
      for (int y = 0; y < H; ++y) {
        const int i = y * W + x;
        if (m[i]) {
          carry = 0;
        } else if (ext[i]) {
          carry = 1;
        } else if (carry) {
          ext[i] = 1;
          changed = 1;
        }
      }
      carry = 0;
      for (int y = H - 1; y >= 0; --y) {
        const int i = y * W + x;
        if (m[i]) {
          carry = 0;
        } else if (ext[i]) {
          carry = 1;
        } else if (carry) {
          ext[i] = 1;
          changed = 1;
        }
      }
    }
    if (changed) *s_flag = 1;
    __syncthreads();
    const int again = *s_flag;
    __syncthreads();  // every thread has read the flag before it is reset
    if (!again) break;
  }
}

// ---------------------------------------------------------------------------
// 2x2 block grid. code bits: 1 = (2by, 2bx), 2 = (2by, 2bx+1),
// 4 = (2by+1, 2bx), 8 = (2by+1, 2bx+1); out-of-plane sub-cells are 0.
// ---------------------------------------------------------------------------
__device__ inline void block_codes(const uint8_t* __restrict__ m,
                                   uint8_t* code, int H, int W, int wb,
                                   int nb) {
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    const int by = b / wb;
    const int bx = b - by * wb;
    const int y = 2 * by;
    const int x = 2 * bx;
    int c = 0;
    if (m[y * W + x]) c |= 1;
    if (x + 1 < W && m[y * W + x + 1]) c |= 2;
    if (y + 1 < H && m[(y + 1) * W + x]) c |= 4;
    if (y + 1 < H && x + 1 < W && m[(y + 1) * W + x + 1]) c |= 8;
    code[b] = static_cast<uint8_t>(c);
  }
}

// edges of the block graph: a -> its east / south / south-east / south-west
// neighbour n (pixel pairs across the shared side or corner are adjacent)
__device__ inline bool conn_e(int a, int n) { return (a & 0xA) && (n & 0x5); }
__device__ inline bool conn_s(int a, int n) { return (a & 0xC) && (n & 0x3); }
__device__ inline bool conn_se(int a, int n) { return (a & 8) && (n & 1); }
__device__ inline bool conn_sw(int a, int n) { return (a & 4) && (n & 2); }

// Min-label fixpoint on the block grid: lab[b] = minimum block index of b's
// component (kBig for empty blocks). Per round: an 8-neighbour min, then
// row and column sweeps along connected runs. Labels only decrease and every
// value read is a label of the same component, so concurrent in-place
// updates converge to the same fixpoint.
__device__ inline void label_blocks(const uint8_t* __restrict__ code, int* lab,
                                    int hb, int wb, int* s_flag) {
  const int nb = hb * wb;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int b = tid; b < nb; b += nt) lab[b] = code[b] ? b : kBig;
  // every round lowers at least one label, so the fixpoint is reached in
  // far fewer than nb * nb rounds; the bound only guarantees termination
  for (long long iter = 0; iter <= static_cast<long long>(nb) * nb; ++iter) {
    if (tid == 0) *s_flag = 0;
    __syncthreads();
    int changed = 0;
    for (int b = tid; b < nb; b += nt) {
      const int c = code[b];
      if (!c) continue;
      const int by = b / wb;
      const int bx = b - by * wb;
      const int old = lab[b];
      int l = old;
      if (bx + 1 < wb && conn_e(c, code[b + 1])) l = min(l, lab[b + 1]);
      if (bx > 0 && conn_e(code[b - 1], c)) l = min(l, lab[b - 1]);
      if (by + 1 < hb) {
        const int s = b + wb;
        if (conn_s(c, code[s])) l = min(l, lab[s]);
        if (bx + 1 < wb && conn_se(c, code[s + 1])) l = min(l, lab[s + 1]);
        if (bx > 0 && conn_sw(c, code[s - 1])) l = min(l, lab[s - 1]);
      }
      if (by > 0) {
        const int n = b - wb;
        if (conn_s(code[n], c)) l = min(l, lab[n]);
        if (bx > 0 && conn_se(code[n - 1], c)) l = min(l, lab[n - 1]);
        if (bx + 1 < wb && conn_sw(code[n + 1], c)) l = min(l, lab[n + 1]);
      }
      if (l < old) {
        lab[b] = l;
        changed = 1;
      }
    }
    __syncthreads();
    for (int by = tid; by < hb; by += nt) {
      const int base = by * wb;
      int carry = kBig;
      for (int bx = 0; bx < wb; ++bx) {
        const int b = base + bx;
        const int c = code[b];
        if (!c) continue;
        int l = lab[b];
        if (bx > 0 && conn_e(code[b - 1], c)) l = min(l, carry);
        if (l < lab[b]) {
          lab[b] = l;
          changed = 1;
        }
        carry = l;
      }
      carry = kBig;
      for (int bx = wb - 1; bx >= 0; --bx) {
        const int b = base + bx;
        const int c = code[b];
        if (!c) continue;
        int l = lab[b];
        if (bx + 1 < wb && conn_e(c, code[b + 1])) l = min(l, carry);
        if (l < lab[b]) {
          lab[b] = l;
          changed = 1;
        }
        carry = l;
      }
    }
    __syncthreads();
    for (int bx = tid; bx < wb; bx += nt) {
      int carry = kBig;
      for (int by = 0; by < hb; ++by) {
        const int b = by * wb + bx;
        const int c = code[b];
        if (!c) continue;
        int l = lab[b];
        if (by > 0 && conn_s(code[b - wb], c)) l = min(l, carry);
        if (l < lab[b]) {
          lab[b] = l;
          changed = 1;
        }
        carry = l;
      }
      carry = kBig;
      for (int by = hb - 1; by >= 0; --by) {
        const int b = by * wb + bx;
        const int c = code[b];
        if (!c) continue;
        int l = lab[b];
        if (by + 1 < hb && conn_s(c, code[b + wb])) l = min(l, carry);
        if (l < lab[b]) {
          lab[b] = l;
          changed = 1;
        }
        carry = l;
      }
    }
    if (changed) *s_flag = 1;
    __syncthreads();
    const int again = *s_flag;
    __syncthreads();
    if (!again) break;
  }
}

__device__ inline int block_of(int i, int W, int wb) {
  const int y = i / W;
  const int x = i - y * W;
  return (y >> 1) * wb + (x >> 1);
}

}  // namespace tik
