// Per-unit plane primitives of kernels A (seg_tail.cu), K (seg_roi_tail.cu)
// and C (blob_filter.cu), the morphology of kernel I (morph.cu), and the
// byte <-> bit helpers of I, J (label_stats.cu) and G (blob_select.cu).
//
// Every function here is executed by ALL threads of one CTA, which owns one
// unit: work is strided over the CTA's threads and phases are separated by
// __syncthreads(). A function that ends with a barrier says so.
//
// Binary planes are bit-packed: row y of an [H, W] plane is WW = ceil(W/32)
// 32-bit words, pixel x at bit x & 31 of word x >> 5; the bits of the last
// word past W are kept 0. A 315x316 unit is 10 words a row, 12.6 KB a
// plane, so a kernel's working planes and its block-grid parents sit in
// one CTA's shared memory (the caller passes pointers: shared memory, or a
// global scratch for units too large for it; the code is the same).
//
// Connected components run on the 2x2 BLOCK grid: under 8-connectivity the
// fg pixels of one 2x2 block are mutually adjacent, so pixel components are
// exactly the components of the block graph whose edges follow from the
// blocks' sub-cell patterns. The labeling is a fixed-pass union-find
// (uf.cuh: each block row's east runs hung under their first block, then
// the south and diagonal unions with path halving in shared memory, then
// resolve), so a component's root is its minimum block-raster index, which
// is also OpenCV's labeling order (cv2 numbers components by first
// appearance in 2x2-block raster order).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "uf.cuh"

namespace tik {

// ---------------------------------------------------------------------------
// 2x2 block grid. code bits: 1 = (2by, 2bx), 2 = (2by, 2bx+1),
// 4 = (2by+1, 2bx), 8 = (2by+1, 2bx+1); out-of-plane sub-cells are 0.
// ---------------------------------------------------------------------------

// edges of the block graph: a -> its east / south / south-east / south-west
// neighbour n (pixel pairs across the shared side or corner are adjacent)
__device__ inline bool conn_e(int a, int n) { return (a & 0xA) && (n & 0x5); }
__device__ inline bool conn_s(int a, int n) { return (a & 0xC) && (n & 0x3); }
__device__ inline bool conn_se(int a, int n) { return (a & 8) && (n & 1); }
__device__ inline bool conn_sw(int a, int n) { return (a & 4) && (n & 2); }

// ---------------------------------------------------------------------------
// Bytes <-> bits (kernels I, J and G pack uint8 planes with these)
// ---------------------------------------------------------------------------

// bytes 0x00 / 0xFF of v -> 4 bits (byte i's MSB to bit i)
__device__ inline uint32_t msb4(uint32_t v) {
  return ((((v >> 7) & 0x01010101u) * 0x00204081u) >> 21) & 0xFu;
}

// the nonzero bytes of v -> 4 bits
__device__ inline uint32_t nz4(uint32_t v) { return msb4(__vcmpne4(v, 0u)); }

// the low 4 bits of b -> bytes 0 / 1 (bit i to byte i)
__device__ inline uint32_t bytes4(uint32_t b) { return ((b & 0xFu) * 0x00204081u) & 0x01010101u; }

// ---------------------------------------------------------------------------
// Bit-plane geometry and access
// ---------------------------------------------------------------------------

struct Bits {
  int H, W;
  int WW;         // words a row
  int n;          // words a plane, H * WW
  uint32_t last;  // the in-plane bits of a row's last word
  int hb, wb, nb; // the 2x2 block grid
};

__device__ inline Bits bits_of(int H, int W) {
  Bits g;
  g.H = H;
  g.W = W;
  g.WW = (W + 31) >> 5;
  g.n = H * g.WW;
  g.last = (W & 31) ? ((1u << (W & 31)) - 1u) : ~0u;
  g.hb = (H + 1) >> 1;
  g.wb = (W + 1) >> 1;
  g.nb = g.hb * g.wb;
  return g;
}

// words a plane, and the words of kernel A's / K's and kernel C's layouts
// (the launchers size shared memory and global scratch from these)
__host__ __device__ inline int plane_words(int H, int W) { return H * ((W + 31) >> 5); }
__host__ __device__ inline int block_count(int H, int W) {
  return ((H + 1) >> 1) * ((W + 1) >> 1);
}

__device__ inline uint32_t word_mask(const Bits& g, int k) {
  return k == g.WW - 1 ? g.last : ~0u;
}

__device__ inline uint32_t op2(uint32_t a, uint32_t b, bool erode) {
  return erode ? (a & b) : (a | b);
}

__device__ inline uint64_t op2(uint64_t a, uint64_t b, bool erode) {
  return erode ? (a & b) : (a | b);
}

// word k of row `row`, with the op's neutral (all ones for erode, zeros for
// dilate) outside the plane: OpenCV's clip border
__device__ inline uint32_t hload(const uint32_t* row, int k, const Bits& g,
                                 uint32_t neutral) {
  if (k < 0 || k >= g.WW) return neutral;
  const uint32_t v = row[k];
  return k == g.WW - 1 ? ((v & g.last) | (neutral & ~g.last)) : v;
}

// the 32 pixels x = 32k + s .. 32k + s + 31 of `row` (any s), neutral
// outside the plane
__device__ inline uint32_t hshift(const uint32_t* row, int k, int s, const Bits& g,
                                  uint32_t neutral) {
  const int q = s >> 5;  // floor(s / 32)
  const int r = s & 31;
  const uint32_t lo = hload(row, k + q, g, neutral);
  if (r == 0) return lo;
  return __funnelshift_r(lo, hload(row, k + q + 1, g, neutral), r);
}

// Pack pred(i) (i = y * W + x) into plane P, thread per word.
template <class Pred>
__device__ inline void pack(uint32_t* P, const Bits& g, Pred pred) {
  for (int w = threadIdx.x; w < g.n; w += blockDim.x) {
    const int y = w / g.WW;
    const int x0 = (w - y * g.WW) << 5;
    const int n = min(32, g.W - x0);
    const int base = y * g.W + x0;
    uint32_t v = 0;
    for (int j = 0; j < n; ++j) v |= static_cast<uint32_t>(pred(base + j) ? 1 : 0) << j;
    P[w] = v;
  }
}

// dst[i] = 255 where P's bit is set, else 0; thread per pixel (coalesced
// byte stores)
__device__ inline void unpack(const uint32_t* P, uint8_t* __restrict__ dst, const Bits& g) {
  const int hw = g.H * g.W;
  for (int i = threadIdx.x; i < hw; i += blockDim.x) {
    const int y = i / g.W;
    const int x = i - y * g.W;
    dst[i] = ((P[y * g.WW + (x >> 5)] >> (x & 31)) & 1u) ? 255 : 0;
  }
}

// ---------------------------------------------------------------------------
// Morphology: a program of erode/dilate stages with OpenCV's clip-to-image
// border (out-of-image = 255 for erode, 0 for dilate).
//
// prog layout (int32): n_stages, then per stage: op (0 erode, 1 dilate),
// n_groups, then per group: lo, hi, n_dy, dy_0 .. dy_{n_dy-1}. A group is a
// set of SE rows sharing the column window [lo, hi] (a rect SE is one
// group, i.e. separable).
//
// On bit planes an erode is an AND and a dilate an OR of shifted words. A
// column window within +-32 px is reduced in registers from three words by
// doubling (v op= v >> 1, >> 2, >> 4, ...): O(log reach) word operations.
// A stage whose every group has such a window and at most `pass_rows` row
// offsets (kDirectRows unless the caller passes fewer) runs in ONE pass over
// the words (the default close/open and the default ROI erode 6). Any other
// stage takes a pass per group: its column window once a word, into a
// scratch plane, then the row offsets from there (a rect's 13 rows read 13
// words, not 13 windows); a larger group (erode_px up to 200) runs the
// same doubling as passes over shared memory, for the columns and, where
// its rows are one contiguous run, for the rows: O(log reach) passes of a
// few words a thread.
// ---------------------------------------------------------------------------

constexpr int kDirectRows = 16;

// op over the pixels x + lo .. x + hi of the 32 pixels of word k (-32 <= lo
// <= hi <= 32), from the row's words k-1, k, k+1, by doubling in registers
__device__ inline uint32_t hwin_small(const uint32_t* row, int k, int lo, int hi,
                                      const Bits& g, bool erode) {
  const uint32_t nz = erode ? ~0u : 0u;
  const uint32_t prev = hload(row, k - 1, g, nz);
  const uint32_t cur = hload(row, k, g, nz);
  const uint32_t next = hload(row, k + 1, g, nz);
  uint32_t r = nz;
  if (hi >= 0) {
    // forward part: windows starting at x + s, s = max(lo, 0)
    const int s = max(lo, 0);
    const int len = hi - s + 1;
    uint64_t v = ((static_cast<uint64_t>(next) << 32) | cur) >> s;
    int p = 1;
    for (; 2 * p <= len; p <<= 1) v = op2(v, v >> p, erode);
    if (len > p) v = op2(v, v >> (len - p), erode);
    r = op2(r, static_cast<uint32_t>(v), erode);
  }
  if (lo < 0) {
    // backward part: windows ending at x + e, e = min(hi, 0)
    const int e = min(hi, 0);
    const int len = e - lo + 1;
    uint64_t v = ((static_cast<uint64_t>(cur) << 32) | prev) << (-e);
    int p = 1;
    for (; 2 * p <= len; p <<= 1) v = op2(v, v << p, erode);
    if (len > p) v = op2(v, v << (len - p), erode);
    r = op2(r, static_cast<uint32_t>(v >> 32), erode);
  }
  return r;
}

// word (y, k) of P shifted by s along `rows` (whole rows) or columns (bits),
// neutral outside the plane
__device__ inline uint32_t axis_read(const uint32_t* P, int y, int k, int s, bool rows,
                                     const Bits& g, uint32_t neutral) {
  if (rows) {
    const int yy = y + s;
    return (yy < 0 || yy >= g.H) ? neutral : P[yy * g.WW + k];
  }
  return hshift(P + y * g.WW, k, s, g, neutral);
}

// dst = (acc ? dst op : ) R, R[x] = op over the window of `len` positions
// starting (dir = +1) or ending (dir = -1) at x + off along the axis, with
// off >= 0 for dir = +1 and off <= 0 for dir = -1 (the window then never
// reaches past the plane on the side the doubling chain does not store).
// Doubling passes ping-pong between p0 and p1. Ends with a barrier.
__device__ inline void window_chain(const uint32_t* src, uint32_t* dst, uint32_t* p0,
                                    uint32_t* p1, int len, int off, int dir, bool rows,
                                    bool erode, bool acc, const Bits& g) {
  const uint32_t nz = erode ? ~0u : 0u;
  const uint32_t* cur = src;
  uint32_t* nxt = p0;
  int p = 1;
  for (; 2 * p <= len; p <<= 1) {
    for (int w = threadIdx.x; w < g.n; w += blockDim.x) {
      const int y = w / g.WW;
      const int k = w - y * g.WW;
      const uint32_t v = op2(cur[w], axis_read(cur, y, k, dir * p, rows, g, nz), erode);
      nxt[w] = v & word_mask(g, k);
    }
    __syncthreads();
    cur = nxt;
    nxt = (nxt == p0) ? p1 : p0;
  }
  for (int w = threadIdx.x; w < g.n; w += blockDim.x) {
    const int y = w / g.WW;
    const int k = w - y * g.WW;
    uint32_t v = axis_read(cur, y, k, off, rows, g, nz);
    if (len > p) v = op2(v, axis_read(cur, y, k, off + dir * (len - p), rows, g, nz), erode);
    if (acc) v = op2(dst[w], v, erode);
    dst[w] = v & word_mask(g, k);
  }
  __syncthreads();
}

// dst = (acc ? dst op : ) the window [lo, hi] along the axis of src.
// Ends with a barrier.
__device__ inline void window(const uint32_t* src, uint32_t* dst, uint32_t* p0, uint32_t* p1,
                              int lo, int hi, bool rows, bool erode, bool acc,
                              const Bits& g) {
  if (lo >= 0) {
    window_chain(src, dst, p0, p1, hi - lo + 1, lo, 1, rows, erode, acc, g);
  } else if (hi <= 0) {
    window_chain(src, dst, p0, p1, hi - lo + 1, hi, -1, rows, erode, acc, g);
  } else {
    window_chain(src, dst, p0, p1, hi + 1, 0, 1, rows, erode, acc, g);
    window_chain(src, dst, p0, p1, 1 - lo, 0, -1, rows, erode, true, g);
  }
}

__device__ inline bool group_is_small(int lo, int hi, int nd, int pass_rows) {
  return lo >= -32 && hi <= 32 && nd <= pass_rows;
}

// Runs the stage program on plane a; b, t, p0, p1 are scratch planes (t,
// p0 and p1 only for a stage not run in one pass). Returns the plane
// holding the result (a or b). Ends with a barrier.
__device__ inline uint32_t* apply_stages(const int* __restrict__ prog, uint32_t* a,
                                         uint32_t* b, uint32_t* t, uint32_t* p0,
                                         uint32_t* p1, const Bits& g,
                                         int pass_rows = kDirectRows) {
  int p = 0;
  const int n_stages = prog[p++];
  for (int s = 0; s < n_stages; ++s) {
    const bool erode = prog[p++] == 0;
    const int n_groups = prog[p++];
    const uint32_t nz = erode ? ~0u : 0u;
    const int p_groups = p;
    bool small = true;
    for (int q = 0; q < n_groups; ++q) {
      const int lo = prog[p], hi = prog[p + 1], nd = prog[p + 2];
      small = small && lo <= hi && group_is_small(lo, hi, nd, pass_rows);
      p += 3 + nd;
    }
    if (small) {
      // one pass: every group's rows and column window from registers
      for (int w = threadIdx.x; w < g.n; w += blockDim.x) {
        const int y = w / g.WW;
        const int k = w - y * g.WW;
        uint32_t v = nz;
        for (int q = 0, pp = p_groups; q < n_groups; ++q) {
          const int lo = prog[pp], hi = prog[pp + 1], nd = prog[pp + 2];
          for (int j = 0; j < nd; ++j) {
            const int yy = y + prog[pp + 3 + j];
            if (yy >= 0 && yy < g.H) v = op2(v, hwin_small(a + yy * g.WW, k, lo, hi, g, erode), erode);
          }
          pp += 3 + nd;
        }
        b[w] = v & word_mask(g, k);
      }
      __syncthreads();
    } else {
      for (int w = threadIdx.x; w < g.n; w += blockDim.x) b[w] = nz & word_mask(g, w % g.WW);
      __syncthreads();
      for (int q = 0, pp = p_groups; q < n_groups; ++q) {
        const int lo = prog[pp], hi = prog[pp + 1], nd = prog[pp + 2];
        const int* dys = prog + pp + 3;
        pp += 3 + nd;
        // t = the group's column window of a
        if (lo <= hi && lo >= -32 && hi <= 32) {
          for (int w = threadIdx.x; w < g.n; w += blockDim.x) {
            const int y = w / g.WW;
            const int k = w - y * g.WW;
            t[w] = hwin_small(a + y * g.WW, k, lo, hi, g, erode) & word_mask(g, k);
          }
          __syncthreads();
        } else {
          window(a, t, p0, p1, lo, hi, false, erode, false, g);
        }
        // b op= t over the group's row offsets
        const bool run = nd > 0 && dys[nd - 1] - dys[0] == nd - 1;
        if (run && nd > kDirectRows) {
          window(t, b, p0, p1, dys[0], dys[nd - 1], true, erode, true, g);
        } else {
          for (int w = threadIdx.x; w < g.n; w += blockDim.x) {
            const int y = w / g.WW;
            const int k = w - y * g.WW;
            uint32_t v = b[w];
            for (int j = 0; j < nd; ++j) {
              const int yy = y + dys[j];
              if (yy >= 0 && yy < g.H) v = op2(v, t[yy * g.WW + k], erode);
            }
            b[w] = v;
          }
          __syncthreads();
        }
      }
    }
    uint32_t* tmp = a;
    a = b;
    b = tmp;
  }
  return a;
}

// ---------------------------------------------------------------------------
// Exterior: background (m == 0) 4-connected to the plane border, as a bit
// plane E. Rounds of: each row closed along its free runs (a thread per
// row; the carry of an add runs across a free run: fill = ((f + s) ^ f) & f
// | s, once over the row's words, once over their bit reversal), then each
// column closed along its free runs (a segmented OR-scan by doubling, down
// then up, thread per word). Repeated until the column pass adds nothing:
// O(#bends) rounds, each a few thousand words of shared memory with every
// thread busy. The exterior is a set, so the order of the closures cannot
// change it. s0, s1, s2: scratch planes. Ends with a barrier.
// ---------------------------------------------------------------------------
__device__ inline uint32_t free_word(const uint32_t* m, int w, int k, const Bits& g) {
  return ~m[w] & word_mask(g, k);
}

__device__ inline void exterior(const uint32_t* m, uint32_t* E, uint32_t* s0, uint32_t* s1,
                                uint32_t* s2, const Bits& g) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const uint32_t top_bit = 1u << ((g.W - 1) & 31);
  for (int w = tid; w < g.n; w += nt) {
    const int y = w / g.WW;
    const int k = w - y * g.WW;
    const uint32_t f = free_word(m, w, k, g);
    uint32_t e = 0;
    if (y == 0 || y == g.H - 1) {
      e = f;
    } else {
      if (k == 0) e |= f & 1u;
      if (k == g.WW - 1) e |= f & top_bit;
    }
    E[w] = e;
  }
  __syncthreads();
  const int hw = g.H * g.W;
  for (int iter = 0; iter <= hw; ++iter) {
    // rows: forward, then over the bit-reversed row
    for (int y = tid; y < g.H; y += nt) {
      uint32_t* er = E + y * g.WW;
      const uint32_t* mr = m + y * g.WW;
      uint32_t carry = 0;
      for (int k = 0; k < g.WW; ++k) {
        const uint32_t f = ~mr[k] & word_mask(g, k);
        const uint32_t s = er[k];
        const uint64_t sum = static_cast<uint64_t>(f) + s + carry;
        const uint32_t x = static_cast<uint32_t>(sum);
        carry = static_cast<uint32_t>(sum >> 32);
        er[k] = ((x ^ f) & f) | s;
      }
      carry = 0;
      for (int k = g.WW - 1; k >= 0; --k) {
        const uint32_t f = __brev(~mr[k] & word_mask(g, k));
        const uint32_t s = __brev(er[k]);
        const uint64_t sum = static_cast<uint64_t>(f) + s + carry;
        const uint32_t x = static_cast<uint32_t>(sum);
        carry = static_cast<uint32_t>(sum >> 32);
        er[k] = __brev(((x ^ f) & f) | s);
      }
    }
    __syncthreads();
    // columns: R |= G & R[y -+ d], G &= G[y -+ d] (G: free all the way);
    // 2 * ceil(log2 H) passes, an even count, so R ends in E
    int changed = 0;
    uint32_t* R = E;
    uint32_t* Rn = s0;
    for (int dir = 1; dir >= -1; dir -= 2) {
      const uint32_t* G = nullptr;  // the free plane itself
      uint32_t* Gn = s1;
      for (int d = 1; d < g.H; d <<= 1) {
        for (int w = tid; w < g.n; w += nt) {
          const int y = w / g.WW;
          const int k = w - y * g.WW;
          const int yy = y - dir * d;
          const uint32_t r = R[w];
          const uint32_t gg = G ? G[w] : free_word(m, w, k, g);
          uint32_t r2 = r, g2 = 0;
          if (yy >= 0 && yy < g.H) {
            const int v = yy * g.WW + k;
            r2 = r | (gg & R[v]);
            g2 = gg & (G ? G[v] : free_word(m, v, k, g));
          }
          changed |= r2 != r;
          Rn[w] = r2;
          Gn[w] = g2;
        }
        __syncthreads();
        uint32_t* tr = R;
        R = Rn;
        Rn = tr;
        G = Gn;
        Gn = (Gn == s1) ? s2 : s1;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }
}

// ---------------------------------------------------------------------------
// Labeling
// ---------------------------------------------------------------------------

// word (y, k) of P, or of its complement within the plane (inv)
__device__ inline uint32_t plane_word(const uint32_t* P, int y, int k, bool inv,
                                      const Bits& g) {
  const uint32_t v = P[y * g.WW + k];
  return inv ? (~v & word_mask(g, k)) : v;
}

// the block code of block (by, bx) of P (or of its complement)
__device__ inline int code_at(const uint32_t* P, int by, int bx, bool inv, const Bits& g) {
  const int y = 2 * by;
  const int k = bx >> 4;
  const int sh = (bx & 15) << 1;
  int c = static_cast<int>((plane_word(P, y, k, inv, g) >> sh) & 3u);
  if (y + 1 < g.H) c |= static_cast<int>((plane_word(P, y + 1, k, inv, g) >> sh) & 3u) << 2;
  return c;
}

__device__ inline int code_of(const uint32_t* P, int b, bool inv, const Bits& g) {
  const int by = b / g.wb;
  return code_at(P, by, b - by * g.wb, inv, g);
}

// The 8-connected components of P's set pixels (of its complement with
// inv) on the block grid: afterwards par[b] is the root (the minimum block
// index of b's component) of every non-empty block b; empty blocks keep
// par[b] = b. A root walk past its bound sets *err (uf.cuh). Ends with a
// barrier.
template <bool kShared>
__device__ inline void label_blocks(const uint32_t* P, bool inv, int* par, const Bits& g,
                                    int* err) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int b = tid; b < g.nb; b += nt) par[b] = b;
  __syncthreads();
  // east edges: a thread per block row hangs each run of east-connected
  // blocks under its first block with plain stores, 16 blocks a word pair
  for (int by = tid; by < g.hb; by += nt) {
    int start = -1;
    int prev = 0;
    const int y = 2 * by;
    for (int k = 0; k < g.WW; ++k) {
      const uint32_t r0 = plane_word(P, y, k, inv, g);
      const uint32_t r1 = y + 1 < g.H ? plane_word(P, y + 1, k, inv, g) : 0u;
      if (!(r0 | r1)) {
        start = -1;
        prev = 0;
        continue;
      }
      const int n = min(16, g.wb - 16 * k);
      for (int j = 0; j < n; ++j) {
        const int c = static_cast<int>(((r0 >> (2 * j)) & 3u) | (((r1 >> (2 * j)) & 3u) << 2));
        const int b = by * g.wb + 16 * k + j;
        if (!c) {
          start = -1;
        } else if (start >= 0 && conn_e(prev, c)) {
          par[b] = start;
        } else {
          start = b;
        }
        prev = c;
      }
    }
  }
  __syncthreads();
  // south, south-east and south-west edges: lock-free unions
  for (int b = tid; b < g.nb; b += nt) {
    const int by = b / g.wb;
    if (by + 1 >= g.hb) continue;
    const int bx = b - by * g.wb;
    const int c = code_at(P, by, bx, inv, g);
    if (!c) continue;
    const int s = b + g.wb;
    if (conn_s(c, code_at(P, by + 1, bx, inv, g))) uf::unite<kShared>(par, b, s, g.nb, err);
    if (bx + 1 < g.wb && conn_se(c, code_at(P, by + 1, bx + 1, inv, g))) {
      uf::unite<kShared>(par, b, s + 1, g.nb, err);
    }
    if (bx > 0 && conn_sw(c, code_at(P, by + 1, bx - 1, inv, g))) {
      uf::unite<kShared>(par, b, s - 1, g.nb, err);
    }
  }
  __syncthreads();
  // resolve: roots are final now. The walk writes nothing: a halving
  // store racing with the owner's store of the root would leave a
  // non-root in the slot
  for (int b = tid; b < g.nb; b += nt) {
    if (code_of(P, b, inv, g)) {
      const int r = root_walk<kShared>(par, b, g.nb, err);
      if constexpr (kShared) {
        *reinterpret_cast<volatile int*>(par + b) = r;
      } else {
        par[b] = r;
      }
    }
  }
  __syncthreads();
}

// a parent read after label_blocks, once other threads' atomics may have
// changed root slots: from L2 (ld.global.cg) in a global scratch, where the
// SM's L1 could hold a stale line
template <bool kShared>
__device__ inline int ldp(const int* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldcg(p);
  }
}

// after label_blocks, a root slot may hold a negative payload (kernel A's
// area, kernel C's first pixel and top-level key): the label of block b
template <bool kShared>
__device__ inline int root_of(const int* par, int b) {
  const int v = ldp<kShared>(par + b);
  return v < 0 ? b : v;
}

// sum of the bit positions of v's set bits
__device__ inline int bit_pos_sum(uint32_t v) {
  return __popc(v & 0xAAAAAAAAu) + 2 * __popc(v & 0xCCCCCCCCu) + 4 * __popc(v & 0xF0F0F0F0u) +
         8 * __popc(v & 0xFF00FF00u) + 16 * __popc(v & 0xFFFF0000u);
}

}  // namespace tik
