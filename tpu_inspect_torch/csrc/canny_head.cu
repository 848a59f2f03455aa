// canny_head (kernel O): cv2.Canny's gradient and non-maximum suppression
// (L1 gradient, aperture 3) on Hopper (sm_90a), with both thresholds, in
// one launch: the strong and candidate planes that kernel D's hysteresis
// takes.
//
// A head kernel with no TPU counterpart: the JAX package computes the same
// planes with XLA ops (tpu_inspect/ops/canny.py: _sobel3, canny_u8; no
// pl.pallas_call); the port's plain version (ops/canny.py:
// canny_planes_plain) runs them as some 45 int32 torch ops, each reading
// and writing whole planes.
//
// Contract (the plain version's), per pixel of x [U, H, W] uint8:
//
//   gx, gy   Sobel 3x3 in int32, BORDER_REPLICATE (clamped coordinates)
//   mag      |gx| + |gy|; a magnitude outside the plane is 0 (OpenCV's zero
//            border rows and columns in its NMS buffer), not replicated
//   sector   ax = |gx|, ay = |gy| << 15, tg22x = ax * 13573,
//            tg67x = tg22x + (ax << 16); horizontal where ay < tg22x,
//            vertical where not and ay > tg67x, else diagonal
//   keep     horizontal: mag > left && mag >= right
//            vertical:   mag > up && mag >= down
//            diagonal:   with pos = (gx ^ gy) >= 0 (zero counts positive),
//                        mag > (pos ? up-left : up-right) &&
//                        mag > (pos ? down-right : down-left)
//   out      cand = keep && mag > low; strong = cand && mag > high
//
// Everything is integer and every intermediate fits in int32 (ax * 13573
// <= 1.4e7, ax << 16 <= 6.7e7, mag <= 2040), so the order is free.
//
// One launch a call: a CTA of 16 groups of 16 threads per tile of 64
// output rows x 64 columns of one unit, a grid of tiles x tile rows x
// units (25 tiles a 315x316 unit, 1200 for 48 units; 3008 for a 3000x4096
// capture). Three steps:
//  1. staging: the tile and a halo of 2 as 4-byte words in shared memory,
//     a group a row and a thread a word (the two words past 16 a row by
//     other threads), every load of a thread issued before its first
//     store. A word whose
//     four columns lie in the plane is one aligned load, or two and a
//     funnel shift where the row is not 4-byte aligned (an odd width, a
//     view such as x[1:]); only the words that reach past the plane's left
//     or right edge go byte by byte, at clamped columns (BORDER_REPLICATE),
//     and the rows past its top or bottom are read at clamped rows.
//  2. Sobel once: a thread owns 4 adjacent columns and 4 rows. It slides a
//     3-row window of the row differences and sums (gx = d(r-1) + 2 d(r) +
//     d(r+1), gy = s(r+1) - s(r-1)) down its rows, three word loads a staged
//     row, computes each pixel's gradient once, writes the 4 magnitudes of
//     a row to shared memory in one 8-byte store (int16, 0 outside the
//     plane; the tile's first and last groups also the halo rows above and
//     below; the halo columns first, a position a thread) and keeps, for
//     each own pixel, its sector as a byte naming the two neighbours NMS
//     compares it with (4 registers).
//  3. NMS, after one barrier: each thread loads a row's 4 magnitudes in one
//     8-byte load and each pixel's two neighbours by the offset its byte
//     names (no branch), and writes cand and strong as one 4-byte store
//     each per row (bytes at a plane's right edge or where rows are not
//     4-byte aligned).
//
// What bounds it on this card: bytes, in the model. The function reads each
// input pixel once and writes two bool planes (14.3 MB for 48 units of
// 315x316, 36.9 MB for a 3000x4096 capture: 4.28 and 11.0 us at 3.35
// TB/s). On the card the issue of its instructions holds it first (a few
// dozen a pixel, Sobel and the sector test the most), so each is done once
// a pixel, and six CTAs a SM hide each other's staging. The tile's halo
// rereads 19% more input bytes, from L2 mostly.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kQuads = 16;               // 4-column quads of a tile row
constexpr int kGroups = 16;              // row groups of kQuads threads
constexpr int kThreads = kQuads * kGroups;
constexpr int kRows = 4;                 // output rows a thread
constexpr int kTileW = 4 * kQuads;       // output columns of a tile
constexpr int kTileH = kRows * kGroups;  // output rows of a tile
// staged input: rows r0 - 2 .. r0 + kTileH + 1; word w of a row holds
// columns c0 - 4 + 4 w .. + 3. The strides (in 4-byte words, 4 mod 8) put
// a warp's two groups, 4 rows apart, 16 banks apart.
constexpr int kInRows = kTileH + 4;
constexpr int kInWords = kQuads + 2;
constexpr int kInStride = kInWords + 2;
// magnitudes: rows r0 - 1 .. r0 + kTileH at rows 0 .. kTileH + 1; column
// c0 + c at index c + 4 (c = -1 .. kTileW), so a quad's 4 lie on 8 bytes
constexpr int kMagRows = kTileH + 2;
constexpr int kMagStride = kTileW + 8;
static_assert(kInStride % 8 == 4 && (kMagStride / 2) % 8 == 4, "bank spread");
constexpr int kRowSlots = (kInRows + kGroups - 1) / kGroups;  // staged rows a group
constexpr int kEdgeSlots = (2 * kInRows + kThreads - 1) / kThreads;  // words 16, 17 a thread
constexpr int kTg22 = 13573;  // tan(22.5 deg) * 2^15, OpenCV's CANNY_SHIFT fixed point

// one staged word in flight: lo, up, a word read in the plane (two aligned
// words, shifted by the address's misalignment, kept in eb); eb, a word
// that reaches past the plane's left or right edge, byte by byte at
// clamped columns (each aligned word read holds a byte of the plane, so
// none leaves the allocation)
struct Word {
  uint32_t lo, up, eb;
};

__device__ __forceinline__ Word load_word(const uint8_t* xr, int col, int W, bool ok) {
  Word w{0u, 0u, 0u};
  const bool inner = col >= 0 && col + 4 <= W;
  const uintptr_t a = reinterpret_cast<uintptr_t>(xr + col);
  const uint32_t* p = reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3});
  if (ok && inner) {
    w.lo = __ldg(p);
    w.eb = static_cast<uint32_t>(a & 3);
    if (a & 3) w.up = __ldg(p + 1);
  } else if (ok) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      w.eb |= static_cast<uint32_t>(xr[min(max(col + b, 0), W - 1)]) << (8 * b);
    }
  }
  return w;
}

__device__ __forceinline__ uint32_t word_of(const Word& w, int col, int W) {
  return col >= 0 && col + 4 <= W ? __funnelshift_r(w.lo, w.up, 8 * w.eb) : w.eb;
}

// at most 40 registers: six CTAs a SM, whose warps hide each other's staging
__global__ void __launch_bounds__(kThreads, 6)
canny_head_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ strong,
                  uint8_t* __restrict__ cand, int H, int W, int u0, int low, int high) {
  __shared__ uint32_t s_in[kInRows * kInStride];
  __shared__ __align__(8) int16_t s_mag[kMagRows * kMagStride];
  const int q = threadIdx.x % kQuads;
  const int g = threadIdx.x / kQuads;
  const int r0 = blockIdx.y * kTileH;
  const int c0 = blockIdx.x * kTileW;
  const int rh = min(kTileH, H - r0);
  const int cw = min(kTileW, W - c0);
  const size_t unit = static_cast<size_t>(u0 + blockIdx.z) * H * W;
  const uint8_t* xu = x + unit;

  // 1. staging: rows 0 .. rh + 3 and words 0 .. (cw + 5) / 4 of them;
  // group g rows g, g + kGroups, ..., thread q word q of each, and thread
  // t word 16 + (t + n kThreads) % 2 of row (t + n kThreads) / 2
  const int in_rows = rh + 4;
  const int in_words = min(kInWords, (cw + 5) / 4 + 1);
  Word w[kRowSlots + kEdgeSlots];
#pragma unroll
  for (int n = 0; n < kRowSlots; ++n) {
    const int j = g + n * kGroups;
    const uint8_t* xr = xu + min(max(r0 - 2 + j, 0), H - 1) * W;
    w[n] = load_word(xr, c0 - 4 + 4 * q, W, j < in_rows && q < in_words);
  }
#pragma unroll
  for (int n = 0; n < kEdgeSlots; ++n) {
    const int j = (threadIdx.x + n * kThreads) >> 1;
    const int wi = kQuads + (threadIdx.x & 1);
    const uint8_t* xr = xu + min(max(r0 - 2 + j, 0), H - 1) * W;
    w[kRowSlots + n] = load_word(xr, c0 - 4 + 4 * wi, W, j < in_rows && wi < in_words);
  }
#pragma unroll
  for (int n = 0; n < kRowSlots; ++n) {
    const int j = g + n * kGroups;
    if (j < in_rows && q < in_words) s_in[j * kInStride + q] = word_of(w[n], c0 - 4 + 4 * q, W);
  }
#pragma unroll
  for (int n = 0; n < kEdgeSlots; ++n) {
    const int j = (threadIdx.x + n * kThreads) >> 1;
    const int wi = kQuads + (threadIdx.x & 1);
    if (j < in_rows && wi < in_words) {
      s_in[j * kInStride + wi] = word_of(w[kRowSlots + n], c0 - 4 + 4 * wi, W);
    }
  }
  __syncthreads();

  // 2. Sobel once, the halo columns first: tile columns -1 and kTileW of
  // rows -1 .. rh, a position a thread, from the staged bytes (tile column
  // c is byte c + 4 of a staged row)
  const uint8_t* in_b = reinterpret_cast<const uint8_t*>(s_in);
  for (int p = threadIdx.x; p < 2 * (kTileH + 2); p += kThreads) {
    const int col = (p & 1) ? kTileW : -1;
    const int i = (p >> 1) - 1;
    if (i > rh) continue;
    int m = 0;
    if (r0 + i >= 0 && r0 + i < H && c0 + col >= 0 && c0 + col < W) {
      const uint8_t* b = in_b + (i + 1) * 4 * kInStride + col + 3;  // rows i - 1 .. i + 1
      const uint8_t* b2 = b + 2 * 4 * kInStride;
      const int gx = (b[2] - b[0]) + 2 * (b[4 * kInStride + 2] - b[4 * kInStride]) + (b2[2] - b2[0]);
      const int gy = (b2[0] - b[0]) + 2 * (b2[1] - b[1]) + (b2[2] - b[2]);
      m = abs(gx) + abs(gy);
    }
    s_mag[(i + 1) * kMagStride + col + 4] = static_cast<int16_t>(m);
  }
  // Then the tile: magnitude row t of this thread is tile row g kRows + t,
  // t = -1 .. kRows (the halo rows only in the first and last group); its
  // staged rows are t + 1 .. t + 3 of the window. Each own pixel keeps its
  // NMS neighbours as one byte e = 2 off + ns: the second neighbour lies
  // off magnitudes past it and the first off before (1 horizontal,
  // kMagStride vertical, kMagStride + 1 diagonal with pos, kMagStride - 1
  // without), ns = 1 where the second compares with >= (horizontal and
  // vertical); 2 off is also the offset in bytes
  const int row0 = g * kRows;
  const uint32_t* in = s_in + row0 * kInStride + q;
  const int lim = W - c0 - 4 * q;  // columns 0 .. lim - 1 of this quad lie in the plane
  const bool full = lim >= 4;      // all 4
  int dw[3][4], sw[3][4];          // the window's row differences and sums
  uint32_t nbr[kRows];             // own pixels' e bytes, row t's in nbr[t]
#pragma unroll
  for (int k = 0; k < kRows + 4; ++k) {
    const uint32_t w0 = in[k * kInStride];
    const uint32_t w1 = in[k * kInStride + 1];
    const uint32_t w2 = in[k * kInStride + 2];
    int v[6];  // columns 4q - 1 .. 4q + 4
    v[0] = static_cast<int>(w0 >> 24);
#pragma unroll
    for (int b = 0; b < 4; ++b) v[b + 1] = static_cast<int>(__byte_perm(w1, 0u, 0x4440 + b));
    v[5] = static_cast<int>(w2 & 0xffu);
    int* d = dw[k % 3];
    int* s = sw[k % 3];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      d[c] = v[c + 2] - v[c];
      s[c] = v[c] + v[c + 2] + 2 * v[c + 1];
    }
    const int t = k - 3;  // the magnitude row whose window is now whole
    if (k < 2) continue;
    const bool own = t >= 0 && t < kRows;
    if (!own && !(t < 0 && g == 0) && !(t == kRows && g == kGroups - 1)) continue;
    const int i = row0 + t;  // tile row
    if (i > rh) continue;
    const int* du = dw[(k + 1) % 3];  // row k - 2
    const int* dm = dw[(k + 2) % 3];  // row k - 1
    const int* su = sw[(k + 1) % 3];
    const bool keep_row = full && r0 + i >= 0 && r0 + i < H;
    uint32_t m[4];
    uint32_t e4 = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gx = du[c] + d[c] + 2 * dm[c];
      const int gy = s[c] - su[c];
      const int ax = abs(gx);
      const int ay = abs(gy);
      m[c] = static_cast<uint32_t>(ax + ay);
      if (own) {
        // OpenCV's sector test: ay 2^15 against ax tan(22.5) 2^15 and ax
        // tan(67.5) 2^15 = ax 13573 + (ax << 16)
        uint32_t e = (gx ^ gy) >= 0 ? 2 * (kMagStride + 1) : 2 * (kMagStride - 1);
        e = (ay << 15) > ax * (kTg22 + 65536) ? 2 * kMagStride + 1 : e;
        e = (ay << 15) < ax * kTg22 ? 3u : e;
        e4 |= e << (8 * c);
      }
    }
    if (own) nbr[t] = e4;
    if (!keep_row) {  // a row outside the plane, or columns past its edge: 0
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (!(r0 + i >= 0 && r0 + i < H && c < lim)) m[c] = 0u;
      }
    }
    *reinterpret_cast<uint2*>(s_mag + (i + 1) * kMagStride + 4 * q + 4) =
        make_uint2(m[0] | (m[1] << 16), m[2] | (m[3] << 16));
  }
  __syncthreads();

  // 3. NMS and the thresholds: each own pixel against its two neighbours
  if (lim <= 0) return;
  const int n_out = min(4, lim);
  const int at0 = (r0 + row0) * W + c0 + 4 * q;  // the thread's first pixel in its unit
  uint8_t* cu = cand + unit + at0;
  uint8_t* su_ = strong + unit + at0;
  // every row's 4 bytes on one 4-byte word
  const bool words = full && ((reinterpret_cast<uintptr_t>(cu) | W) & 3) == 0;
  const uint8_t* mrow = reinterpret_cast<const uint8_t*>(s_mag + (row0 + 1) * kMagStride + 4 * q + 4);
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    if (row0 + t >= rh) break;
    const uint8_t* mp = mrow + t * 2 * kMagStride;  // the row's own 4, as bytes
    const uint2 own = *reinterpret_cast<const uint2*>(mp);
    uint32_t vc = 0, vs = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int v = static_cast<int>(__byte_perm(c < 2 ? own.x : own.y, 0u,
                                                 (c & 1) ? 0x4432 : 0x4410));
      const uint32_t e = __byte_perm(nbr[t], 0u, 0x4440 + c);
      const int off = static_cast<int>(e & 0xfeu);  // bytes
      const int a = *reinterpret_cast<const int16_t*>(mp + 2 * c - off);
      const int b = *reinterpret_cast<const int16_t*>(mp + 2 * c + off) - static_cast<int>(e & 1u);
      const bool is_cand = (v > a) & (v > b) & (v > low);  // both loads at once
      vc |= is_cand ? 1u << (8 * c) : 0u;
      vs |= is_cand && v > high ? 1u << (8 * c) : 0u;
    }
    if (words) {
      *reinterpret_cast<uint32_t*>(cu + t * W) = vc;
      *reinterpret_cast<uint32_t*>(su_ + t * W) = vs;
    } else {
      for (int c = 0; c < n_out; ++c) {
        cu[t * W + c] = static_cast<uint8_t>(vc >> (8 * c));
        su_[t * W + c] = static_cast<uint8_t>(vs >> (8 * c));
      }
    }
  }
}

}  // namespace

// x: [U, H, W] uint8; strong, cand: [U, H, W] bool (bytes 0/1); low <= high
extern "C" int tik_canny_head(const void* x, void* strong, void* cand, int U, int H, int W,
                              int low, int high, void* stream) {
  if (U <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  const long long tiles_y = (H + kTileH - 1) / kTileH;
  if (static_cast<long long>(H) * W > 0x7fffffffLL || tiles_y > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kThreads);
  for (int u0 = 0; u0 < U; u0 += 65535) {  // the grid's z takes at most 65535 units
    const dim3 grid((W + kTileW - 1) / kTileW, static_cast<unsigned>(tiles_y),
                    static_cast<unsigned>(min(U - u0, 65535)));
    canny_head_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<uint8_t*>(strong),
        static_cast<uint8_t*>(cand), H, W, u0, low, high);
  }
  return static_cast<int>(cudaGetLastError());
}
