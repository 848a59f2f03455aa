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
// One launch a call: a CTA per tile of 32 output rows x 64 columns of one
// unit, the tiles of every unit in one flat grid. It stages the tile's
// input plus a halo of 2 as bytes (clamped coordinates), computes the
// magnitude of the tile plus a halo of 1 into shared memory as int16 (0
// where a halo position lies outside the plane), then each thread runs the
// sector test on its own pixels, its gradient taken again from the staged
// bytes, and writes both planes as bytes 0/1.
//
// What bounds it on this card: bytes. The function reads each input pixel
// once and writes two bool planes (14.3 MB for 48 units of 315x316, 36.9 MB
// for a 3000x4096 capture: 4.28 and 11.0 us at 3.35 TB/s); its some 40
// integer operations a pixel stay under that at the int32 rate. The design
// rereads the halo (19% more input bytes at this tile) and keeps every
// intermediate in shared memory.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 64;  // output columns of a tile
constexpr int kTileH = 32;  // output rows of a tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kInW = kTileW + 4;   // staged input: the tile and a halo of 2
constexpr int kInH = kTileH + 4;
constexpr int kMagW = kTileW + 2;  // magnitudes: the tile and a halo of 1
constexpr int kMagH = kTileH + 2;
constexpr int kTg22 = 13573;  // tan(22.5 deg) * 2^15, OpenCV's CANNY_SHIFT fixed point

// Sobel dx and dy at staged position (j, c): p points at row j - 1, column
// c - 1 of the staged bytes (the 3x3 window's top-left corner)
__device__ __forceinline__ void sobel3(const uint8_t* p, int& gx, int& gy) {
  const int a = p[0], b = p[1], c = p[2];
  const int d = p[kInW], f = p[kInW + 2];
  const int g = p[2 * kInW], h = p[2 * kInW + 1], i = p[2 * kInW + 2];
  gx = (c - a) + 2 * (f - d) + (i - g);
  gy = (g - a) + 2 * (h - b) + (i - c);
}

__global__ void __launch_bounds__(kThreads)
canny_head_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ strong,
                  uint8_t* __restrict__ cand, int H, int W, int tiles_x, int tiles_y,
                  int low, int high) {
  __shared__ uint8_t s_in[kInH * kInW];
  __shared__ int16_t s_mag[kMagH * kMagW];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.x;
  const int tx = tile % tiles_x;
  const int ty = (tile / tiles_x) % tiles_y;
  const int u = tile / tiles_x / tiles_y;
  const int r0 = ty * kTileH;
  const int c0 = tx * kTileW;
  const int rh = min(kTileH, H - r0);
  const int cw = min(kTileW, W - c0);
  const size_t plane = static_cast<size_t>(H) * W;
  const uint8_t* xu = x + static_cast<size_t>(u) * plane;

  // stage rows r0 - 2 .. r0 + rh + 1 and columns c0 - 2 .. c0 + cw + 1,
  // each read at its clamped coordinate (BORDER_REPLICATE)
  for (int j = warp; j < rh + 4; j += kWarps) {
    const int r = min(max(r0 - 2 + j, 0), H - 1);
    const uint8_t* xr = xu + static_cast<size_t>(r) * W;
    for (int c = lane; c < cw + 4; c += 32) {
      s_in[j * kInW + c] = xr[min(max(c0 - 2 + c, 0), W - 1)];
    }
  }
  __syncthreads();
  // magnitudes of rows r0 - 1 .. r0 + rh and columns c0 - 1 .. c0 + cw: a
  // position outside the plane holds 0 (the NMS zero border)
  for (int i = warp; i < rh + 2; i += kWarps) {
    const int r = r0 - 1 + i;
    for (int c = lane; c < cw + 2; c += 32) {
      const int col = c0 - 1 + c;
      int m = 0;
      if (r >= 0 && r < H && col >= 0 && col < W) {
        int gx, gy;
        sobel3(s_in + i * kInW + c, gx, gy);
        m = abs(gx) + abs(gy);
      }
      s_mag[i * kMagW + c] = static_cast<int16_t>(m);
    }
  }
  __syncthreads();
  // the sector test and the comparisons, one output pixel a thread a step
  for (int i = warp; i < rh; i += kWarps) {
    const size_t row = static_cast<size_t>(u) * plane + static_cast<size_t>(r0 + i) * W + c0;
    for (int c = lane; c < cw; c += 32) {
      int gx, gy;
      sobel3(s_in + (i + 1) * kInW + c + 1, gx, gy);
      const int16_t* m = s_mag + (i + 1) * kMagW + c + 1;  // the pixel's magnitude
      const int mag = m[0];
      const int ax = abs(gx);
      const int ay = abs(gy) << 15;
      const int tg22x = ax * kTg22;
      const int tg67x = tg22x + (ax << 16);
      bool keep;
      if (ay < tg22x) {
        keep = mag > m[-1] && mag >= m[1];
      } else if (ay > tg67x) {
        keep = mag > m[-kMagW] && mag >= m[kMagW];
      } else {
        const bool pos = (gx ^ gy) >= 0;
        keep = mag > (pos ? m[-kMagW - 1] : m[-kMagW + 1]) &&
               mag > (pos ? m[kMagW + 1] : m[kMagW - 1]);
      }
      const bool is_cand = keep && mag > low;
      cand[row + c] = is_cand;
      strong[row + c] = is_cand && mag > high;
    }
  }
}

}  // namespace

// x: [U, H, W] uint8; strong, cand: [U, H, W] bool (bytes 0/1); low <= high
extern "C" int tik_canny_head(const void* x, void* strong, void* cand, int U, int H, int W,
                              int low, int high, void* stream) {
  if (U <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  const long long tiles_x = (W + kTileW - 1) / kTileW;
  const long long tiles_y = (H + kTileH - 1) / kTileH;
  const long long tiles = tiles_x * tiles_y * U;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  canny_head_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(strong),
      static_cast<uint8_t*>(cand), H, W, static_cast<int>(tiles_x), static_cast<int>(tiles_y),
      low, high);
  return static_cast<int>(cudaGetLastError());
}
