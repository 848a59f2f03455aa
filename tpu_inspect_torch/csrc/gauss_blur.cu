// gauss_blur (kernel M): cv2.GaussianBlur(CV_8U, (k, k), sigma) bit-exact
// on Hopper (sm_90a), OpenCV's fixed-point path.
//
// A head kernel with no TPU counterpart: the JAX package computes the same
// blur with XLA ops (tpu_inspect/ops/gaussian.py: _sep_int_conv,
// gaussian_blur_u8; no pl.pallas_call); the port's plain version
// (ops/gaussian.py: gaussian_blur_u8_plain) runs it as int32 torch ops,
// about 20 launches a call at k = 3.
//
// Contract (the plain version's): taps m[0..k-1], int32, summing to 256
// (fixed_gaussian_kernel); BORDER_REFLECT_101 through the index tables the
// plain version gathers with (numpy's pad mode "reflect", which reflects
// again where the pad reaches past the far edge: a 1- or 2-px unit at
// k = 31); an int32 row pass (at most 65280 a pixel), an int32 column pass
// (at most 16.7 M), then (acc + 32768) >> 16 clamped to 255. Every sum is
// exact in int32, so the order of the taps is free.
//
// One launch a call: a CTA per tile of 32 output rows x 128 columns of one
// unit. It stages the tile's input plus its k - 1 halo rows and columns in
// shared memory as bytes (each source pixel read through the two tables),
// runs the row pass over all staged rows into an int32 tile in shared
// memory, then the column pass from it, and writes bytes.
//
// What bounds it on this card: bytes. The function reads each pixel once
// and writes it once (9.6 MB for 48 units of 315x316, 24.6 MB for a
// 3000x4096 capture: 2.9 and 7.3 us at 3.35 TB/s); its 2k integer
// multiply-adds a pixel (6 at the path's k = 3) stay under that at the
// int32 rate. The design rereads the halo (at k = 3, 6% more rows and 2%
// more columns) and keeps every intermediate in shared memory.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 128;  // output columns of a tile
constexpr int kTileH = 32;   // output rows of a tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
gauss_blur_kernel(const uint8_t* __restrict__ x, const int* __restrict__ taps,
                  const int* __restrict__ row_idx, const int* __restrict__ col_idx,
                  uint8_t* __restrict__ out, int H, int W, int k) {
  extern __shared__ int smem[];
  const int in_stride = kTileW + k - 1;
  int* s_tap = smem;                               // k
  int* s_row = s_tap + k;                          // (kTileH + k - 1) x kTileW
  uint8_t* s_in = reinterpret_cast<uint8_t*>(s_row + (kTileH + k - 1) * kTileW);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int u = blockIdx.z;
  const int r0 = blockIdx.y * kTileH;
  const int c0 = blockIdx.x * kTileW;
  const int rh = min(kTileH, H - r0);
  const int cw = min(kTileW, W - c0);
  const int in_rows = rh + k - 1;  // padded rows r0 .. r0 + rh + k - 2
  const int in_cols = cw + k - 1;
  const uint8_t* xu = x + static_cast<size_t>(u) * H * W;

  for (int i = threadIdx.x; i < k; i += kThreads) s_tap[i] = taps[i];
  // stage: padded (row, column) -> the source pixel the tables name
  for (int j = warp; j < in_rows; j += kWarps) {
    const uint8_t* xr = xu + static_cast<size_t>(row_idx[r0 + j]) * W;
    for (int c = lane; c < in_cols; c += 32) s_in[j * in_stride + c] = xr[col_idx[c0 + c]];
  }
  __syncthreads();
  // row pass over every staged row: tmp = sum_t m[t] * p[c + t]
  for (int j = warp; j < in_rows; j += kWarps) {
    const uint8_t* p = s_in + j * in_stride;
    for (int c = lane; c < cw; c += 32) {
      int acc = 0;
      for (int t = 0; t < k; ++t) acc += s_tap[t] * static_cast<int>(p[c + t]);
      s_row[j * kTileW + c] = acc;
    }
  }
  __syncthreads();
  // column pass: out = sum_t m[t] * tmp[r + t], rounded half up, >> 16
  for (int r = warp; r < rh; r += kWarps) {
    uint8_t* o = out + (static_cast<size_t>(u) * H + r0 + r) * W + c0;
    for (int c = lane; c < cw; c += 32) {
      const int* p = s_row + r * kTileW + c;
      int acc = 0;
      for (int t = 0; t < k; ++t) acc += s_tap[t] * p[t * kTileW];
      o[c] = static_cast<uint8_t>(min(255, (acc + 32768) >> 16));
    }
  }
}

}  // namespace

// x, out: [U, H, W] uint8; taps: [k] int32; row_idx: [H + 2 (k / 2)] and
// col_idx: [W + 2 (k / 2)] int32, the padded axes' source indices
extern "C" int tik_gauss_blur(const void* x, const void* taps, const void* row_idx,
                              const void* col_idx, void* out, int U, int H, int W, int k,
                              void* stream) {
  if (U <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  if (k < 1 || U > 65535 || (H + kTileH - 1) / kTileH > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(int) * (k + static_cast<size_t>(kTileH + k - 1) * kTileW) +
                      static_cast<size_t>(kTileH + k - 1) * (kTileW + k - 1);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        gauss_blur_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, U);
  gauss_blur_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const int*>(taps),
      static_cast<const int*>(row_idx), static_cast<const int*>(col_idx),
      static_cast<uint8_t*>(out), H, W, k);
  return static_cast<int>(cudaGetLastError());
}
