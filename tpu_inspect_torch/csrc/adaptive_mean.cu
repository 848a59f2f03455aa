// adaptive_mean (kernel N): the uint8 Gaussian local mean of
// cv2.adaptiveThreshold(ADAPTIVE_THRESH_GAUSSIAN_C) on Hopper (sm_90a), in
// OpenCV's rounding order, with the THRESH_BINARY_INV compare fused.
//
// A head kernel with no TPU counterpart: the JAX package computes its mean
// with XLA ops (tpu_inspect/ops/gaussian.py: adaptive_gaussian_mean,
// tpu_inspect/ops/threshold.py: adaptive_threshold_inv; no
// pl.pallas_call), rounding each tap alone. The contract here is the
// port's plain version (ops/gaussian.py: adaptive_gaussian_mean_plain),
// which rounds as OpenCV's AVX2/FMA3 float filters do and emulates each
// float32 fused multiply-add in float64 torch ops (some 400 launches a
// call at block 51). Here each step is the one instruction it stands for:
//
//   row pass   acc = 0; for t = 0..k-1:
//                acc = fma(float(x[clamp(c + t - pad)]), tap[t], acc)
//   column     out = row[r] * tap[pad]; for t = 1..pad:
//                out = fma(row[clamp(r + t)] + row[clamp(r - t)], tap[pad + t], out)
//   result     mean = saturate_u8(round half to even (out))
//
// BORDER_REPLICATE (clamped coordinates; pad > H or W happens). Every
// float step is an explicit round-to-nearest intrinsic (__fmaf_rn,
// __fmul_rn, __fadd_rn, __float2int_rn): nvcc contracts a plain a * b + c
// into an FMA wherever it likes (the build passes no -fmad flag), which
// would round differently from OpenCV.
//
// Modes: 0 writes the mean; 1 writes 255 where int(x) - mean <= -C, else 0
// (adaptive_threshold_inv: the mean never leaves the CTA).
//
// One launch a call: a CTA of 8 warps per strip of 32 columns and band of
// output rows of one unit. The row-pass results of the band's rows plus
// pad rows each side (clamped to the plane) stay in shared memory, so each
// row pass is computed once per band; a band is as tall as 384 staged rows
// allow (a 315-row unit is one band up to block 69). For the row pass each
// warp stages one input row's 32 + k - 1 columns (clamped) as floats in
// its own slice of shared memory, then each lane runs its column's k FMAs
// in order from shared memory.
//
// What bounds it on this card: operations. At block k a pixel takes k
// FMAs, a multiply, and (k - 1) / 2 adds and as many FMAs: 2k + 1 +
// 3 (k - 1) / 2 floating operations, an FMA counted as two (178 at the
// path's block 51; 4.8 M pixels of 48 units: 12.7 us at 67 TFLOP/s),
// above its bytes (each pixel read and written once: 2.9 us at 3.35 TB/s).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kStripW = 32;  // columns of a strip: one warp's lanes
constexpr int kWarps = 8;
constexpr int kThreads = kStripW * kWarps;
constexpr int kRowCap = 384;  // staged rows a band aims for (48 KB of floats)

__global__ void __launch_bounds__(kThreads)
adaptive_mean_kernel(const uint8_t* __restrict__ x, const float* __restrict__ taps,
                     uint8_t* __restrict__ out, int H, int W, int k, int band, int C,
                     int mode) {
  extern __shared__ float smem[];
  const int pad = k >> 1;
  const int in_cols = kStripW + k - 1;
  float* s_tap = smem;                       // k
  float* s_in = s_tap + k;                   // kWarps x in_cols: a row per warp
  float* s_row = s_in + kWarps * in_cols;    // (hi - lo) x kStripW
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int u = blockIdx.z;
  const int c0 = blockIdx.x * kStripW;
  const int r0 = blockIdx.y * band;
  const int r1 = min(H, r0 + band);
  const int lo = max(0, r0 - pad);
  const int hi = min(H, r1 + pad);
  const uint8_t* xu = x + static_cast<size_t>(u) * H * W;

  for (int i = threadIdx.x; i < k; i += kThreads) s_tap[i] = taps[i];
  __syncthreads();
  // row pass: warp w takes rows lo + w, lo + w + 8, ...
  float* my_in = s_in + warp * in_cols;
  for (int r = lo + warp; r < hi; r += kWarps) {
    const uint8_t* xr = xu + static_cast<size_t>(r) * W;
    for (int i = lane; i < in_cols; i += 32) {
      my_in[i] = static_cast<float>(xr[min(max(c0 - pad + i, 0), W - 1)]);
    }
    __syncwarp();
    float acc = 0.0f;
    for (int t = 0; t < k; ++t) acc = __fmaf_rn(my_in[lane + t], s_tap[t], acc);
    s_row[(r - lo) * kStripW + lane] = acc;
    __syncwarp();
  }
  __syncthreads();
  // column pass: from the centre product by symmetric pairs
  const int c = c0 + lane;
  if (c >= W) return;
  const float* col = s_row + lane;
  for (int r = r0 + warp; r < r1; r += kWarps) {
    const float* mid = col + (r - lo) * kStripW;
    float m = __fmul_rn(*mid, s_tap[pad]);
    if (r - pad >= 0 && r + pad < H) {
      for (int t = 1; t <= pad; ++t) {
        m = __fmaf_rn(__fadd_rn(mid[t * kStripW], mid[-t * kStripW]), s_tap[pad + t], m);
      }
    } else {
      for (int t = 1; t <= pad; ++t) {
        const float a = col[(min(r + t, H - 1) - lo) * kStripW];
        const float b = col[(max(r - t, 0) - lo) * kStripW];
        m = __fmaf_rn(__fadd_rn(a, b), s_tap[pad + t], m);
      }
    }
    const int mean = min(255, max(0, __float2int_rn(m)));
    const size_t at = (static_cast<size_t>(u) * H + r) * W + c;
    out[at] = mode ? (static_cast<int>(x[at]) - mean <= -C ? 255 : 0)
                   : static_cast<uint8_t>(mean);
  }
}

}  // namespace

// x, out: [U, H, W] uint8; taps: [k] float32 (k odd); mode 0: the mean,
// 1: the BINARY_INV compare against C
extern "C" int tik_adaptive_mean(const void* x, const void* taps, void* out, int U, int H, int W,
                                 int k, int C, int mode, void* stream) {
  if (U <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  const int pad = k / 2;
  // the band: as many output rows as keep its staged rows near kRowCap
  // (at least 32), or the whole unit where that fits
  int band = max(32, kRowCap - 2 * pad);
  if (band >= H) band = H;
  const int bands = (H + band - 1) / band;
  if (k < 1 || k % 2 == 0 || U > 65535 || bands > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = min(H, band + 2 * pad);
  const size_t smem = sizeof(float) * (k + static_cast<size_t>(kWarps) * (kStripW + k - 1) +
                                       static_cast<size_t>(rows) * kStripW);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        adaptive_mean_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const dim3 grid((W + kStripW - 1) / kStripW, bands, U);
  adaptive_mean_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const float*>(taps),
      static_cast<uint8_t*>(out), H, W, k, band, C, mode);
  return static_cast<int>(cudaGetLastError());
}
