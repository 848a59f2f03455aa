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
// would round differently from OpenCV. Each pixel's sequence of roundings
// is the one above; only which pixels share a thread changed.
//
// Modes: 0 writes the mean; 1 writes 255 where int(x) - mean <= -C, else 0
// (adaptive_threshold_inv: the mean never leaves the CTA).
//
// What bounds it on this card: operations. At block k a pixel takes k
// FMAs, a multiply, and (k - 1) / 2 adds and as many FMAs: 2k + 1 +
// 3 (k - 1) / 2 floating operations, an FMA counted as two (178 at the
// path's block 51; 4.8 M pixels of 48 units: 12.7 us at 67 TFLOP/s),
// above its bytes (each pixel read and written once: 2.9 us at 3.35 TB/s).
// The FP32 pipe issues one warp FFMA a clock a sub-partition, and shared
// memory serves one warp load a clock an SM: a design stays under its
// operation bound only below about 0.25 shared loads a FFMA.
//
// One launch a call: a CTA per strip of 64 columns and band of output rows
// of one unit, in one of two shapes (8 warps up to block 55, 6 up to 215);
// the host picks the band (tik_adaptive_mean: plan) so that the CTAs fill
// the SMs in whole waves, two a SM where the band's rows fit (a 315-row
// unit is one band up to block 201). The row-pass results of the band's
// rows plus pad rows each side (clamped to the plane) stay in shared
// memory, so each row pass runs once per band.
//
//   staging    a warp takes 4 input rows at a time: their bytes of the
//              strip and its 2 pad columns arrive by asynchronous copies
//              while the 4 rows before compute, then go to floats (the
//              clamp applied), element i of a row at (i % 8) P + i / 8, P
//              odd, so the 32 lanes below hit 32 banks.
//   row pass   lane (row rho, l) computes columns 8 l .. 8 l + 7 of its
//              row: 8 independent FMA chains over a window of 8 registers
//              that slides one element a step, the loop unrolled by 8 so
//              the window needs no moves; per 8 steps 8 loads of data and
//              2 broadcast float4 loads of taps feed 64 FFMAs (0.16 shared
//              loads a FFMA; the design before took 2).
//   column     a lane takes 2 adjacent columns (float2) and 8 output rows:
//              two windows of 8 rows, one sliding down (row r + t) and one
//              up (r - t), so a step loads one new float2 each and runs 16
//              adds and 16 FFMAs; per 8 steps 16 loads of data and 2 of taps
//              feed 128 FFMAs (0.14 a FFMA; before, 1.5). Row blocks whose
//              windows stay inside the staged rows skip the clamps; the
//              compare's input bytes of a block load while the block
//              before computes.

#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kStripW = 64;  // columns of a strip
constexpr int kBatch = 4;    // rows of a warp's row-pass batch: 8 lanes a row, 8 columns a lane
constexpr int kColRows = 8;  // output rows of a lane's column-pass block

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// The kernel's two shapes. Element i of a staged row sits at (i % 8) P +
// i / 8; P odd puts the row pass's 32 lanes (4 rows of 8) on 32 banks. A
// shape stages elements 0 .. kStripW + k - 1, so P bounds k; the warps are
// as many as let two CTAs share a SM at the band a 315-row unit needs.
template <int P, int kW>
struct Shape {
  static constexpr int kPhase = P;
  static constexpr int kWarps = kW;
  static constexpr int kThreads = 32 * kW;
  static constexpr int kStageRow = 8 * P;                  // floats a staged row
  static constexpr int kMaxK = kStageRow - kStripW - 1;
  static constexpr int kRawRow = (kStageRow + 4 + 15) & ~15;  // bytes a raw row
  // shared memory, in floats: row taps (k, zero-padded to 4s), column taps
  // tap[pad + 1 ..] (pad, padded), the warps' staging rows, their raw
  // rows (bytes as copied), the band's row sums
  __host__ __device__ static constexpr int stage_off(int k) { return round4(k) + round4(k / 2); }
  __host__ __device__ static constexpr int raw_off(int k) {
    return stage_off(k) + kW * kBatch * kStageRow;
  }
  __host__ __device__ static constexpr int band_off(int k) {
    return raw_off(k) + kW * kBatch * kRawRow / 4;
  }
};
using Small = Shape<15, 8>;  // blocks up to 55 (the path's 51)
using Large = Shape<35, 6>;  // blocks up to 215

// 8 output rows rb .. rb + 7 of a lane's 2 columns, from the centre product
// by symmetric pairs in t order; rows2[(q - lo) * 32] is row q's float2.
// kClamp: clamp the rows read into [lo, hi - 1] (the band's staged rows;
// for an output row of the band this is the plane's clamp)
template <bool kClamp>
__device__ __forceinline__ void column_block(const float2* rows2, const float* ctap, float ctr,
                                             int rb, int lo, int hi, int pad,
                                             float2 (&m)[kColRows]) {
  auto up = [&](int q) { return rows2[((kClamp ? min(q, hi - 1) : q) - lo) * 32]; };
  auto dn = [&](int q) { return rows2[((kClamp ? max(q, lo) : q) - lo) * 32]; };
  // at step t, U[i] is row rb + i + t and D[i] row rb + i - t (clamped)
  float2 U[kColRows], D[kColRows];
#pragma unroll
  for (int i = 0; i < kColRows; ++i) {
    const float2 c = up(rb + i);
    m[i] = make_float2(__fmul_rn(c.x, ctr), __fmul_rn(c.y, ctr));
    if (i > 0) U[i - 1] = c;
    if (i < kColRows - 1) D[i + 1] = c;
  }
  U[kColRows - 1] = up(rb + kColRows);
  D[0] = dn(rb - 1);
  auto step = [&](float tp) {
#pragma unroll
    for (int i = 0; i < kColRows; ++i) {
      m[i].x = __fmaf_rn(__fadd_rn(U[i].x, D[i].x), tp, m[i].x);
      m[i].y = __fmaf_rn(__fadd_rn(U[i].y, D[i].y), tp, m[i].y);
    }
  };
  auto slide = [&](int t) {  // step t -> t + 1
#pragma unroll
    for (int i = 0; i < kColRows - 1; ++i) U[i] = U[i + 1];
    U[kColRows - 1] = up(rb + kColRows + t);
#pragma unroll
    for (int i = kColRows - 1; i > 0; --i) D[i] = D[i - 1];
    D[0] = dn(rb - 1 - t);
  };
  int t = 1;
  for (; t + 7 <= pad; t += 8) {
    const float4 ta = *reinterpret_cast<const float4*>(ctap + t - 1);
    const float4 tb = *reinterpret_cast<const float4*>(ctap + t + 3);
    const float tp[8] = {ta.x, ta.y, ta.z, ta.w, tb.x, tb.y, tb.z, tb.w};
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      step(tp[s]);
      slide(t + s);
    }
  }
  for (; t <= pad; ++t) {
    step(ctap[t - 1]);
    slide(t);
  }
}

// A warp's batch of rows rb .. rb + kBatch - 1 (those below hi), in two
// steps. fetch: each row's bytes of the plane that the strip reads,
// columns cl .. ch, go by asynchronous 4-byte copies (from the aligned word
// that holds column cl) to the warp's raw rows, so they land while the
// batch before computes. convert: element i of a row, column c0 - pad + i
// clamped into [cl, ch] (the replicate border), as a float into the
// staging row, at (i % 8) P + i / 8 = (4 (lane % 2) + q) P + lane / 2 +
// 16 it for i = 4 lane + 128 it + q: an offset known to the compiler past
// the lane's base.
template <class S>
struct Rows {
  const uint8_t* xu;
  uint8_t* raw;
  int hi, W, cl, ch, lane;

  __device__ __forceinline__ int shift(int r) const {
    return static_cast<int>(reinterpret_cast<uintptr_t>(xu + static_cast<size_t>(r) * W + cl) & 3);
  }

  __device__ __forceinline__ void fetch(int rb) const {
#pragma unroll
    for (int rr = 0; rr < kBatch; ++rr) {
      if (rb + rr >= hi) break;
      const int sh = shift(rb + rr);
      const uint8_t* a0 = xu + static_cast<size_t>(rb + rr) * W + cl - sh;
      const int words = (sh + ch - cl + 4) >> 2;
      for (int w = lane; w < words; w += 32) {
        __pipeline_memcpy_async(raw + rr * S::kRawRow + 4 * w, a0 + 4 * w, 4);
      }
    }
    __pipeline_commit();
  }

  __device__ __forceinline__ void convert(float* stage, int rb, int c0, int pad,
                                          int last) const {
    float* dst = stage + 4 * (lane & 1) * S::kPhase + (lane >> 1);
#pragma unroll
    for (int rr = 0; rr < kBatch; ++rr) {
      if (rb + rr >= hi) break;
      const uint8_t* rw = raw + rr * S::kRawRow + shift(rb + rr) - cl;
#pragma unroll 1
      for (int it = 0; 128 * it <= last; ++it) {
        const int i0 = 4 * lane + 128 * it;
        float* d = dst + rr * S::kStageRow + 16 * it;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (i0 + q <= last) {
            const uint32_t byte = rw[min(max(c0 - pad + i0 + q, cl), ch)];
            // exact: 2^23 + byte - 2^23
            d[q * S::kPhase] = __fsub_rn(__uint_as_float(0x4b000000u | byte), 8388608.0f);
          }
        }
      }
    }
  }
};

// a lane's 2 input bytes at p (the second where two), in one 2-byte load
// where the address allows
__device__ __forceinline__ uint32_t load2(const uint8_t* p, bool two) {
  if (two && (reinterpret_cast<uintptr_t>(p) & 1) == 0) {
    return *reinterpret_cast<const uint16_t*>(p);
  }
  return p[0] | (two ? static_cast<uint32_t>(p[1]) << 8 : 0u);
}

// a lane's 2 output bytes of one row (the second where two), in one 2-byte
// store where the address allows; xv: the 2 input bytes (mode 1)
__device__ __forceinline__ void emit(uint8_t* o, bool two, float2 mv, uint32_t xv, int C,
                                     int mode) {
  int v0 = min(255, max(0, __float2int_rn(mv.x)));
  int v1 = min(255, max(0, __float2int_rn(mv.y)));
  if (mode) {
    v0 = static_cast<int>(xv & 255u) - v0 <= -C ? 255 : 0;
    v1 = two && static_cast<int>(xv >> 8) - v1 <= -C ? 255 : 0;
  }
  if (two && (reinterpret_cast<uintptr_t>(o) & 1) == 0) {
    *reinterpret_cast<uint16_t*>(o) = static_cast<uint16_t>(v0 | (v1 << 8));
  } else {
    o[0] = static_cast<uint8_t>(v0);
    if (two) o[1] = static_cast<uint8_t>(v1);
  }
}

template <class S>
__global__ void __launch_bounds__(S::kThreads, 2)
adaptive_mean_kernel(const uint8_t* __restrict__ x, const float* __restrict__ taps,
                     uint8_t* __restrict__ out, int H, int W, int k, int band, int C,
                     int mode) {
  extern __shared__ __align__(16) float smem[];
  const int pad = k >> 1;
  float* s_tap = smem;
  float* s_ctap = smem + round4(k);
  float* s_stage = smem + S::stage_off(k);
  float* s_row = smem + S::band_off(k);  // (hi - lo) x kStripW
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int u = blockIdx.z;
  const int c0 = blockIdx.x * kStripW;
  const int r0 = blockIdx.y * band;
  const int r1 = min(H, r0 + band);
  const int lo = max(0, r0 - pad);
  const int hi = min(H, r1 + pad);
  const uint8_t* xu = x + static_cast<size_t>(u) * H * W;

  for (int i = threadIdx.x; i < round4(k); i += S::kThreads) s_tap[i] = i < k ? taps[i] : 0.0f;
  for (int i = threadIdx.x; i < round4(pad); i += S::kThreads) {
    s_ctap[i] = i < pad ? taps[pad + 1 + i] : 0.0f;
  }
  __syncthreads();

  // row pass: warp w takes the batches of rows lo + 4 w, lo + 4 (w + kWarps), ...
  const int l = lane & 7;
  const int rho = lane >> 3;
  float* stage = s_stage + warp * kBatch * S::kStageRow;
  // element 8 l + m at win[(m % 8) P + m / 8]
  const float* win = stage + rho * S::kStageRow + l;
  // elements 0 .. last staged (the window's last slide reads last)
  const int last = kStripW + 2 * pad;
  const Rows<S> rows{xu,
                     reinterpret_cast<uint8_t*>(smem + S::raw_off(k)) + warp * kBatch * S::kRawRow,
                     hi, W, max(c0 - pad, 0), min(c0 - pad + last, W - 1), lane};
  if (lo + warp * kBatch < hi) rows.fetch(lo + warp * kBatch);
  for (int rb = lo + warp * kBatch; rb < hi; rb += S::kWarps * kBatch) {
    __pipeline_wait_prior(0);
    __syncwarp();
    rows.convert(stage, rb, c0, pad, last);
    __syncwarp();
    if (rb + S::kWarps * kBatch < hi) rows.fetch(rb + S::kWarps * kBatch);
    const int r = rb + rho;
    if (r < hi) {
      // acc[j] is column c0 + 8 l + j; at step t, w[j] is element 8 l + t + j
      float acc[8], w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j] = 0.0f;
        w[j] = win[j * S::kPhase];
      }
      int t = 0;
      for (; t + 8 <= k; t += 8) {
        const float4 ta = *reinterpret_cast<const float4*>(s_tap + t);
        const float4 tb = *reinterpret_cast<const float4*>(s_tap + t + 4);
        const float tp[8] = {ta.x, ta.y, ta.z, ta.w, tb.x, tb.y, tb.z, tb.w};
        const float* nxt = win + (t >> 3) + 1;  // element 8 l + t + 8 + s at nxt[s S::kPhase]
#pragma unroll
        for (int s = 0; s < 8; ++s) {
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[j] = __fmaf_rn(w[j], tp[s], acc[j]);
#pragma unroll
          for (int j = 0; j < 7; ++j) w[j] = w[j + 1];
          w[7] = nxt[s * S::kPhase];
        }
      }
      for (; t < k; ++t) {
        const float tp = s_tap[t];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = __fmaf_rn(w[j], tp, acc[j]);
#pragma unroll
        for (int j = 0; j < 7; ++j) w[j] = w[j + 1];
        w[7] = win[((t + 8) & 7) * S::kPhase + ((t + 8) >> 3)];
      }
      float* o = s_row + (r - lo) * kStripW + 8 * l;
      *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      *reinterpret_cast<float4*>(o + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
  }
  __syncthreads();

  // column pass: warp w takes the row blocks r0 + 8 w, r0 + 8 (w + kWarps), ...
  const int c = c0 + 2 * lane;
  const float2* rows2 = reinterpret_cast<const float2*>(s_row) + lane;
  const float ctr = s_tap[pad];
  const bool two = c + 1 < W;
  // the compare's input bytes of a row block (mode 1), loaded while the
  // block before computes
  auto load_x = [&](int rb, uint32_t (&xv)[kColRows]) {
#pragma unroll
    for (int i = 0; i < kColRows; ++i) {
      xv[i] = mode && c < W && rb + i < r1
                  ? load2(xu + static_cast<size_t>(rb + i) * W + c, two) : 0u;
    }
  };
  uint32_t xn[kColRows];
  load_x(r0 + kColRows * warp, xn);
  for (int rb = r0 + kColRows * warp; rb < r1; rb += kColRows * S::kWarps) {
    uint32_t xv[kColRows];
#pragma unroll
    for (int i = 0; i < kColRows; ++i) xv[i] = xn[i];
    if (rb + kColRows * S::kWarps < r1) load_x(rb + kColRows * S::kWarps, xn);
    float2 m[kColRows];
    if (rb - pad - 1 >= lo && rb + kColRows + pad < hi && rb + kColRows <= r1) {
      column_block<false>(rows2, s_ctap, ctr, rb, lo, hi, pad, m);
    } else {
      column_block<true>(rows2, s_ctap, ctr, rb, lo, hi, pad, m);
    }
    if (c < W) {
#pragma unroll
      for (int i = 0; i < kColRows; ++i) {
        if (rb + i < r1) {
          emit(out + (static_cast<size_t>(u) * H + rb + i) * W + c, two, m[i], xv[i], C, mode);
        }
      }
    }
  }
}

struct Plan {
  int band;
  int bands;
  size_t smem;
};

// The band: the grid is strips x bands x U CTAs, and a CTA's shared memory
// holds min(H, band + 2 pad) rows of row sums. Of the bands that fit, the
// one with the least modelled time: ceil(CTAs / SMs) CTAs a SM, each one
// CTA's work (its staged rows' row passes and its band's column passes),
// half again for a band that leaves one CTA a SM (its warps alone do not
// hide each other's latencies).
template <class S>
Plan plan(int U, int H, int W, int k) {
  static int sms = 0, sm_smem = 0, optin = 0, occ = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, adaptive_mean_kernel<S>, S::kThreads, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int pad = k / 2;
  const int strips = (W + kStripW - 1) / kStripW;
  const size_t fixed = sizeof(float) * S::band_off(k);
  Plan best{0, 0, 0};
  double best_cost = 0;
  int prev = 0;
  for (int nb = 1; nb <= H; ++nb) {
    const int band = (H + nb - 1) / nb;
    if (band == prev) continue;
    prev = band;
    const int bands = (H + band - 1) / band;
    const int rows = min(H, band + 2 * pad);
    const size_t smem = fixed + sizeof(float) * static_cast<size_t>(rows) * kStripW;
    if (smem <= static_cast<size_t>(optin) && bands <= 65535) {
      const int per_sm = min(occ, static_cast<int>(sm_smem / (smem + 1024)));
      const double ctas = static_cast<double>(strips) * bands * U;
      const double cost = static_cast<double>(static_cast<long long>((ctas + sms - 1) / sms)) *
                          (rows + band) * (per_sm >= 2 ? 1.0 : 1.5);
      if (best.band == 0 || cost < best_cost) {
        best = Plan{band, bands, smem};
        best_cost = cost;
      }
    }
    if (band <= kColRows) break;
  }
  return best;
}

template <class S>
int launch(const void* x, const void* taps, void* out, int U, int H, int W, int k, int C,
           int mode, cudaStream_t stream) {
  const Plan p = plan<S>(U, H, W, k);
  if (p.band == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (p.smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        adaptive_mean_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(p.smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const dim3 grid((W + kStripW - 1) / kStripW, p.bands, U);
  adaptive_mean_kernel<S><<<grid, S::kThreads, p.smem, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const float*>(taps),
      static_cast<uint8_t*>(out), H, W, k, p.band, C, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: [U, H, W] uint8; taps: [k] float32 (k odd, at most 215); mode 0:
// the mean, 1: the BINARY_INV compare against C
extern "C" int tik_adaptive_mean(const void* x, const void* taps, void* out, int U, int H, int W,
                                 int k, int C, int mode, void* stream) {
  if (U <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  if (k < 1 || k % 2 == 0 || k > Large::kMaxK || U > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return k <= Small::kMaxK ? launch<Small>(x, taps, out, U, H, W, k, C, mode, st)
                           : launch<Large>(x, taps, out, U, H, W, k, C, mode, st);
}
