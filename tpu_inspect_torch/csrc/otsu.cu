// otsu: the per-unit 256-bin histogram and OpenCV's Otsu threshold scan on
// Hopper (sm_90a).
//
// A head kernel with no TPU counterpart: the JAX package computes the same
// histogram and scan with XLA ops on the accelerator
// (tpu_inspect/ops/threshold.py: histogram_u8, otsu_threshold_from_hist);
// the port's plain version runs the scan as host float64 torch ops.
//
// Two launches on the caller's stream:
//  1. histogram: a grid over (pixel chunk, unit). Each CTA counts its chunk
//     into one 256-bin histogram per warp in shared memory (so a unit of a
//     few grey levels does not serialise every thread on one bin), then adds
//     its bins into the unit's int64 row in global memory. A single
//     3000x4096 unit spreads over ~190 CTAs.
//  2. scan: one CTA of 32 threads per unit stages p_i and ip_i in shared
//     memory, then one thread runs getThreshVal_Otsu_8u's 256-step
//     recurrence in double, operation for operation as
//     ops/threshold.py:otsu_threshold_from_hist_plain does it: mu is the
//     exact int64 sum of h_i * i converted once and multiplied by scale
//     (1.0 / n, computed on the host as the plain version computes it);
//     p_i = h_i * scale, ip_i = i * p_i; the FLT_EPSILON guard skips the
//     update; a strict '>' keeps the first maximum. Every product, sum and
//     quotient is an explicit round-to-nearest intrinsic (__dmul_rn, ...),
//     which nvcc never contracts into an FMA, so the result is exact
//     whatever -fmad the build passes.
//
// What bounds it on this card: the histogram reads each pixel once (4.8 MB
// for 48 units of 315x316, 12.3 MB for one whole capture: 1.4 and 3.7 us at
// 3.35 TB/s); the scan is 256 dependent double steps per unit, a multiply,
// an add and a divide each on the loop-carried chain: latency, not bytes
// or operations, so its inputs are staged where no step waits on a global
// load.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kHistThreads = 256;
constexpr int kHistWarps = kHistThreads / 32;
constexpr int kChunk = 1 << 16;  // pixels per histogram CTA

__global__ void __launch_bounds__(kHistThreads)
hist_kernel(const uint8_t* __restrict__ x, unsigned long long* __restrict__ hist,
            long long hw) {
  __shared__ unsigned int s_h[kHistWarps][256];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  for (int i = tid; i < kHistWarps * 256; i += kHistThreads) (&s_h[0][0])[i] = 0u;
  __syncthreads();
  const int u = blockIdx.y;
  const long long lo = static_cast<long long>(blockIdx.x) * kChunk;
  const long long hi = min(hw, lo + kChunk);
  const uint8_t* xu = x + static_cast<size_t>(u) * hw;
  unsigned int* h = s_h[warp];
  // 4 pixels a load where the unit's chunk starts on a 4-byte boundary
  // (kChunk is a multiple of 4, so that is the unit's own alignment)
  const bool aligned = (reinterpret_cast<uintptr_t>(xu) & 3u) == 0u;
  long long i = lo;
  if (aligned) {
    const long long n4 = (hi - lo) >> 2;
    const uint32_t* x4 = reinterpret_cast<const uint32_t*>(xu + lo);
    for (long long j = tid; j < n4; j += kHistThreads) {
      const uint32_t v = x4[j];
      atomicAdd(&h[v & 0xFFu], 1u);
      atomicAdd(&h[(v >> 8) & 0xFFu], 1u);
      atomicAdd(&h[(v >> 16) & 0xFFu], 1u);
      atomicAdd(&h[v >> 24], 1u);
    }
    i = lo + 4 * n4;
  }
  for (long long j = i + tid; j < hi; j += kHistThreads) atomicAdd(&h[xu[j]], 1u);
  __syncthreads();
  for (int b = tid; b < 256; b += kHistThreads) {
    unsigned int c = 0;
    for (int w = 0; w < kHistWarps; ++w) c += s_h[w][b];
    if (c) atomicAdd(&hist[static_cast<size_t>(u) * 256 + b], static_cast<unsigned long long>(c));
  }
}

// one CTA of 32 threads per unit: the threads stage the unit's p_i and
// ip_i in shared memory and sum mu exactly (an integer, so in any order);
// then thread 0 runs the recurrence from shared memory, so no step of the
// dependent chain waits on a global load
constexpr int kScanThreads = 32;

__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const long long* __restrict__ hist, int* __restrict__ thr, double scale) {
  __shared__ double s_p[256];
  __shared__ double s_ip[256];
  __shared__ unsigned long long s_mu;
  const int u = blockIdx.x;
  const long long* h = hist + static_cast<size_t>(u) * 256;
  if (threadIdx.x == 0) s_mu = 0ull;
  __syncthreads();
  unsigned long long mu_part = 0;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    const double p = __dmul_rn(static_cast<double>(h[i]), scale);
    s_p[i] = p;
    s_ip[i] = __dmul_rn(static_cast<double>(i), p);
    mu_part += static_cast<unsigned long long>(h[i]) * static_cast<unsigned long long>(i);
  }
  atomicAdd(&s_mu, mu_part);
  __syncthreads();
  if (threadIdx.x != 0) return;
  const double eps = 1.1920928955078125e-07;  // FLT_EPSILON
  const double one_m_eps = 1.0 - eps;          // exact in double
  const double mu = __dmul_rn(static_cast<double>(static_cast<long long>(s_mu)), scale);
  double q1 = 0.0, mu1 = 0.0, max_sigma = 0.0;
  int max_val = 0;
  for (int i = 0; i < 256; ++i) {
    mu1 = __dmul_rn(mu1, q1);
    q1 = __dadd_rn(q1, s_p[i]);
    const double q2 = __dsub_rn(1.0, q1);
    if (fmin(q1, q2) < eps || fmax(q1, q2) > one_m_eps) continue;
    mu1 = __ddiv_rn(__dadd_rn(mu1, s_ip[i]), q1);
    const double mu2 = __ddiv_rn(__dsub_rn(mu, __dmul_rn(q1, mu1)), q2);
    const double d = __dsub_rn(mu1, mu2);
    const double sigma = __dmul_rn(__dmul_rn(__dmul_rn(q1, q2), d), d);
    if (sigma > max_sigma) {
      max_sigma = sigma;
      max_val = i;
    }
  }
  thr[u] = max_val;
}

}  // namespace

// x: [U, hw] uint8; hist: [U, 256] int64, zeroed by the caller
extern "C" int tik_histogram(const void* x, void* hist, int U, long long hw,
                             void* stream) {
  if (U > 0 && hw > 0) {
    const dim3 grid(static_cast<unsigned>((hw + kChunk - 1) / kChunk), static_cast<unsigned>(U));
    hist_kernel<<<grid, kHistThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<unsigned long long*>(hist), hw);
  }
  return static_cast<int>(cudaGetLastError());
}

// hist: [U, 256] int64; thr: [U] int32; scale = 1.0 / n
extern "C" int tik_otsu_scan(const void* hist, void* thr, int U, double scale,
                             void* stream) {
  if (U > 0) {
    scan_kernel<<<U, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(hist), static_cast<int*>(thr), scale);
  }
  return static_cast<int>(cudaGetLastError());
}
