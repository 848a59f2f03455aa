// otsu: the per-unit 256-bin histogram and OpenCV's Otsu threshold scan on
// Hopper (sm_90a).
//
// A head kernel with no TPU counterpart: the JAX package computes the same
// histogram and scan with XLA ops on the accelerator
// (tpu_inspect/ops/threshold.py: histogram_u8, otsu_threshold_from_hist);
// the port's plain version runs the scan as host float64 torch ops.
//
// Two launches on the caller's stream:
//  1. histogram: a flat grid of per_unit CTAs a unit, each counting one
//     chunk of its unit (the host's plan, ops/threshold.py: hist_plan,
//     gives at least two CTAs a SM on the 48 units of 315x316 and on a
//     whole 3000x4096 capture). A thread issues four 16-byte loads before
//     its first atomic (bytes before the first 16-byte boundary of the
//     chunk and after its last go one by one: any unit alignment, any hw),
//     and adds each byte into its lane's own column of a 256 x 32 shared
//     histogram (bin b of lane l at word 32 b + l: the 32 lanes of a warp
//     never touch one word, so a near-constant unit does not serialise a
//     warp on one bin, and an atomic only meets the other warps' same
//     lane), a load of 16 equal bytes in one atomic. Merging every run of
//     equal bytes, or pairs, was slower on the card (PERF.md §6): the
//     shared atomics cost by the instruction, so a merge saves only where
//     it skips a whole warp's, and its compares cost more. The CTA then
//     sums the 32 columns of each bin and either adds the non-zero ones
//     into the unit's int64 row (one global atomic a bin; the rows zeroed
//     by the caller: histogram_u8) or writes all 256 as its own int32
//     partial row (otsu_threshold: no fill, the scan sums the partial
//     rows).
//  2. scan: a CTA of 512 threads a unit. The threads stage the counts (the
//     int64 row, or the sum of the unit's partial rows, 16 bytes a load),
//     p_i = h_i * scale, ip_i = i * p_i and the exact integer mu (in any
//     order: integers). getThreshVal_Otsu_8u carries two chains from step
//     to step, and thread 0 runs each alone: first q1 (adds only, 16 p_i
//     loaded ahead of their adds), then, after every thread has taken its
//     step's FLT_EPSILON guard, mu1 over the steps the guard leaves (mu1 =
//     mu1 * q1_old, then mu1 = (mu1 + ip_i) / q1_i), 8 steps' q1_i and
//     ip_i loaded into registers ahead of their steps, so no shared load
//     and no guard test waits on the chain. q1 never falls (p_i >= 0, and
//     rounding keeps the order) and q2 = 1 - q1 never rises, so the guard
//     holds on a prefix of the steps (q1 < eps or q2 > 1 - eps) and on a
//     suffix (q2 < eps or q1 > 1 - eps), and the steps it leaves are one
//     interval [i0, i1] (from the warps' ballots); on the prefix mu1 stays
//     0 (0 * q1 = 0), and after i1 no step reads mu1. Then every thread
//     takes one step i: mu2_i, d_i and sigma_i with the same operations,
//     and a block reduction keeps the largest sigma, the smallest i among
//     equals, and 0 where no sigma is above 0: the first maximum that
//     OpenCV's strict '>' from 0 keeps. Every product, sum and quotient is
//     an explicit round-to-nearest intrinsic (__dmul_rn, ...), which nvcc
//     never contracts into an FMA and never turns into a reciprocal: the
//     result is exact whatever -fmad the build passes, and equal to
//     ops/threshold.py: otsu_threshold_from_hist_plain's.
//
// What bounds it on this card: the histogram reads each pixel once (4.8 MB
// for 48 units of 315x316, 12.3 MB for one whole capture: 1.4 and 3.7 us at
// 3.35 TB/s), but its shared atomics, one instruction a warp for 32
// bytes, take longer than the bytes; the scan's mu1 chain is up to 256
// dependent steps of a multiply, an add and a divide per unit, run side by
// side for all units: its latency, not bytes or operations, is the scan's
// floor. Each __ddiv_rn ends in a branch to its slow path, and nvcc issues
// no later step's reciprocal ahead of that branch, so a step costs the
// whole division's latency (about 140 cycles on the H100).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kHistThreads = 256;
constexpr int kLoads = 4;  // 16-byte loads a thread issues before its first atomic

// adds the 16 bytes of w into the lane's column h (bin b at h[32 b]): one
// atomic where all 16 are equal, else one a byte
__device__ __forceinline__ void count16(unsigned int* h, const uint4 w) {
  const uint32_t q[4] = {w.x, w.y, w.z, w.w};
  if (q[0] == q[1] && q[1] == q[2] && q[2] == q[3] && q[0] == (q[0] & 0xffu) * 0x01010101u) {
    atomicAdd(h + 32 * (q[0] & 0xffu), 16u);
    return;
  }
#pragma unroll
  for (int b = 0; b < 16; ++b) atomicAdd(h + 32 * ((q[b >> 2] >> (8 * (b & 3))) & 0xffu), 1u);
}

__global__ void __launch_bounds__(kHistThreads)
hist_kernel(const uint8_t* __restrict__ x, unsigned long long* __restrict__ hist,
            int* __restrict__ partials, long long hw, long long chunk, int per_unit) {
  __shared__ __align__(16) unsigned int s_h[256 * 32];
  const int tid = threadIdx.x;
  for (int i = tid; i < 256 * 32 / 4; i += kHistThreads) {
    reinterpret_cast<uint4*>(s_h)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  const long long u = blockIdx.x / per_unit;
  const int part = static_cast<int>(blockIdx.x - u * per_unit);
  const long long lo = part * chunk;
  const long long n = min(hw, lo + chunk) - lo;
  const uint8_t* base = x + u * hw + lo;
  unsigned int* h = s_h + (tid & 31);
  // bytes before the first 16-byte boundary, the 16-byte words, the rest
  const long long head = min(n, static_cast<long long>(
      (16u - (reinterpret_cast<uintptr_t>(base) & 15u)) & 15u));
  const long long nv = (n - head) >> 4;
  const uint4* v = reinterpret_cast<const uint4*>(base + head);
  if (tid < head) atomicAdd(h + 32 * base[tid], 1u);
  for (long long j0 = 0; j0 < nv; j0 += kHistThreads * kLoads) {
    uint4 w[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const long long j = j0 + k * kHistThreads + tid;
      w[k] = j < nv ? __ldg(v + j) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      if (j0 + k * kHistThreads + tid < nv) count16(h, w[k]);
    }
  }
  for (long long j = head + 16 * nv + tid; j < n; j += kHistThreads) atomicAdd(h + 32 * base[j], 1u);
  __syncthreads();
  // bin tid's 32 columns, read from lane (l + tid) % 32 on: a warp's 32
  // reads of a step lie in 32 banks
  unsigned int c = 0;
#pragma unroll 8
  for (int l = 0; l < 32; ++l) c += s_h[32 * tid + ((l + tid) & 31)];
  if (partials != nullptr) {
    partials[static_cast<size_t>(blockIdx.x) * 256 + tid] = static_cast<int>(c);
  } else if (c) {
    atomicAdd(hist + u * 256 + tid, static_cast<unsigned long long>(c));
  }
}

constexpr int kScanThreads = 512;
constexpr int kSlices = kScanThreads / 64;  // partial-row slices: 64 threads of 4 bins each

// the unit's counts: its int64 row (parts == 0), or the sum of its parts
// int32 partial rows
__global__ void __launch_bounds__(kScanThreads, 1)
scan_kernel(const long long* __restrict__ hist, const int* __restrict__ partials, int parts,
            int* __restrict__ thr, double scale) {
  __shared__ long long s_cnt[kSlices][256];
  __shared__ double s_p[256], s_ip[256], s_q1[256], s_mu1[256];
  __shared__ unsigned s_left[8];  // the steps the guard leaves, a warp's 32 a word
  __shared__ unsigned long long s_mu;
  __shared__ double s_best[kScanThreads / 32];
  __shared__ int s_arg[kScanThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int u = blockIdx.x;
  if (tid == 0) s_mu = 0ull;
  if (partials != nullptr) {
    // slice tid / 64 sums partial rows slice, slice + kSlices, ... of bins
    // 4 (tid % 64) .. + 3
    const int4* pu = reinterpret_cast<const int4*>(partials + static_cast<size_t>(u) * parts * 256);
    const int q = tid & 63;
    const int sl = tid >> 6;
    long long c0 = 0, c1 = 0, c2 = 0, c3 = 0;
#pragma unroll 8
    for (int p = sl; p < parts; p += kSlices) {
      const int4 w = __ldg(pu + p * 64 + q);
      c0 += w.x;
      c1 += w.y;
      c2 += w.z;
      c3 += w.w;
    }
    s_cnt[sl][4 * q] = c0;
    s_cnt[sl][4 * q + 1] = c1;
    s_cnt[sl][4 * q + 2] = c2;
    s_cnt[sl][4 * q + 3] = c3;
  } else if (tid < 256) {
    s_cnt[0][tid] = hist[static_cast<size_t>(u) * 256 + tid];
  }
  __syncthreads();
  if (tid < 256) {
    long long c = s_cnt[0][tid];
    if (partials != nullptr) {
#pragma unroll
      for (int s = 1; s < kSlices; ++s) c += s_cnt[s][tid];
    }
    const double p = __dmul_rn(static_cast<double>(c), scale);
    s_p[tid] = p;
    s_ip[tid] = __dmul_rn(static_cast<double>(tid), p);
    unsigned long long m = static_cast<unsigned long long>(c) * static_cast<unsigned long long>(tid);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m += __shfl_down_sync(0xffffffffu, m, off);
    if (lane == 0) atomicAdd(&s_mu, m);
  }
  __syncthreads();
  const double eps = 1.1920928955078125e-07;  // FLT_EPSILON
  const double one_m_eps = 1.0 - eps;          // exact in double
  if (tid == 0) {
    // the q1 chain, adds only, 16 steps a block with their p_i in registers
    // first
    double q1 = 0.0;
    for (int i = 0; i < 256; i += 16) {
      double q[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) q[k] = s_p[i + k];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        q1 = __dadd_rn(q1, q[k]);
        q[k] = q1;
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) s_q1[i + k] = q[k];
    }
  }
  __syncthreads();
  // every step's guard side by side; the steps it leaves, [i0, i1], from
  // the 8 warps' ballots
  if (tid < 256) {
    const double q1 = s_q1[tid];
    const double q2 = __dsub_rn(1.0, q1);
    const unsigned left = __ballot_sync(0xffffffffu, !(fmin(q1, q2) < eps || fmax(q1, q2) > one_m_eps));
    if (lane == 0) s_left[tid >> 5] = left;
  }
  __syncthreads();
  int i0 = 256, i1 = -1;
#pragma unroll
  for (int w = 7; w >= 0; --w) {
    if (s_left[w]) i0 = 32 * w + __ffs(s_left[w]) - 1;
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    if (s_left[w]) i1 = 32 * w + 31 - __clz(s_left[w]);
  }
  if (tid == 0) {
    // the mu1 chain alone over [i0, i1], 8 steps a block with their q1_i
    // and ip_i in registers before the first of them
    double mu1 = 0.0;
    double q1_old = i0 > 0 && i0 < 256 ? s_q1[i0 - 1] : 0.0;
    int i = i0;
    for (; i + 8 <= i1 + 1; i += 8) {
      double q[8], ip[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        q[k] = s_q1[i + k];
        ip[k] = s_ip[i + k];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        mu1 = __dmul_rn(mu1, q1_old);
        mu1 = __ddiv_rn(__dadd_rn(mu1, ip[k]), q[k]);
        s_mu1[i + k] = mu1;
        q1_old = q[k];
      }
    }
    for (; i <= i1; ++i) {
      const double q = s_q1[i];
      mu1 = __dmul_rn(mu1, q1_old);
      mu1 = __ddiv_rn(__dadd_rn(mu1, s_ip[i]), q);
      s_mu1[i] = mu1;
      q1_old = q;
    }
  }
  __syncthreads();
  // step tid's sigma (-inf where guarded), then the first maximum
  double sigma = -__longlong_as_double(0x7ff0000000000000LL);
  if (tid >= i0 && tid <= i1) {
    const double mu = __dmul_rn(static_cast<double>(static_cast<long long>(s_mu)), scale);
    const double q1 = s_q1[tid];
    const double q2 = __dsub_rn(1.0, q1);
    const double mu1 = s_mu1[tid];
    const double mu2 = __ddiv_rn(__dsub_rn(mu, __dmul_rn(q1, mu1)), q2);
    const double d = __dsub_rn(mu1, mu2);
    sigma = __dmul_rn(__dmul_rn(__dmul_rn(q1, q2), d), d);
  }
  int arg = tid;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const double os = __shfl_down_sync(0xffffffffu, sigma, off);
    const int oa = __shfl_down_sync(0xffffffffu, arg, off);
    if (os > sigma || (os == sigma && oa < arg)) {
      sigma = os;
      arg = oa;
    }
  }
  if (lane == 0) {
    s_best[tid >> 5] = sigma;
    s_arg[tid >> 5] = arg;
  }
  __syncthreads();
  if (tid == 0) {
    double best = s_best[0];
    int at = s_arg[0];
    for (int w = 1; w < kScanThreads / 32; ++w) {
      if (s_best[w] > best) {  // warps in index order: a tie keeps the first
        best = s_best[w];
        at = s_arg[w];
      }
    }
    thr[u] = best > 0.0 ? at : 0;
  }
}

}  // namespace

// x: [U, hw] uint8; chunk, per_unit: the host's plan (per_unit CTAs of
// chunk pixels a unit, chunk a multiple of 16). Either hist ([U, 256]
// int64, zeroed by the caller: the counts are added in) or partials
// ([U * per_unit, 256] int32, every slot written) is null.
extern "C" int tik_histogram(const void* x, void* hist, void* partials, int U, long long hw,
                             long long chunk, int per_unit, void* stream) {
  const long long ctas = static_cast<long long>(U) * per_unit;
  if ((hist == nullptr) == (partials == nullptr) || chunk <= 0 || chunk % 16 != 0 ||
      per_unit <= 0 || ctas > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (U > 0 && hw > 0) {
    // every CTA's chunk starts in the unit, and the chunks cover it
    if ((per_unit - 1) * chunk >= hw || per_unit * chunk < hw) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    hist_kernel<<<static_cast<unsigned>(ctas), kHistThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<unsigned long long*>(hist),
        static_cast<int*>(partials), hw, chunk, per_unit);
  }
  return static_cast<int>(cudaGetLastError());
}

// hist: [U, 256] int64 (parts == 0) or partials: [U * parts, 256] int32;
// thr: [U] int32; scale = 1.0 / n
extern "C" int tik_otsu_scan(const void* hist, const void* partials, int parts, void* thr, int U,
                             double scale, void* stream) {
  if ((partials != nullptr) != (parts > 0) || (hist == nullptr) == (partials == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (U > 0) {
    scan_kernel<<<U, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(hist), static_cast<const int*>(partials), parts,
        static_cast<int*>(thr), scale);
  }
  return static_cast<int>(cudaGetLastError());
}
