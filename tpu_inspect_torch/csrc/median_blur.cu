// median_blur: kernel H, the exact k x k median of uint8 planes with
// BORDER_REPLICATE, on Hopper (sm_90a).
//
// Replaces tpu_inspect/ops/median_pallas.py: median_blur_u8_pallas (the
// full median value, behind the defect pass's k*k >= 2048 branch,
// engine.py:461-465, and median.py:28-46). out[u, y, x] is the rank
// (k*k + 1) / 2 (1-based) value of the k*k samples
// x[u, clamp(y + dy, 0, H-1), clamp(x + dx, 0, W-1)], |dy|, |dx| <= k / 2,
// for any odd k >= 3 (k = 1 never reaches the kernel: the wrapper returns
// its input), also where k exceeds H or W.
//
// Design: the sliding-histogram walk of median_hist.cuh. A block is one
// warp of 32 adjacent columns of one unit, walking one strip of S = 128
// rows (ops/median.py: strip_rows; the fastest in the rig,
// tools/kernel_bench.py --strips, on the H100 at k = 47 and 101 on 48
// units and at k = 47 on a whole plane: the warm-up of k * k samples costs
// 17 a row at k = 47 against 94 a step); block (x, s, u) walks rows s S..
// (s + 1) S - 1 of unit u. Its bins are 16 bits while k * k < 65536 (16 KB
// a block, 14 blocks an SM), 32 bits while k * k < 2^31 (32 KB), 64 bits
// beyond (64 KB, above the 48 KB default: opted in); the counts and the
// rank are int32 while k * k < 2^31 and int64 beyond. The TPU kernel's
// per-column histograms, band matmuls and bf16 one-hot counts are dropped:
// integer counts are exact by construction.
//
// What bounds it on this card: shared-memory atomics and L1 byte reads,
// not device memory (2 bytes a pixel). Per output pixel: 2 min(k, W)
// samples a step (94 at k = 47) plus the warm-up's min(k, H) min(k, W)
// over S (17 at k = 47), each one L1 byte read, one shared atomic and a
// compare-add, and a 16-read query. The design it replaced bisected the
// 8 value bits, counting its window 8 times (8 k^2 = 17.7 K compares a
// pixel at k = 47); here no tile bounds k, and a step costs 2 min(k, W)
// clamped updates at any k.

#include <cstdint>

#include <cuda_runtime.h>

#include "median_hist.cuh"

namespace {

template <int BITS, typename Count>
__global__ void __launch_bounds__(mh::kThreads)
median_blur_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out, int H, int W,
                   int r, Count rank, int strip) {
  using Word = typename mh::Bins<BITS>::Word;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c = blockIdx.x * mh::kThreads + threadIdx.x;
  const size_t off = static_cast<size_t>(blockIdx.z) * H * W;
  uint8_t* o = out + off;
  const int y0 = blockIdx.y * strip;
  mh::walk<BITS, Count>(x + off, H, W, r, c, y0, min(H, y0 + strip), rank,
                        reinterpret_cast<Word*>(smem_raw), [&](int y, int m) {
                          o[static_cast<size_t>(y) * W + c] = static_cast<uint8_t>(m);
                        });
}

template <int BITS, typename Count>
cudaError_t launch(const uint8_t* x, uint8_t* out, int U, int H, int W, int r, int strip,
                   cudaStream_t s) {
  const long long k = 2LL * r + 1;
  const Count rank = static_cast<Count>((k * k + 1) / 2);
  const size_t smem = mh::Bins<BITS>::kSmem;
  auto* kernel = median_blur_kernel<BITS, Count>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  const dim3 grid((W + mh::kThreads - 1) / mh::kThreads, (H + strip - 1) / strip, U);
  kernel<<<grid, mh::kThreads, smem, s>>>(x, out, H, W, r, rank, strip);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tik_median_blur(const void* x, void* out, int U, int H, int W, int k,
                               int strip, void* stream) {
  if (k < 3 || (k & 1) == 0 || strip < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (U <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  const int r = k / 2;
  const auto* src = static_cast<const uint8_t*>(x);
  auto* dst = static_cast<uint8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long kk = static_cast<long long>(k) * k;
  cudaError_t rc;
  if (kk < (1LL << 16)) {
    rc = launch<16, int>(src, dst, U, H, W, r, strip, s);
  } else if (kk < (1LL << 31)) {
    rc = launch<32, int>(src, dst, U, H, W, r, strip, s);
  } else {
    rc = launch<64, long long>(src, dst, U, H, W, r, strip, s);
  }
  return static_cast<int>(rc);
}
