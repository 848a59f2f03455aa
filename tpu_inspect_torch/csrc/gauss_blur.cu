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
// What bounds it on this card: bytes. The function reads each pixel once
// and writes it once (9.6 MB for 48 units of 315x316, 24.6 MB for a
// 3000x4096 capture: 2.9 and 7.3 us at 3.35 TB/s); its 2k integer
// multiply-adds a pixel (6 at the path's k = 3) stay under that at the
// int32 rate.
//
// One launch a call, one instance per odd k in 3..31 (the taps' count and
// every loop bound known to the compiler; the taps themselves in registers,
// read once a thread). A CTA per tile of 64 output rows x 160 columns of
// one unit (two tiles across a 316-px unit, 480 for 48 units: one wave at
// 4 CTAs a SM) stages the tile and its k - 1 halo rows and columns as
// 4-byte words in shared memory, every load of a thread issued before its
// first store: a word whose four columns lie in the plane is read directly
// (one aligned load, or two and a funnel shift where the row is not
// 4-byte aligned: an odd width, or a view such as x[1:]); only the words
// that reach past the plane's left or right edge go byte by byte,
// mirrored, and only where the pad reaches past the far edge too (numpy's
// repeated reflection: a plane of at most k / 2 rows or columns) through
// the plain version's index tables. Each thread then owns 4 adjacent
// columns and 8 output rows: it reads its window, (k + 6) / 4 words a
// staged row, computes the 4 row sums, and up to k = 11 keeps the last k
// of them in registers (the loop unrolled, so the ring's slots are
// registers) and writes each output row's 4 bytes in one store where the
// address is 4-byte aligned. From k = 13 the ring would not fit the
// registers: the row sums of every staged row go to an int32 tile in
// shared memory instead and the column pass reads them 4 at a time. The
// inner loops load no tap from shared memory; at k = 3 a thread issues 2
// shared loads for 24 integer multiply-adds a row.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kQuads = 40;                 // quads of 4 output columns a tile row
constexpr int kTileW = 4 * kQuads;         // output columns of a tile: 2 a 316-px unit
constexpr int kTileH = 64;                 // output rows of a tile
constexpr int kGroups = 8;                 // row groups of kQuads threads
constexpr int kThreads = kQuads * kGroups;
constexpr int kSub = kTileH / kGroups;     // output rows a thread
constexpr int kMaxRingK = 11;              // the row sums stay in registers up to this k

template <int K>
struct Geom {
  static constexpr int kPad = K / 2;
  static constexpr int kRows = kTileH + 2 * kPad;      // staged rows
  static constexpr int kWin = (2 * kPad + 3) / 4 + 1;  // words a quad's window spans
  static constexpr int kWords = kQuads + kWin - 1;     // words a staged row
  static constexpr int kInWords = (kRows * kWords + 3) & ~3;
  static constexpr bool kRing = K <= kMaxRingK;
  static constexpr size_t kSmem =  // staged words, the ring-less row sums, the table slices
      sizeof(uint32_t) * (kInWords + (kRing ? 0 : static_cast<size_t>(kRows) * kTileW) + kRows +
                          kTileW + 2 * kPad);
};

// the 4 row sums of the quad whose window starts at word p[0]
template <int K>
__device__ __forceinline__ void row_sums(const uint32_t* p, const int (&tap)[K], int (&rs)[4]) {
  uint32_t w[Geom<K>::kWin];
#pragma unroll
  for (int n = 0; n < Geom<K>::kWin; ++n) w[n] = p[n];
#pragma unroll
  for (int c = 0; c < 4; ++c) rs[c] = 0;
#pragma unroll
  for (int b = 0; b < K + 3; ++b) {
    const int v = static_cast<int>((w[b >> 2] >> (8 * (b & 3))) & 0xffu);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (b - c >= 0 && b - c < K) rs[c] += tap[b - c] * v;
    }
  }
}

// the n (<= 4) output bytes of a quad: one 4-byte store where it can
__device__ __forceinline__ void store4(uint8_t* o, const int (&acc)[4], int n) {
  uint32_t v = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) v |= static_cast<uint32_t>(min(255, (acc[c] + 32768) >> 16)) << (8 * c);
  if (n == 4 && (reinterpret_cast<uintptr_t>(o) & 3) == 0) {
    *reinterpret_cast<uint32_t*>(o) = v;
  } else {
    for (int c = 0; c < n; ++c) o[c] = static_cast<uint8_t>(v >> (8 * c));
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
gauss_blur_kernel(const uint8_t* __restrict__ x, const int* __restrict__ taps,
                  const int* __restrict__ row_idx, const int* __restrict__ col_idx,
                  uint8_t* __restrict__ out, int H, int W) {
  using G = Geom<K>;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_in = smem;  // kRows x kWords: staged byte c of row j at byte 4 (j kWords) + c
  const int q = threadIdx.x % kQuads;
  const int g = threadIdx.x / kQuads;
  const int u = blockIdx.z;
  const int r0 = blockIdx.y * kTileH;
  const int c0 = blockIdx.x * kTileW;
  const int rh = min(kTileH, H - r0);
  const int in_rows = rh + 2 * G::kPad;  // padded rows r0 .. r0 + in_rows - 1
  const int in_cols = min(kTileW, W - c0) + 2 * G::kPad;
  const uint8_t* xu = x + static_cast<size_t>(u) * H * W;

  int tap[K];
#pragma unroll
  for (int t = 0; t < K; ++t) tap[t] = __ldg(taps + t);

  // stage: word wi of row j holds padded columns c0 + 4 wi .. + 3, i.e.
  // plane columns c0 - pad + 4 wi .. + 3 of padded row r0 + j; words past
  // the tile's rows or columns hold 0. A halo past the plane's edge
  // mirrors it (numpy's reflect); where the pad reaches past the far edge
  // too (a plane of at most pad rows or columns), numpy reflects again,
  // and the tile reads its slices of the two tables, copied to shared
  // memory first. Every load of a thread is issued, predicated, before
  // the first is used.
  const bool table = H <= G::kPad || W <= G::kPad;
  int* s_ridx = reinterpret_cast<int*>(smem + G::kInWords + (G::kRing ? 0 : G::kRows * kTileW));
  int* s_cidx = s_ridx + G::kRows;
  if (table) {
    for (int i = threadIdx.x; i < in_rows; i += kThreads) s_ridx[i] = __ldg(row_idx + r0 + i);
    for (int i = threadIdx.x; i < in_cols; i += kThreads) s_cidx[i] = __ldg(col_idx + c0 + i);
    __syncthreads();
  }
  auto mirror = [](int i, int n) { return i < 0 ? -i : i >= n ? 2 * (n - 1) - i : i; };
  constexpr int kTotal = G::kRows * G::kWords;
  constexpr int kPer = (kTotal + kThreads - 1) / kThreads;
  // lo, up: a word read in the plane (two aligned words, shifted by the
  // address's misalignment, kept in eb); eb: a word that reaches past the
  // plane's left or right edge, byte by byte (each aligned word read holds
  // a byte of the plane, so neither leaves the allocation)
  uint32_t lo[kPer], up[kPer], eb[kPer];
#pragma unroll
  for (int n = 0; n < kPer; ++n) {
    const int e = threadIdx.x + n * kThreads;
    const int j = e / G::kWords;
    const int wi = e - j * G::kWords;
    const bool ok = e < kTotal && j < in_rows;
    const int sr = !ok ? 0 : table ? s_ridx[j] : mirror(r0 - G::kPad + j, H);
    const uint8_t* xr = xu + static_cast<size_t>(sr) * W;
    const int col = c0 - G::kPad + 4 * wi;
    const bool inner = col >= 0 && col + 4 <= W;
    const uintptr_t a = reinterpret_cast<uintptr_t>(xr + col);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3});
    lo[n] = ok && inner ? __ldg(w) : 0u;
    up[n] = ok && inner && (a & 3) ? __ldg(w + 1) : 0u;
    eb[n] = inner ? static_cast<uint32_t>(a & 3) : 0u;
    if (ok && !inner) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (4 * wi + b < in_cols) {
          const int src = table ? s_cidx[4 * wi + b] : mirror(col + b, W);
          eb[n] |= static_cast<uint32_t>(xr[src]) << (8 * b);
        }
      }
    }
  }
#pragma unroll
  for (int n = 0; n < kPer; ++n) {
    const int e = threadIdx.x + n * kThreads;
    const int col = c0 - G::kPad + 4 * ((e % G::kWords));
    const bool inner = col >= 0 && col + 4 <= W;
    if (e < kTotal) s_in[e] = inner ? __funnelshift_r(lo[n], up[n], 8 * eb[n]) : eb[n];
  }
  __syncthreads();

  const int n = min(4, W - c0 - 4 * q);  // this quad's columns in the plane
  uint8_t* ou = out + (static_cast<size_t>(u) * H + r0) * W + c0 + 4 * q;
  const uint32_t* win = s_in + q;
  if constexpr (G::kRing) {
    // rows g kSub .. + kSub - 1; ring[j % K] holds staged row g kSub + j's sums
    int ring[K][4];
#pragma unroll
    for (int j = 0; j < kSub + K - 1; ++j) {
      row_sums<K>(win + (g * kSub + j) * G::kWords, tap, ring[j % K]);
      if (j >= K - 1) {
        const int i = j - (K - 1);
        int acc[4] = {0, 0, 0, 0};
#pragma unroll
        for (int t = 0; t < K; ++t) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[c] += tap[t] * ring[(i + t) % K][c];
        }
        const int r = g * kSub + i;
        if (r < rh && n > 0) store4(ou + static_cast<size_t>(r) * W, acc, n);
      }
    }
  } else {
    int* s_row = reinterpret_cast<int*>(smem + G::kInWords);  // kRows x kTileW
    for (int j = g; j < G::kRows; j += kGroups) {
      int rs[4];
      row_sums<K>(win + j * G::kWords, tap, rs);
      *reinterpret_cast<int4*>(s_row + j * kTileW + 4 * q) = make_int4(rs[0], rs[1], rs[2], rs[3]);
    }
    __syncthreads();
    for (int i = 0; i < kSub; ++i) {
      const int r = g * kSub + i;
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int t = 0; t < K; ++t) {
        const int4 v = *reinterpret_cast<const int4*>(s_row + (r + t) * kTileW + 4 * q);
        acc[0] += tap[t] * v.x;
        acc[1] += tap[t] * v.y;
        acc[2] += tap[t] * v.z;
        acc[3] += tap[t] * v.w;
      }
      if (r < rh && n > 0) store4(ou + static_cast<size_t>(r) * W, acc, n);
    }
  }
}

template <int K>
int launch(const void* x, const void* taps, const void* row_idx, const void* col_idx, void* out,
           int U, int H, int W, cudaStream_t stream) {
  const size_t smem = Geom<K>::kSmem;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        gauss_blur_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, U);
  gauss_blur_kernel<K><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const int*>(taps),
      static_cast<const int*>(row_idx), static_cast<const int*>(col_idx),
      static_cast<uint8_t*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}

// the instance for k (odd, K .. 31)
template <int K>
int dispatch(int k, const void* x, const void* taps, const void* row_idx, const void* col_idx,
             void* out, int U, int H, int W, cudaStream_t stream) {
  if (k == K) return launch<K>(x, taps, row_idx, col_idx, out, U, H, W, stream);
  if constexpr (K < 31) {
    return dispatch<K + 2>(k, x, taps, row_idx, col_idx, out, U, H, W, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, out: [U, H, W] uint8; taps: [k] int32 (k odd, 3..31); row_idx:
// [H + 2 (k / 2)] and col_idx: [W + 2 (k / 2)] int32, the padded axes'
// source indices
extern "C" int tik_gauss_blur(const void* x, const void* taps, const void* row_idx,
                              const void* col_idx, void* out, int U, int H, int W, int k,
                              void* stream) {
  if (U <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  if (k < 3 || k > 31 || k % 2 == 0 || U > 65535 || (H + kTileH - 1) / kTileH > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch<3>(k, x, taps, row_idx, col_idx, out, U, H, W,
                     static_cast<cudaStream_t>(stream));
}
