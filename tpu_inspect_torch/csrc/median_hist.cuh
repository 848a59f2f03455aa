// The sliding-histogram walk shared by kernel B (median_residual.cu) and
// kernel H (median_blur.cu): the exact k x k median of a uint8 plane with
// BORDER_REPLICATE, for one column of one unit down a strip of rows; and
// kernel B's kernel on it, `median_residual_kernel`, which kernel L
// (median_probe.cu) launches in the walk's ablation modes (`Mode`, below).
//
// One thread owns one output column and the 256-bin histogram of its
// window, in shared memory as [bin][thread]. Bins are BITS wide: 16 while
// k * k < 65536, two threads' bins in one 32-bit word (lane t in the half
// t / 16 of word column t % 16, so a bin's address is one multiply-add of
// its value and the half is fixed per thread); 32 bits while k * k < 2^31
// and 64 beyond, a word per bin and thread. A thread only adds to its own
// bins, by shared-memory atomics (fire and forget: the updates of one step
// do not wait on each other, where a load-add-store would wait on the store
// before it, which may hit the same word); a count never goes below 0 nor
// above k * k, so a 16-bit half never carries into its neighbour.
//
// A window row of column c holds the clamped samples x[i][clamp(c + dx)],
// |dx| <= r: the in-plane columns max(0, c - r)..min(W - 1, c + r) once
// each, and column 0 / W - 1 a further max(0, r - c) / max(0, c + r - W + 1)
// times. Each row is added as such a weighted set, so a row costs at most
// min(k, W) + 2 updates whatever k is (k may exceed H and W). A strip's
// first output row y0 warms the histogram up with its clamped rows (row
// 0 / H - 1 weighted by their repeats); each step down removes row
// clamp(y - r) and adds row clamp(y + 1 + r) in one pass over the columns,
// nothing when the two are one row.
//
// The query is two-level without a second histogram: a thread carries
// `base`, 16 x the band (16 values) its last median fell in, and `below`,
// its window's samples under `base`, which each update keeps exact with
// one compare and one add in registers. The query reads the 16 bins of the
// band at `base`; if the rank (k * k + 1) / 2 (1-based) lies below or above
// that band it moves `base` one band and reads again (neighbouring rows'
// medians rarely leave a band, and never move more than 15 bands), then
// finds the bin in the band: integer counts, exact.
//
// Per output pixel, with strips of S rows: 2 min(k, W) samples a step plus
// the warm-up's min(k, H) min(k, W) over S, each one L1 byte read (the
// warp's 32 threads read 32 adjacent bytes), one shared atomic and a
// compare-add; then 16 shared reads for the query (16 more per band moved).
// A coarse histogram beside the fine one (a second atomic a sample), or a
// band tally of each row in registers, took 1.5-2x this body's time on
// the H100.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace mh {

constexpr int kThreads = 32;  // columns per block: one warp
constexpr int kBins = 256;

// The walk's modes. kBaseline is the walk itself, what kernels B and H
// compile; the others are kernel L's ablations, each removing one piece of
// it, wrong by construction (timed, never compared):
//   kNoWarm    no warm-up rows: each strip starts from zeroed bins;
//   kNoUpdate  no step down: every row is queried on the warm-up's bins;
//   kNoAtomic  each bin update a plain load-add-store: two threads share a
//              32-bit word of 16-bit bins, so their updates race;
//   kNoQuery   no band query: the median emitted from registers (base - 1
//              or base, by below >= rank), `base` fixed at 128 so that each
//              update still makes its compare-add.
// Their counts may be wrong (a removal from a bin never added to borrows
// from the neighbouring half; a racing update is lost), and on such counts
// the baseline's band loop need not end. So in every ablation the loop
// stops after kMaxMoves band moves, `base` clamped to 0..240: each mode
// ends, and reads inside the bins, on any input. The baseline's counts are
// exact, so its loop always ends: it keeps no bound.
enum Mode { kBaseline = 0, kNoWarm, kNoUpdate, kNoAtomic, kNoQuery };
constexpr int kMaxMoves = 16;

template <int BITS>
struct Bins {
  static_assert(BITS == 16 || BITS == 32 || BITS == 64, "bins are 16, 32 or 64 bits");
  using Word = typename std::conditional<BITS == 64, unsigned long long, uint32_t>::type;
  static constexpr int kStride = BITS == 16 ? kThreads / 2 : kThreads;  // words per bin
  static constexpr size_t kSmem = sizeof(Word) * kBins * kStride;  // bytes per block

  Word* col;  // this thread's word column: bin v in col[v * kStride]
  int shift;  // its half of the word (16-bit bins)

  __device__ explicit Bins(Word* smem)
      : col(smem + (BITS == 16 ? threadIdx.x % kStride : threadIdx.x)),
        shift(BITS == 16 ? 16 * (threadIdx.x / kStride) : 0) {
    // each word is zeroed by the thread owning its low half
    if (shift == 0) {
      for (int v = 0; v < kBins; ++v) col[v * kStride] = 0;
    }
    __syncwarp();
  }

  // the word to add for a weight w (negative: a removal)
  template <typename Count>
  __device__ __forceinline__ Word delta(Count w) const {
    return static_cast<Word>(w) << shift;
  }

  template <bool ATOMIC = true>
  __device__ __forceinline__ void bump(int v, Word d) {
    if constexpr (ATOMIC) {
      atomicAdd(&col[v * kStride], d);
    } else {
      col[v * kStride] += d;
    }
  }

  // the 16 bins of band b, and their sum
  template <typename Count>
  __device__ __forceinline__ Count band(int b, Count (&c)[16]) const {
    Count s = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const Word word = col[(b * 16 + i) * kStride];
      c[i] = static_cast<Count>(BITS == 16 ? (word >> shift) & 0xFFFFu : word);
      s += c[i];
    }
    return s;
  }
};

// Walks column c of the plane `img` [H, W] down rows y0..y1-1 (y0 < y1),
// calling emit(y, median) for each; `smem` is the block's Bins<BITS>::kSmem
// bytes. All 32 threads of the warp call it (the bins are zeroed
// together); a thread with c >= W returns after that. Count is signed and
// holds k * k. MODE is one of `Mode`.
template <int BITS, typename Count, int MODE = kBaseline, class Emit>
__device__ __forceinline__ void walk(const uint8_t* __restrict__ img, int H, int W, int r,
                                     int c, int y0, int y1, Count rank,
                                     typename Bins<BITS>::Word* smem, Emit emit) {
  using Word = typename Bins<BITS>::Word;
  Bins<BITS> bins(smem);
  if (c >= W) return;
  const int j0 = max(0, c - r);
  const int n = min(W - 1, c + r) - j0 + 1;  // in-plane columns of the window
  const Count left = max(0, r - c);
  const Count right = max(0, c + r - (W - 1));
  constexpr bool kBounded = MODE != kBaseline;
  int base = MODE == kNoQuery ? 128 : 0;  // 16 x the band the last median fell in
  Count below = 0;  // samples of the window below `base`
  // a sample of value v weighted w
  auto put = [&](int v, Count w, Word d) {
    bins.template bump<MODE != kNoAtomic>(v, d);
    below += v < base ? w : Count(0);
  };
  // row i of the window, each sample weighted w
  auto row = [&](int i, Count w) {
    const uint8_t* p = img + static_cast<size_t>(i) * W;
    const Word d = bins.delta(w);
#pragma unroll 4
    for (int t = 0; t < n; ++t) put(__ldg(p + j0 + t), w, d);
    if (left) put(__ldg(p), w * left, bins.delta(w * left));
    if (right) put(__ldg(p + W - 1), w * right, bins.delta(w * right));
  };
  // one step down: row a leaves, row b enters
  auto step = [&](int a, int b) {
    const uint8_t* pa = img + static_cast<size_t>(a) * W;
    const uint8_t* pb = img + static_cast<size_t>(b) * W;
    const Word out = bins.delta(Count(-1));
    const Word in = bins.delta(Count(1));
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      put(__ldg(pa + j0 + t), Count(-1), out);
      put(__ldg(pb + j0 + t), Count(1), in);
    }
    if (left) {
      put(__ldg(pa), -left, bins.delta(-left));
      put(__ldg(pb), left, bins.delta(left));
    }
    if (right) {
      put(__ldg(pa + W - 1), -right, bins.delta(-right));
      put(__ldg(pb + W - 1), right, bins.delta(right));
    }
  };
  if constexpr (MODE != kNoWarm) {
    const Count top = max(0, r - y0);
    const Count bot = max(0, y0 + r - (H - 1));
    for (int i = max(0, y0 - r); i <= min(H - 1, y0 + r); ++i) {
      row(i, Count(1) + (i == 0 ? top : Count(0)) + (i == H - 1 ? bot : Count(0)));
    }
  }
  for (int y = y0;; ++y) {
    int m;
    if constexpr (MODE == kNoQuery) {
      m = below >= rank ? base - 1 : base;
    } else {
      // move `base` to the band holding the rank, then find the bin in it
      Count c16[16];
      m = -1;
      [[maybe_unused]] int moves = 0;
      while (m < 0) {
        const Count s = bins.band(base >> 4, c16);
        if constexpr (kBounded) {
          if (moves++ == kMaxMoves) {
            m = base;
            break;
          }
        }
        if (rank <= below) {
          base -= 16;
          if constexpr (kBounded) base = max(base, 0);
          Count lower[16];
          below -= bins.band(base >> 4, lower);
        } else if (rank > below + s) {
          below += s;
          base += 16;
          if constexpr (kBounded) base = min(base, kBins - 16);
        } else {
          Count acc = below;
          m = base + 15;
          bool found = false;
#pragma unroll
          for (int i = 0; i < 15; ++i) {
            acc += c16[i];
            if (!found && acc >= rank) {
              m = base + i;
              found = true;
            }
          }
        }
      }
    }
    emit(y, m);
    if (y + 1 >= y1) break;
    if constexpr (MODE != kNoUpdate) {
      const int a = max(0, y - r);
      const int b = min(H - 1, y + 1 + r);
      if (a != b) step(a, b);
    }
  }
}

constexpr int kResidualMaxK = 45;  // k * k < 2048: 16-bit bins always hold k * k

}  // namespace mh

namespace {

// Kernel B: 255 where |x - median_k(x)| > thr on the rows [row_lo, row_hi)
// of each unit of x [U, H, W], 0 on its other rows, for odd
// k <= mh::kResidualMaxK, with 16-bit bins. Its grid is (ceil(W / 32),
// ceil(H / strip), U) blocks of one warp: block (x, s, u) walks ROI rows
// row_lo + s strip.. of unit u and writes the zeros of rows
// s strip..(s + 1) strip - 1 outside [row_lo, row_hi), so the grid covers
// every row without the host reading the row bounds. B (median_residual.cu)
// launches it at mh::kBaseline, kernel L (median_probe.cu) in every mode;
// each file compiles its own copy (internal linkage).
template <int MODE = mh::kBaseline>
__global__ void __launch_bounds__(mh::kThreads)
median_residual_kernel(const uint8_t* __restrict__ x, const int* __restrict__ row_lo,
                       const int* __restrict__ row_hi, uint8_t* __restrict__ out, int H,
                       int W, int k, int thr, int strip) {
  using Bins = mh::Bins<16>;
  __shared__ Bins::Word smem[Bins::kSmem / sizeof(Bins::Word)];
  const int u = blockIdx.z;
  const int c = blockIdx.x * mh::kThreads + threadIdx.x;
  const size_t off = static_cast<size_t>(u) * H * W;
  const uint8_t* img = x + off;
  uint8_t* o = out + off;
  const int lo = max(row_lo[u], 0);
  const int hi = min(row_hi[u], H);
  const int z0 = blockIdx.y * strip;
  if (c < W) {
    for (int y = z0; y < min(H, z0 + strip); ++y) {
      if (y < lo || y >= hi) o[static_cast<size_t>(y) * W + c] = 0;
    }
  }
  if (hi - lo <= z0) return;  // no ROI row left for this strip (block-uniform)
  const int y0 = lo + z0;
  const int y1 = min(hi, y0 + strip);
  mh::walk<16, int, MODE>(img, H, W, k / 2, c, y0, y1, (k * k + 1) / 2, smem,
                          [&](int y, int m) {
                            const size_t i = static_cast<size_t>(y) * W + c;
                            o[i] = abs(static_cast<int>(img[i]) - m) > thr ? 255 : 0;
                          });
}

}  // namespace
