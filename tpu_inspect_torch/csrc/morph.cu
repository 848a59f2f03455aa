// morph: kernel I, a whole erode/dilate chain on masks in one launch, with
// its head fused and OpenCV's border, on Hopper (sm_90a).
//
// Replaces tpu_inspect/ops/morph_pallas.py: _morph_chain (_morph_kernel),
// behind close_open_pallas, open_pallas and erode_rect_pallas. Every caller
// passes a mask and reads a mask, so the kernel computes
//   out = chain(head(x)),  head(x) = (thr ? x <= thr[u] : x != 0) && (roi ? roi != 0 : 1)
// where chain is the int32 stage program of planes.cuh (apply_stages): per
// stage an erode (AND) or dilate (OR) over the SE's row runs, out-of-plane
// samples the stage's own neutral (OpenCV's morphologyDefaultBorderValue).
// On masks min/max over 0/255 is AND/OR over bits, so the result equals
// apply_stages(head * 255) > 0 of ops/morphology.py for every input.
//
// What bounds it on this card: bytes. A whole 4096x3000 plane is 12.3 MB in
// (uint8) and 12.3 MB out (bool): 7.3 us at 3.35 TB/s; the doubling's word
// operations are a few hundred a 32-pixel word at most. Design: a CTA per
// output tile of TH rows x TWW 32-pixel words (ops/morphology.py:
// morph_tiles picks them from the plane and the chain's summed reach). It
// reads its tile plus a halo of that reach each way (clipped to the plane)
// with 16-byte loads, packs the head into a bit plane in shared memory,
// runs the whole chain there with planes.cuh's apply_stages (the buffer is
// its plane: reads past the buffer give the op's neutral, which is right at
// the plane's edge and, inside the plane, spoils only halo pixels, never
// the tile, since each stage spoils at most its own reach), and writes the
// tile's bytes with 16-byte stores. One launch a chain, no intermediate
// plane in device memory. Stages of small windows and at most 3 row offsets
// a window run in one pass from registers (the default close/open and
// open); the others (the ROI's rect erode, erode_px up to 200) take
// apply_stages' pass per group, with three more scratch planes: each row's
// column window once a word, then the rows.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "planes.cuh"

namespace {

constexpr int kSmemMax = 232448;  // a Hopper block's dynamic shared memory
// a stage with more row offsets in a group runs apply_stages' pass per
// group (each row's column window once); ops/morphology.py: _ONE_PASS_ROWS
constexpr int kOnePassRows = 3;

// n (<= 32) bytes at p as 8 little-endian words, zero past n; 16-byte
// loads where the caller guarantees alignment and a full word
__device__ inline void load32(const uint8_t* __restrict__ p, int n, bool vec, uint32_t (&v)[8]) {
  if (vec && n == 32) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = 0;
  for (int i = 0; i < n; ++i) v[i >> 2] |= static_cast<uint32_t>(__ldg(p + i)) << (8 * (i & 3));
}

// the head's bits of the n pixels at x (and roi): t < 0 selects x != 0,
// else x <= t (t <= 255)
__device__ inline uint32_t head_word(const uint8_t* __restrict__ x,
                                     const uint8_t* __restrict__ roi, int n, int t, bool vec) {
  uint32_t v[8];
  load32(x, n, vec, v);
  const uint32_t t4 = static_cast<uint32_t>(t & 0xFF) * 0x01010101u;
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t c = t < 0 ? __vcmpne4(v[j], 0u) : __vcmpleu4(v[j], t4);
    bits |= tik::msb4(c) << (4 * j);
  }
  if (roi != nullptr) {
    load32(roi, n, vec, v);
    uint32_t r = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) r |= tik::msb4(__vcmpne4(v[j], 0u)) << (4 * j);
    bits &= r;
  }
  return n == 32 ? bits : bits & ((1u << n) - 1u);
}

// the n pixels of word v as bytes 0 / 1 at p
__device__ inline void store_word(uint8_t* __restrict__ p, uint32_t v, int n, bool vec) {
  if (vec && n == 32) {
    uint4 a, b;
    a.x = tik::bytes4(v), a.y = tik::bytes4(v >> 4);
    a.z = tik::bytes4(v >> 8), a.w = tik::bytes4(v >> 12);
    b.x = tik::bytes4(v >> 16), b.y = tik::bytes4(v >> 20);
    b.z = tik::bytes4(v >> 24), b.w = tik::bytes4(v >> 28);
    reinterpret_cast<uint4*>(p)[0] = a;
    reinterpret_cast<uint4*>(p)[1] = b;
    return;
  }
  for (int i = 0; i < n; ++i) p[i] = static_cast<uint8_t>((v >> i) & 1u);
}

struct Tiling {
  int th, tww;   // output tile: rows, words
  int ry, rww;   // halo: rows, words
  int words;     // the largest buffer's words (a plane's stride in shared memory)
  int planes;    // 2, or 5 with a stage not run in one pass
};

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
morph_chain_kernel(const uint8_t* __restrict__ x, const int* __restrict__ thr,
                   const uint8_t* __restrict__ roi, uint8_t* __restrict__ out,
                   const int* __restrict__ prog, int H, int W, Tiling tl, int vec) {
  extern __shared__ uint32_t smem[];
  const int WW = (W + 31) >> 5;
  const int y0 = blockIdx.y * tl.th, k0 = blockIdx.x * tl.tww;
  const int y1 = min(H, y0 + tl.th), k1 = min(WW, k0 + tl.tww);
  const int by0 = max(0, y0 - tl.ry), bk0 = max(0, k0 - tl.rww);
  const int bk1 = min(WW, k1 + tl.rww);
  // the buffer (tile + halo, clipped to the plane) as apply_stages' plane;
  // its last word is the plane's last only at the plane's right edge
  tik::Bits g{};
  g.H = min(H, y1 + tl.ry) - by0;
  g.WW = bk1 - bk0;
  g.W = 32 * g.WW;
  g.n = g.H * g.WW;
  g.last = (bk1 == WW && (W & 31)) ? ((1u << (W & 31)) - 1u) : ~0u;
  uint32_t* a = smem;
  uint32_t* b = smem + tl.words;
  uint32_t* t = tl.planes > 2 ? smem + 2 * tl.words : nullptr;
  uint32_t* p0 = tl.planes > 2 ? smem + 3 * tl.words : nullptr;
  uint32_t* p1 = tl.planes > 2 ? smem + 4 * tl.words : nullptr;

  const size_t off = static_cast<size_t>(blockIdx.z) * H * W;
  const int th = thr == nullptr ? -1 : thr[blockIdx.z];
  if (thr == nullptr || th >= 0) {
    const int tt = thr == nullptr ? -1 : min(th, 255);
    for (int w = threadIdx.x; w < g.n; w += kThreads) {
      const int r = w / g.WW;
      const int xx = (bk0 + (w - r * g.WW)) << 5;
      const size_t i = off + static_cast<size_t>(by0 + r) * W + xx;
      a[w] = head_word(x + i, roi == nullptr ? nullptr : roi + i, min(32, W - xx), tt, vec);
    }
  } else {  // thr < 0: no pixel is <= thr
    for (int w = threadIdx.x; w < g.n; w += kThreads) a[w] = 0;
  }
  __syncthreads();
  const uint32_t* res = tik::apply_stages(prog, a, b, t, p0, p1, g, kOnePassRows);

  const int ow = k1 - k0;
  for (int w = threadIdx.x; w < (y1 - y0) * ow; w += kThreads) {
    const int r = w / ow;
    const int k = k0 + (w - r * ow);
    const uint32_t v = res[(y0 + r - by0) * g.WW + (k - bk0)];
    store_word(out + off + static_cast<size_t>(y0 + r) * W + (k << 5), v, min(32, W - (k << 5)),
               vec);
  }
}

template <int kThreads>
cudaError_t launch(const uint8_t* x, const int* thr, const uint8_t* roi, uint8_t* out,
                   const int* prog, int U, int H, int W, const Tiling& tl, int vec, size_t smem,
                   cudaStream_t s) {
  auto kernel = morph_chain_kernel<kThreads>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  const int WW = (W + 31) >> 5;
  const dim3 grid((WW + tl.tww - 1) / tl.tww, (H + tl.th - 1) / tl.th, U);
  kernel<<<grid, kThreads, smem, s>>>(x, thr, roi, out, prog, H, W, tl, vec);
  return cudaGetLastError();
}

}  // namespace

// One chain: x, roi [U, H, W] uint8 (roi may be null), thr [U] int32 (may
// be null: the head is x != 0), prog the chain's program (planes.cuh), out
// [U, H, W] uint8 0/1; th / tww the output tile's rows and words, ry / rx
// the chain's summed row and column reach, big whether a stage takes
// apply_stages' large-window passes (ops/morphology.py: morph_tiles).
extern "C" int tik_morph_chain(const void* x, const void* thr, const void* roi, void* out,
                               const void* prog, int U, int H, int W, int th, int tww, int ry,
                               int rx, int big, void* stream) {
  if (U <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  if (th <= 0 || tww <= 0 || ry < 0 || rx < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int WW = (W + 31) >> 5;
  Tiling tl;
  tl.th = std::min(th, H);
  tl.tww = std::min(tww, WW);
  tl.ry = ry;
  tl.rww = (rx + 31) >> 5;
  tl.planes = big ? 5 : 2;
  const long long words = static_cast<long long>(std::min(H, tl.th + 2 * ry)) *
                          std::min(WW, tl.tww + 2 * tl.rww);
  const long long smem = 4LL * tl.planes * words;
  if (smem > kSmemMax || (H + tl.th - 1) / tl.th > 65535 || U > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  tl.words = static_cast<int>(words);
  const auto* xp = static_cast<const uint8_t*>(x);
  const auto* rp = static_cast<const uint8_t*>(roi);
  auto* op = static_cast<uint8_t*>(out);
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec = (W % 16 == 0) && aligned(x) && aligned(out) && (roi == nullptr || aligned(roi));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* tp = static_cast<const int*>(thr);
  const auto* pp = static_cast<const int*>(prog);
  const cudaError_t rc =
      words > 2048 ? launch<1024>(xp, tp, rp, op, pp, U, H, W, tl, vec, smem, s)
                   : launch<256>(xp, tp, rp, op, pp, U, H, W, tl, vec, smem, s);
  return static_cast<int>(rc);
}
