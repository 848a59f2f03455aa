// morph: kernel I, one erode or dilate stage of a morphology chain, with
// OpenCV's border, on Hopper (sm_90a).
//
// Replaces tpu_inspect/ops/morph_pallas.py: _morph_chain (_morph_kernel),
// behind close_open_pallas, open_pallas and erode_rect_pallas. A stage is
// the int32 program of planes.cuh (apply_stages), from its op: op (0 erode,
// 1 dilate), n_groups, then per group lo, hi, n_dy, dy...: a group is a set
// of SE rows sharing the column window [lo, hi]. out[y, x] is the min (erode)
// or max (dilate) over the groups' samples in[y + dy, x + lo .. x + hi];
// out-of-plane samples are the op's neutral (255 erode, 0 dilate), which is
// OpenCV's morphologyDefaultBorderValue. The wrapper launches one stage at
// a time over ping-pong buffers.
//
// What bounds it on this card: bytes at the main path's SE sizes (1 byte in
// and 1 out a pixel; the 13x13 erode's 26 reads a pixel and the 3x3 close /
// open's 5-21 come from shared memory). Design: a CTA per 32-column x TH-row
// output tile (TH = 8, 16 or 32, the most that fits 64 KB of shared memory;
// 8 up to 227 KB), the tile plus halo loaded once with the neutral padded
// in before any reduction (padding after a partial min would leak the wrong
// value across the border), then per group a horizontal sliding reduction
// into a second shared buffer and a vertical combine over the group's row
// offsets (a rect SE is one group: separable).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;
constexpr int kRowsY = 8;  // thread rows; each thread owns TH / 8 output rows
constexpr int kThreads = kTileW * kRowsY;

template <bool kErode>
__device__ inline int red(int a, int b) {
  return kErode ? min(a, b) : max(a, b);
}

template <bool kErode, int kTH>
__global__ void __launch_bounds__(kThreads)
morph_stage_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                   const int* __restrict__ stage, int H, int W, int rx, int ry) {
  extern __shared__ uint8_t smem[];
  constexpr int kPer = kTH / kRowsY;
  constexpr int kNeutral = kErode ? 255 : 0;
  const int sw = kTileW + 2 * rx;  // input tile width
  const int sh = kTH + 2 * ry;     // input tile height = horizontal buffer height
  uint8_t* s_in = smem;
  uint8_t* s_h = smem + sh * sw;
  const int u = blockIdx.z;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTH;
  const size_t off = static_cast<size_t>(u) * H * W;
  const uint8_t* img = in + off;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int j = tid; j < sh * sw; j += kThreads) {
    const int jy = j / sw;
    const int yy = y0 - ry + jy;
    const int xx = x0 - rx + (j - jy * sw);
    s_in[j] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                  ? img[static_cast<size_t>(yy) * W + xx]
                  : static_cast<uint8_t>(kNeutral);
  }
  int acc[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) acc[q] = kNeutral;
  const int n_groups = stage[1];
  int p = 2;
  for (int g = 0; g < n_groups; ++g) {
    const int lo = stage[p];
    const int hi = stage[p + 1];
    const int nd = stage[p + 2];
    const int* dys = stage + p + 3;
    p += 3 + nd;
    __syncthreads();  // s_in loaded; the previous group's reads of s_h done
    for (int j = tid; j < sh * kTileW; j += kThreads) {
      const int jy = j / kTileW;
      const uint8_t* row = s_in + jy * sw + (j - jy * kTileW) + rx;
      int v = kNeutral;
      for (int d = lo; d <= hi; ++d) v = red<kErode>(v, row[d]);
      s_h[j] = static_cast<uint8_t>(v);
    }
    __syncthreads();
    for (int jd = 0; jd < nd; ++jd) {
      const uint8_t* col = s_h + (ry + dys[jd]) * kTileW + threadIdx.x;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        acc[q] = red<kErode>(acc[q], col[(threadIdx.y + kRowsY * q) * kTileW]);
      }
    }
  }
  const int gx = x0 + threadIdx.x;
  if (gx >= W) return;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int gy = y0 + threadIdx.y + kRowsY * q;
    if (gy < H) out[off + static_cast<size_t>(gy) * W + gx] = static_cast<uint8_t>(acc[q]);
  }
}

template <bool kErode, int kTH>
cudaError_t launch(const uint8_t* in, uint8_t* out, const int* stage, int U, int H,
                   int W, int rx, int ry, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(kTH + 2 * ry) * (2 * kTileW + 2 * rx);
  auto kernel = morph_stage_kernel<kErode, kTH>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTH - 1) / kTH, U);
  kernel<<<grid, dim3(kTileW, kRowsY), smem, s>>>(in, out, stage, H, W, rx, ry);
  return cudaGetLastError();
}

template <bool kErode>
cudaError_t launch_rows(const uint8_t* in, uint8_t* out, const int* stage, int U,
                        int H, int W, int rx, int ry, int th, cudaStream_t s) {
  switch (th) {
    case 32: return launch<kErode, 32>(in, out, stage, U, H, W, rx, ry, s);
    case 16: return launch<kErode, 16>(in, out, stage, U, H, W, rx, ry, s);
    case 8: return launch<kErode, 8>(in, out, stage, U, H, W, rx, ry, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One stage: `stage` points at the stage's op word in the program; rx / ry
// are its largest column / row reach, th the output tile's rows (the
// wrapper picks them, ops/morphology.py: morph_tile_rows).
extern "C" int tik_morph_stage(const void* in, void* out, const void* stage, int U,
                               int H, int W, int erode, int rx, int ry, int th,
                               void* stream) {
  if (U <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  const auto* src = static_cast<const uint8_t*>(in);
  auto* dst = static_cast<uint8_t*>(out);
  const auto* prog = static_cast<const int*>(stage);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      erode ? launch_rows<true>(src, dst, prog, U, H, W, rx, ry, th, s)
            : launch_rows<false>(src, dst, prog, U, H, W, rx, ry, th, s);
  return static_cast<int>(rc);
}
