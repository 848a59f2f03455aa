// blob_filter: the defect blob filter on Hopper (sm_90a).
//
// Replaces tpu_inspect/ops/blob_pallas.py: blob_filter_pallas (_blob_body,
// both the plain and the `roi` form, with or without `pre_open`). Per unit:
// candidate AND ROI -> optional 3x3-ellipse open (OpenCV borders) ->
// exterior = background 4-connected to the border -> fill regions =
// 8-connected components of ~exterior -> each region's top-level blob = the
// fg component holding the region's raster-first pixel -> per region, twice
// the OpenCV contourArea of the blob's external contour as a sum of
// crack-vertex contributions (CONTOUR_TABLE_X2, Green's theorem) -> keep
// the region when min_x2 <= |2*area| <= max_x2 -> paint kept regions (blob
// plus enclosed holes: filled drawContours) and count the painted pixels.
//
// What bounds it on this card: not bytes (one candidate and one ROI plane
// in, one plane out per unit: 4.3 us on 48 units at 3.35 TB/s) but the
// sequential depth of the CTA's passes on units that have candidates; most
// units have none and leave right after the open (the empty fast path).
// Design: one CTA of 1024 threads per unit. Every plane is binary, so the
// unit's planes are bit-packed and live, with the block grid's two parent
// arrays, in the CTA's shared memory (220 KB at 315x316; a global scratch
// for units too large for it, picked by the launcher): the open and the
// border flood are kernel A's bit-parallel passes (planes.cuh); both
// labelings are kernel J's fixed-pass union-find, whose depth does not grow
// on thin winding edges (the Canny form); the per-region values live in the
// root's own parent slot (the first pixel, then the top-level key) and the
// Green's sums in the second parent array once the top-level plane is
// built; the vertex pass skips every word of vertices whose four pixels
// share one state. Instead of the TPU kernel's sequential per-root masked
// sums, every vertex atomicAdds its contribution into its region's slot.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "planes.cuh"

namespace {

constexpr int kThreads = 1024;

// A unit's layout: the candidate (then top-level, then kept) plane, the
// exterior plane, and a region that holds first the morphology's and the
// flood's scratch planes, then the two labelings' parents, in words.
__host__ __device__ inline long long blob_unit_words(int H, int W) {
  const long long n = tik::plane_words(H, W);
  const long long two_nb = 2ll * tik::block_count(H, W);
  return 2 * n + (two_nb > 5 * n ? two_nb : 5 * n);
}

// the exterior word (k of row y; out-of-plane pixels are exterior) and the
// top-level word (out-of-plane pixels are not top-level) around a vertex
__device__ inline uint32_t ext_word(const uint32_t* E, int y, int k, const tik::Bits& g) {
  if (y < 0 || y >= g.H || k < 0 || k >= g.WW) return ~0u;
  const uint32_t v = E[y * g.WW + k];
  return k == g.WW - 1 ? (v | ~g.last) : v;
}

__device__ inline uint32_t top_word(const uint32_t* T, int y, int k, const tik::Bits& g) {
  if (y < 0 || y >= g.H || k < 0 || k >= g.WW) return 0u;
  return T[y * g.WW + k];
}

// vertex state of pixel bit j: 1 exterior, 2 top-level blob, 0 hole / nested
__device__ inline int state(uint32_t e, uint32_t t, int j) {
  return ((e >> j) & 1u) ? 1 : (((t >> j) & 1u) ? 2 : 0);
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
blob_filter_kernel(const uint8_t* __restrict__ fg, const uint8_t* __restrict__ roi,
                   const int* __restrict__ max_x2, const int* __restrict__ table,
                   const int* __restrict__ prog, uint8_t* __restrict__ out,
                   int* __restrict__ area_out, uint32_t* scratch, int* err, int H, int W,
                   int min_x2, int has_roi) {
  extern __shared__ uint32_t smem[];
  __shared__ int s_tab[81 * 3];
  __shared__ int s_area;
  const int u = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const tik::Bits g = tik::bits_of(H, W);
  const size_t hw = static_cast<size_t>(H) * W;
  const size_t off = static_cast<size_t>(u) * hw;
  uint32_t* base = kShared ? smem : scratch + static_cast<size_t>(u) * blob_unit_words(H, W);
  uint32_t* P0 = base;
  uint32_t* P1 = base + g.n;
  uint32_t* R = base + 2 * static_cast<size_t>(g.n);
  int* par_fill = reinterpret_cast<int*>(R);
  int* par_fg = par_fill + g.nb;
  uint8_t* o = out + off;

  for (int i = tid; i < 81 * 3; i += nt) s_tab[i] = table[i];
  if (tid == 0) s_area = 0;
  const uint8_t* f = fg + off;
  const uint8_t* ro = has_roi ? roi + off : nullptr;
  tik::pack(P0, g, [&](int i) { return f[i] != 0 && (!ro || ro[i] != 0); });
  __syncthreads();
  uint32_t* m = tik::apply_stages(prog, P0, P1, R, R + g.n, R + 2 * g.n, g);
  uint32_t* ext = (m == P0) ? P1 : P0;

  int any = 0;
  for (int w = tid; w < g.n; w += nt) any |= m[w] != 0u;
  if (!__syncthreads_or(any)) {
    // empty-candidate fast path: no contour, nothing kept
    for (size_t i = tid; i < hw; i += nt) o[i] = 0;
    if (tid == 0) area_out[u] = 0;
    return;
  }

  tik::exterior(m, ext, R, R + g.n, R + 2 * g.n, g);
  // fill regions: the 8-connected components of ~ext
  tik::label_blocks<kShared>(ext, true, par_fill, g, err);
  // each region's raster-first pixel p, as ~p (< 0) in its root's slot
  for (int b = tid; b < g.nb; b += nt) {
    if (tik::ldp<kShared>(par_fill + b) == b && tik::code_of(ext, b, true, g)) {
      par_fill[b] = INT_MIN;
    }
  }
  __syncthreads();
  for (int b = tid; b < g.nb; b += nt) {
    const int c = tik::code_of(ext, b, true, g);
    if (!c) continue;
    const int by = b / g.wb;
    const int row = (c & 3) ? c : (c >> 2);  // the block's first non-empty row
    const int y = 2 * by + ((c & 3) ? 0 : 1);
    const int x = 2 * (b - by * g.wb) + ((row & 1) ? 0 : 1);
    atomicMax(par_fill + tik::root_of<kShared>(par_fill, b), ~(y * W + x));
  }
  __syncthreads();
  // fg components; each region's top-level blob is the one holding the
  // region's first pixel (always fg): its key replaces ~p as ~key
  tik::label_blocks<kShared>(m, false, par_fg, g, err);
  for (int b = tid; b < g.nb; b += nt) {
    const int v = tik::ldp<kShared>(par_fill + b);
    if (v < 0 && tik::code_of(ext, b, true, g)) {
      const int p = ~v;
      const int y = p / W;
      const int x = p - y * W;
      par_fill[b] = ~tik::ldp<kShared>(par_fg + (y >> 1) * g.wb + (x >> 1));
    }
  }
  __syncthreads();
  // the top-level plane, in place of the candidate plane
  for (int w = tid; w < g.n; w += nt) {
    const uint32_t mw = m[w];
    if (!mw) continue;
    const int y = w / g.WW;
    const int row0 = (y >> 1) * g.wb + 16 * (w - y * g.WW);
    uint32_t pairs = (mw | (mw >> 1)) & 0x55555555u;
    uint32_t top = 0;
    while (pairs) {
      const int j = (__ffs(pairs) - 1) >> 1;
      pairs &= pairs - 1;
      const int b = row0 + j;
      const int key = ~tik::ldp<kShared>(par_fill + tik::root_of<kShared>(par_fill, b));
      if (tik::ldp<kShared>(par_fg + b) == key) top |= mw & (3u << (2 * j));
    }
    m[w] = top;
  }
  __syncthreads();
  // Green's sums per region, in the fg parents' place
  int* gsum = par_fg;
  for (int b = tid; b < g.nb; b += nt) gsum[b] = 0;
  __syncthreads();
  const int wv = (W + 32) >> 5;  // words of the W + 1 vertices of a row
  const int nv = (H + 1) * wv;
  for (int v = tid; v < nv; v += nt) {
    const int vy = v / wv;
    const int kv = v - vy * wv;
    // pixels (vy-1, vx-1) (vy-1, vx) (vy, vx-1) (vy, vx) of vertex vx
    const uint32_t e01 = ext_word(ext, vy - 1, kv, g);
    const uint32_t e00 = (e01 << 1) | (ext_word(ext, vy - 1, kv - 1, g) >> 31);
    const uint32_t e11 = ext_word(ext, vy, kv, g);
    const uint32_t e10 = (e11 << 1) | (ext_word(ext, vy, kv - 1, g) >> 31);
    const uint32_t t01 = top_word(m, vy - 1, kv, g);
    const uint32_t t00 = (t01 << 1) | (top_word(m, vy - 1, kv - 1, g) >> 31);
    const uint32_t t11 = top_word(m, vy, kv, g);
    const uint32_t t10 = (t11 << 1) | (top_word(m, vy, kv - 1, g) >> 31);
    const int nvalid = W + 1 - 32 * kv;
    const uint32_t vmask = nvalid >= 32 ? ~0u : ((1u << nvalid) - 1u);
    // a vertex whose four pixels share one state contributes nothing
    uint32_t mixed = ((e00 ^ e01) | (e00 ^ e10) | (e00 ^ e11) | (t00 ^ t01) | (t00 ^ t10) |
                      (t00 ^ t11)) & vmask;
    while (mixed) {
      const int j = __ffs(mixed) - 1;
      mixed &= mixed - 1;
      const int vx = 32 * kv + j;
      const int s00 = state(e00, t00, j);
      const int s01 = state(e01, t01, j);
      const int s10 = state(e10, t10, j);
      const int s11 = state(e11, t11, j);
      const int cfg = s00 + 3 * s01 + 9 * s10 + 27 * s11;
      const int contrib = s_tab[3 * cfg] + s_tab[3 * cfg + 1] * vx + s_tab[3 * cfg + 2] * vy;
      if (contrib == 0) continue;
      // the window's top-level pixels all belong to one region (distinct
      // regions are never 8-adjacent)
      int py = -1, px = -1;
      if (s11 == 2) {
        py = vy; px = vx;
      } else if (s10 == 2) {
        py = vy; px = vx - 1;
      } else if (s01 == 2) {
        py = vy - 1; px = vx;
      } else if (s00 == 2) {
        py = vy - 1; px = vx - 1;
      }
      if (py < 0) continue;
      atomicAdd(gsum + tik::root_of<kShared>(par_fill, (py >> 1) * g.wb + (px >> 1)), contrib);
    }
  }
  __syncthreads();
  // the kept regions' plane, in place of the top-level plane
  const int mx = max_x2[u];
  int cnt = 0;
  for (int w = tid; w < g.n; w += nt) {
    const int y = w / g.WW;
    const int k = w - y * g.WW;
    const uint32_t fw = ~ext[w] & tik::word_mask(g, k);
    uint32_t keep = 0;
    uint32_t pairs = (fw | (fw >> 1)) & 0x55555555u;
    const int row0 = (y >> 1) * g.wb + 16 * k;
    while (pairs) {
      const int j = (__ffs(pairs) - 1) >> 1;
      pairs &= pairs - 1;
      const int a2 = abs(tik::ldp<kShared>(gsum + tik::root_of<kShared>(par_fill, row0 + j)));
      if (a2 >= min_x2 && a2 <= mx) keep |= fw & (3u << (2 * j));
    }
    m[w] = keep;
    cnt += __popc(keep);
  }
  if (cnt) atomicAdd(&s_area, cnt);
  __syncthreads();
  tik::unpack(m, o, g);
  if (tid == 0) area_out[u] = s_area;
}

}  // namespace

// scratch: U * blob_unit_words(H, W) words, used only when a unit's layout
// does not fit a block's shared memory (scratch_words says how many the
// caller allocated); err: one int32, set by a root walk past its bound
extern "C" int tik_blob_filter(const void* fg, const void* roi, const void* max_x2,
                               const void* table, const void* prog, void* out, void* area,
                               void* scratch, long long scratch_words, void* err, int U, int H,
                               int W, int min_x2, int has_roi, void* stream) {
  if (U <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  const long long words = blob_unit_words(H, W);
  const size_t smem = static_cast<size_t>(words) * 4;
  int dev = 0;
  int optin = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const auto* f = static_cast<const uint8_t*>(fg);
  const auto* r = static_cast<const uint8_t*>(roi);
  const auto* mx = static_cast<const int*>(max_x2);
  const auto* tab = static_cast<const int*>(table);
  const auto* pr = static_cast<const int*>(prog);
  auto* o = static_cast<uint8_t*>(out);
  auto* a = static_cast<int*>(area);
  auto* sc = static_cast<uint32_t*>(scratch);
  auto* e = static_cast<int*>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // room for the kernel's static shared variables (the table, the area)
  if (smem + 1024 + 256 <= static_cast<size_t>(optin)) {
    rc = cudaFuncSetAttribute(blob_filter_kernel<true>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    blob_filter_kernel<true><<<U, kThreads, smem, s>>>(f, r, mx, tab, pr, o, a, sc, e, H, W,
                                                       min_x2, has_roi);
  } else {
    if (scratch_words < words * U) return static_cast<int>(cudaErrorInvalidValue);
    blob_filter_kernel<false><<<U, kThreads, 0, s>>>(f, r, mx, tab, pr, o, a, sc, e, H, W,
                                                     min_x2, has_roi);
  }
  return static_cast<int>(cudaGetLastError());
}
