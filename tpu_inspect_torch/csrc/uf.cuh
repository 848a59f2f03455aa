// Union-find over the pixels of a [U, H, W] batch, shared by kernel D
// (flood.cu, seeded reachability) and kernel E (label.cu, min-index labels);
// kernel J (label_stats.cu) and kernels A, C and K (planes.cuh:
// label_blocks) run the same find and union over one unit's 2x2 block grid
// inside one CTA.
//
// One thread per pixel over the whole batch (a grid over pixels, not one CTA
// per unit). Pixels are global indices g = u*H*W + y*W + x; unions never
// cross units, because a pixel only links to in-plane neighbours. A union
// always hangs the larger root under the smaller (atomicMin on the parent
// slot, Playne & Hawick's lock-free union), so parent indices strictly
// decrease along every path and each component's root is its smallest
// index: the raster-first pixel. That is exactly the label the contour
// analysis compares, with no key tables.
//
// The passes are fixed (init, link, resolve), not a fixpoint: the depth of a
// thin 8-connected curve (a Canny edge) costs nothing extra. The only loops
// are a root walk and a union retry; both are bounded by the pixel count,
// and a walk past its bound sets *err (the wrapper raises) instead of
// returning a silently wrong plane.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace tik {
namespace uf {

constexpr int kThreads = 256;

inline int grid_for(int n) { return (n + kThreads - 1) / kThreads; }

// Parent reads bypass L1 (ld.global.cg): other threads' atomicMin links
// land in L2, and a stale L1 line would only cost extra retries. With
// kShared the parents live in the CTA's shared memory (kernel J): volatile
// reads, so every step sees the other threads' links.
template <bool kShared = false>
__device__ inline int load_parent(const int* parent, int x) {
  if constexpr (kShared) {
    return *reinterpret_cast<const volatile int*>(parent + x);
  } else {
    return __ldcg(parent + x);
  }
}

// With kShared the walk also halves the path (each node it passes is hung
// under its grandparent), a store that costs little in shared memory. That
// is safe beside concurrent unions: the store only replaces a non-root's
// parent with one of its ancestors, so indices still decrease along every
// path, and a union whose atomicMin it overwrites has seen a non-root and
// retries with that node's parent.
template <bool kShared = false>
__device__ inline int find_root(int* parent, int x, int n, int* err) {
  int p = load_parent<kShared>(parent, x);
  for (int steps = 0; p != x; ++steps) {
    if (steps > n) {
      atomicExch(err, 1);
      break;
    }
    if constexpr (kShared) {
      const int gp = load_parent<kShared>(parent, p);
      if (gp != p) {
        *reinterpret_cast<volatile int*>(parent + x) = gp;
        p = gp;
      }
    }
    x = p;
    p = load_parent<kShared>(parent, x);
  }
  return x;
}

template <bool kShared = false>
__device__ inline void unite(int* parent, int a, int b, int n, int* err) {
  for (int iter = 0; iter <= n; ++iter) {
    a = find_root<kShared>(parent, a, n, err);
    b = find_root<kShared>(parent, b, n, err);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(parent + b, a);
    if (old == b) return;  // b was still a root: now hung under a
    // b had been linked to `old` meanwhile: join a with that tree too
    b = old;
  }
  atomicExch(err, 2);
}

static __global__ void __launch_bounds__(kThreads)
init_kernel(int* __restrict__ parent, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) parent[i] = i;
}

// Link every domain pixel to its domain neighbours east, south and (8-conn)
// south-east / south-west. A diagonal link is skipped where the straight
// links already join the pair through a shared neighbour.
static __global__ void __launch_bounds__(kThreads)
link_kernel(const uint8_t* __restrict__ dom, int* parent, int* err, int H,
            int W, int n, int conn8) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !dom[i]) return;
  const int r = i % (H * W);
  const int y = r / W;
  const int x = r - y * W;
  const bool e = x + 1 < W && dom[i + 1];
  if (e) unite(parent, i, i + 1, n, err);
  if (y + 1 >= H) return;
  const int s = i + W;
  const bool so = dom[s] != 0;
  if (so) unite(parent, i, s, n, err);
  if (!conn8 || so) return;
  // south is off the domain: SE already joins through east, SW through west
  if (!e && x + 1 < W && dom[s + 1]) unite(parent, i, s + 1, n, err);
  if (x > 0 && !dom[i - 1] && dom[s - 1]) unite(parent, i, s - 1, n, err);
}

}  // namespace uf
}  // namespace tik
