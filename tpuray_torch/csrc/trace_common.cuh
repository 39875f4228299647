// Device code shared by the traversal kernels: K1 and K3 (trace.cu), K2
// (trace.cu) and K6 (trace_chunked.cu).
//
// Exactness. The triangle test repeats the op order of
// tpuray_torch/integrator/intersect.py:ray_triangle_pre, which is the
// JAX package's. Built with -fmad=false, IEEE division and no fast math, a
// hit's t is bit-equal to the plain PyTorch version's. t_max <= 0 marks a
// dead lane: it never enters the tree.
#pragma once

#include <cuda_runtime.h>

namespace tpuray {

constexpr float kInf = 1e30f;
constexpr float kTMin = 5e-4f;
constexpr float kParallelEps = 1e-5f;
constexpr int kMaxStack = 128;  // kernels/trace.py:MAX_STACK, checked at pack time
constexpr int kBlock = 128;

struct Tables {
  const int* __restrict__ meta;      // (5, n_nodes) first_tri; tri_count; right; axis; left_low
  const float* __restrict__ aabb;    // (6, n_nodes) min xyz; max xyz
  const float* __restrict__ tverts;  // (12, n_tris) n xyz; n.p0; T1 xyz; t1w; T2 xyz; t2w
  int n_nodes;
  int n_tris;

  __device__ __forceinline__ int m(int row, int node) const {
    return __ldg(meta + static_cast<size_t>(row) * n_nodes + node);
  }
  __device__ __forceinline__ float box(int row, int node) const {
    return __ldg(aabb + static_cast<size_t>(row) * n_nodes + node);
  }
  __device__ __forceinline__ float tv(int row, int tri) const {
    return __ldg(tverts + static_cast<size_t>(row) * n_tris + tri);
  }
};

struct Tri {
  float nx, ny, nz, np0, t1x, t1y, t1z, t1w, t2x, t2y, t2z, t2w;
};

__device__ __forceinline__ Tri load_tri(const Tables& tb, int ti) {
  Tri r;
  r.nx = tb.tv(0, ti);
  r.ny = tb.tv(1, ti);
  r.nz = tb.tv(2, ti);
  r.np0 = tb.tv(3, ti);
  r.t1x = tb.tv(4, ti);
  r.t1y = tb.tv(5, ti);
  r.t1z = tb.tv(6, ti);
  r.t1w = tb.tv(7, ti);
  r.t2x = tb.tv(8, ti);
  r.t2y = tb.tv(9, ti);
  r.t2z = tb.tv(10, ti);
  r.t2w = tb.tv(11, ti);
  return r;
}

__device__ __forceinline__ float safe_inv(float v) {
  const float tiny = v < 0.0f ? -1e-20f : 1e-20f;
  return 1.0f / (fabsf(v) < 1e-20f ? tiny : v);
}

// One ray: origin, direction, and the direction's safe inverse.
struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ Ray make_ray(const float* o, const float* d) {
  Ray r;
  r.ox = o[0];
  r.oy = o[1];
  r.oz = o[2];
  r.dx = d[0];
  r.dy = d[1];
  r.dz = d[2];
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  return r;
}

// intersect.ray_triangle_pre, op for op; ndoto = n.o is passed in because
// K2's classes share it. Returns hit; *t_hit gets the plane distance. An
// all-zero (degenerate or padding) triangle has n.d = 0 and never hits.
__device__ __forceinline__ bool tri_test(const Tri& r, float ndoto,
                                         float ox, float oy, float oz,
                                         float dx, float dy, float dz,
                                         float* t_hit) {
  const float ndotd = r.nx * dx + r.ny * dy + r.nz * dz;
  const bool invalid = fabsf(ndotd) < kParallelEps;
  const float denom = invalid ? 1.0f : ndotd;
  const float t = (r.np0 - ndoto) / denom;
  const float px = ox + dx * t;
  const float py = oy + dy * t;
  const float pz = oz + dz * t;
  const float u = r.t1x * px + r.t1y * py + r.t1z * pz + r.t1w;
  const float v = r.t2x * px + r.t2y * py + r.t2z * pz + r.t2w;
  const bool in_tri = (u > 0.0f) && (v > 0.0f) && (u + v < 1.0f);
  *t_hit = t;
  return !invalid && (t >= kTMin) && in_tri;
}

struct BoxDiff {
  float minx, miny, minz, maxx, maxy, maxz;  // bound - origin
};

__device__ __forceinline__ BoxDiff box_diff(const Tables& tb, int node,
                                            float ox, float oy, float oz) {
  BoxDiff b;
  b.minx = tb.box(0, node) - ox;
  b.miny = tb.box(1, node) - oy;
  b.minz = tb.box(2, node) - oz;
  b.maxx = tb.box(3, node) - ox;
  b.maxy = tb.box(4, node) - oy;
  b.maxz = tb.box(5, node) - oz;
  return b;
}

// intersect.ray_aabb: the box overlaps (0, limit] along the ray; *t0 gets
// the entry distance
__device__ __forceinline__ bool slab_t0(const BoxDiff& b, float ix, float iy,
                                        float iz, float limit, float* t0_out) {
  const float f0 = b.maxx * ix;
  const float n0 = b.minx * ix;
  const float f1 = b.maxy * iy;
  const float n1 = b.miny * iy;
  const float f2 = b.maxz * iz;
  const float n2 = b.minz * iz;
  const float t1 = fminf(fmaxf(f0, n0), fminf(fmaxf(f1, n1), fmaxf(f2, n2)));
  const float t0 = fmaxf(fminf(f0, n0), fmaxf(fminf(f1, n1), fminf(f2, n2)));
  *t0_out = t0;
  return (t1 >= fmaxf(t0, 0.0f)) && (t0 < limit) && (t1 > 0.0f);
}

__device__ __forceinline__ bool slab(const BoxDiff& b, float ix, float iy,
                                     float iz, float limit) {
  float t0;
  return slab_t0(b, ix, iy, iz, limit, &t0);
}

// Which child of `node` is near for a ray whose direction component on the
// node's split axis is d_axis.
__device__ __forceinline__ bool near_is_left(const Tables& tb, int node,
                                             float dx, float dy, float dz) {
  const int axis = tb.m(3, node);
  const float da = axis == 0 ? dx : (axis == 1 ? dy : dz);
  return (da > 0.0f) == (tb.m(4, node) == 1);
}

// Closest-hit (or any-hit) walk of the subtree at `root`, whose box the
// caller has entered: a DFS with a per-thread stack, children near-first
// by the ray's own direction, leaf children scanned as soon as they are
// entered. Updates (*t, *idx) on strictly closer hits below tm.
template <bool kAnyHit>
__device__ __forceinline__ void walk_subtree(const Tables& tb, int root,
                                             const Ray& r, float tm,
                                             float* t, int* idx) {
  auto scan_leaf = [&](int node) {
    const int first = tb.m(0, node);
    const int count = tb.m(1, node);
    for (int j = 0; j < count; ++j) {
      const int ti = first + j;
      const Tri tri = load_tri(tb, ti);
      const float ndoto = tri.nx * r.ox + tri.ny * r.oy + tri.nz * r.oz;
      float th;
      if (tri_test(tri, ndoto, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, &th) &&
          th < *t && th < tm) {
        *t = th;
        *idx = ti;
        if (kAnyHit) return;
      }
    }
  };

  if (tb.m(1, root) > 0) {
    scan_leaf(root);
    return;
  }
  int stack[kMaxStack];
  int sp = 0;
  stack[sp++] = root;
  while (sp > 0) {
    if (kAnyHit && *idx >= 0) break;
    const int node = stack[--sp];
    const int left = node + 1;
    const int right = tb.m(2, node);
    const float limit = fminf(*t, tm);
    const bool hl = slab(box_diff(tb, left, r.ox, r.oy, r.oz), r.ix, r.iy, r.iz, limit);
    const bool hr = slab(box_diff(tb, right, r.ox, r.oy, r.oz), r.ix, r.iy, r.iz, limit);
    if (!hl && !hr) continue;
    const bool nl = near_is_left(tb, node, r.dx, r.dy, r.dz);
    const int near = nl ? left : right;
    const int far = nl ? right : left;
    const int cn = (nl ? hl : hr) ? tb.m(1, near) : -1;
    const int cf = (nl ? hr : hl) ? tb.m(1, far) : -1;
    // leaf children are scanned now, inner ones pushed far below near
    if (cn > 0) scan_leaf(near);
    if (cf > 0 && !(kAnyHit && *idx >= 0)) scan_leaf(far);
    if (cf == 0) stack[sp++] = far;
    if (cn == 0) stack[sp++] = near;
  }
}

}  // namespace tpuray
