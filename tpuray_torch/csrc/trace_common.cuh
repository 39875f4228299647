// Device code shared by the traversal kernels: K2 (trace.cu), K6
// (trace_chunked.cu), and K1 and K3 (trace_wide.cu). K2 and K6 run one walk
// (walk_subtree) over the same packed binary records; they differ in where
// a thread's origin, direction and t_max come from and in which tree
// (single tree, or a forest under its top-level tree) they walk. K1 and K3
// walk 4-wide records of the same tree (trace_wide.cu) with this file's
// ray, slab and triangle tests.
//
// Records (kernels/trace.py:pack_tables, trace_chunked.py:pack_forest).
// The SoA tables that the plain versions read (meta (5, n), aabb (6, n),
// tverts (12, T)) cost one scalar load per field, each in its own 32-byte
// sector. The kernels read records instead (the BVH2 layout of Aila and
// Laine, "Understanding the efficiency of ray traversal on GPUs", HPG 2009):
//
//   node record of inner node i, 64 bytes, four 16-byte loads:
//     [0]  L.min.x  L.max.x  L.min.y  L.max.y     (f32)
//     [1]  R.min.x  R.max.x  R.min.y  R.max.y     (f32)
//     [2]  L.min.z  L.max.z  R.min.z  R.max.z     (f32)
//     [3]  left ref, right ref, split axis, left_low   (i32)
//   triangle record, 48 bytes, three 16-byte loads: the 12 tverts values
//     in tri_test's order (n xyz, n.p0, T1 xyz, t1w, T2 xyz, t2w).
//
// A child ref >= 0 is an inner node's row (its record's index); a ref < 0
// is a leaf, ~ref = first_tri << 4 | tri_count. The root's own box is a
// separate 6-float operand, read once per ray.
//
// Exactness. The triangle test repeats the op order of
// tpuray_torch/integrator/intersect.py:ray_triangle_pre, which is the
// JAX package's, and the slab test that of intersect.ray_aabb (box - origin,
// then x inverse, then the same min/max tree). Built with -fmad=false,
// IEEE division and no fast math, a hit's t is bit-equal to the plain
// PyTorch version's. t_max <= 0 marks a dead lane: it never enters the tree.
#pragma once

#include <cuda_runtime.h>

namespace tpuray {

constexpr float kInf = 1e30f;
constexpr float kTMin = 5e-4f;
constexpr float kParallelEps = 1e-5f;
constexpr int kMaxStack = 128;  // kernels/trace.py:MAX_STACK, checked at pack time
constexpr int kBlock = 128;

struct Tables {
  const float4* __restrict__ nodes;    // (R, 4): one 64-byte record per node row
                                       // (K3: (R4, 8), one 128-byte wide record)
  const float4* __restrict__ tris;     // (T, 3): one 48-byte record per triangle
  const float* __restrict__ root_box;  // (6,) the root's box: min xyz, max xyz
  int root;                            // the root's ref (leaf refs < 0)
};

struct Tri {
  float nx, ny, nz, np0, t1x, t1y, t1z, t1w, t2x, t2y, t2z, t2w;
};

__device__ __forceinline__ Tri load_tri(const Tables& tb, int ti) {
  const float4* p = tb.tris + 3 * static_cast<size_t>(ti);
  const float4 a = __ldg(p);
  const float4 b = __ldg(p + 1);
  const float4 c = __ldg(p + 2);
  return Tri{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w};
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

// intersect.ray_triangle_pre, op for op. Returns hit; *t_hit gets the plane
// distance. An all-zero (degenerate or padding) triangle has n.d = 0 and
// never hits.
__device__ __forceinline__ bool tri_test(const Tri& tr, const Ray& r, float* t_hit) {
  const float ndotd = tr.nx * r.dx + tr.ny * r.dy + tr.nz * r.dz;
  const float ndoto = tr.nx * r.ox + tr.ny * r.oy + tr.nz * r.oz;
  const bool invalid = fabsf(ndotd) < kParallelEps;
  const float denom = invalid ? 1.0f : ndotd;
  const float t = (tr.np0 - ndoto) / denom;
  const float px = r.ox + r.dx * t;
  const float py = r.oy + r.dy * t;
  const float pz = r.oz + r.dz * t;
  const float u = tr.t1x * px + tr.t1y * py + tr.t1z * pz + tr.t1w;
  const float v = tr.t2x * px + tr.t2y * py + tr.t2z * pz + tr.t2w;
  const bool in_tri = (u > 0.0f) && (v > 0.0f) && (u + v < 1.0f);
  *t_hit = t;
  return !invalid && (t >= kTMin) && in_tri;
}

// intersect.ray_aabb: the box [lo, hi] overlaps (0, limit] along the ray;
// *t_entry gets the slab's entry distance t0 (K3 orders children by it)
__device__ __forceinline__ bool slab_t0(float lox, float hix, float loy, float hiy,
                                        float loz, float hiz, const Ray& r, float limit,
                                        float* t_entry) {
  const float f0 = (hix - r.ox) * r.ix;
  const float n0 = (lox - r.ox) * r.ix;
  const float f1 = (hiy - r.oy) * r.iy;
  const float n1 = (loy - r.oy) * r.iy;
  const float f2 = (hiz - r.oz) * r.iz;
  const float n2 = (loz - r.oz) * r.iz;
  const float t1 = fminf(fmaxf(f0, n0), fminf(fmaxf(f1, n1), fmaxf(f2, n2)));
  const float t0 = fmaxf(fminf(f0, n0), fmaxf(fminf(f1, n1), fminf(f2, n2)));
  *t_entry = t0;
  return (t1 >= fmaxf(t0, 0.0f)) && (t0 < limit) && (t1 > 0.0f);
}

__device__ __forceinline__ bool slab(float lox, float hix, float loy, float hiy,
                                     float loz, float hiz, const Ray& r, float limit) {
  float t0;
  return slab_t0(lox, hix, loy, hiy, loz, hiz, r, limit, &t0);
}

// Scan leaf ~ref's triangles: update (*t, *idx) on strictly closer hits
// below tm; an any-hit ray stops at its first hit.
template <bool kAnyHit>
__device__ __forceinline__ void scan_leaf(const Tables& tb, int ref, const Ray& r,
                                          float tm, float* t, int* idx) {
  const int first = (~ref) >> 4;
  const int count = (~ref) & 15;
  for (int j = 0; j < count; ++j) {
    const int ti = first + j;
    float th;
    if (tri_test(load_tri(tb, ti), r, &th) && th < *t && th < tm) {
      *t = th;
      *idx = ti;
      if (kAnyHit) return;
    }
  }
}

// Closest-hit (or any-hit) walk of the subtree at `root` (a ref), whose box
// the caller has entered: a DFS with a per-thread stack, children
// near-first by the ray's own direction sign on the node's split axis,
// leaf children scanned as soon as they are entered. One node visit is the
// four 16-byte loads of its record and two slab tests against
// min(t, tm), which culls whole subtrees (whole chunks, under a forest's
// top-level tree) that lie beyond the best hit.
template <bool kAnyHit>
__device__ __forceinline__ void walk_subtree(const Tables& tb, int root, const Ray& r,
                                             float tm, float* t, int* idx) {
  if (root < 0) {
    scan_leaf<kAnyHit>(tb, root, r, tm, t, idx);
    return;
  }
  int stack[kMaxStack];
  int sp = 0;
  stack[sp++] = root;
  while (sp > 0) {
    if (kAnyHit && *idx >= 0) break;
    const float4* rec = tb.nodes + 4 * static_cast<size_t>(stack[--sp]);
    const float4 lxy = __ldg(rec);
    const float4 rxy = __ldg(rec + 1);
    const float4 z = __ldg(rec + 2);
    const int4 link = __ldg(reinterpret_cast<const int4*>(rec + 3));
    const float limit = fminf(*t, tm);
    const bool hl = slab(lxy.x, lxy.y, lxy.z, lxy.w, z.x, z.y, r, limit);
    const bool hr = slab(rxy.x, rxy.y, rxy.z, rxy.w, z.z, z.w, r, limit);
    if (!hl && !hr) continue;
    const float da = link.z == 0 ? r.dx : (link.z == 1 ? r.dy : r.dz);
    const bool nl = (da > 0.0f) == (link.w == 1);
    const int near = nl ? link.x : link.y;
    const int far = nl ? link.y : link.x;
    const bool hn = nl ? hl : hr;
    const bool hf = nl ? hr : hl;
    // leaf children are scanned now, inner ones pushed far below near
    if (hn && near < 0) scan_leaf<kAnyHit>(tb, near, r, tm, t, idx);
    if (hf && far < 0 && !(kAnyHit && *idx >= 0)) scan_leaf<kAnyHit>(tb, far, r, tm, t, idx);
    if (hf && far >= 0) stack[sp++] = far;
    if (hn && near >= 0) stack[sp++] = near;
  }
}

// One ray from the root: (INF, -1) on a miss; a dead lane (tm <= 0) never
// enters the tree.
template <bool kAnyHit>
__device__ __forceinline__ void trace_ray(const Tables& tb, const Ray& r, float tm,
                                          float* t, int* idx) {
  *t = kInf;
  *idx = -1;
  const float* b = tb.root_box;
  if (tm > 0.0f && slab(__ldg(b), __ldg(b + 3), __ldg(b + 1), __ldg(b + 4), __ldg(b + 2),
                        __ldg(b + 5), r, tm))
    walk_subtree<kAnyHit>(tb, tb.root, r, tm, t, idx);
}

}  // namespace tpuray
