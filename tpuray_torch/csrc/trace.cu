// BVH traversal kernels for the H100 (sm_90a), hand-written CUDA C++.
//
// Replaces tpuray/kernels/trace_pallas.py:_kernel (K1: closest-hit or
// any-hit trace of the camera primaries, common origin) and
// trace_pallas.py:_kernel_multi (K2: one walk for up to three ray classes
// that share their origins: the bounce ray, the env-map shadow ray and the
// point-light shadow ray of one bounce).
//
// Design. The TPU kernels walk a 32x128 packet in lock step with one scalar
// stack in SMEM. Here one thread walks one ray with its own stack of
// kMaxStack int32 in local memory (pack_scene in kernels/trace.py checks
// that no DFS order of the tree can need more). Children are visited near
// first by the ray's own direction sign on the node's split axis. The
// node and triangle tables stay in device memory and are read through the
// read-only cache; a 20k-triangle scene is ~1.3 MB, far inside the 50 MB L2.
//
// What bounds it on this card: dependent global loads (the node record,
// then its children, then up to eight triangle records) at every node
// visit, and warp divergence between rays that take different paths. Not
// FLOPs, and not device-memory bandwidth. wgmma and TMA have nothing to do
// in a pointer-chasing walk. This first version does nothing about either
// bound; wide nodes, ray sorting or persistent threads are later work.
//
// Exactness. The triangle test repeats the op order of
// tpuray_torch/integrator/intersect.py:ray_triangle_pre, which is the
// JAX package's. Built with -fmad=false, IEEE division and no fast math, a
// hit's t is bit-equal to the plain PyTorch version's. t_max <= 0 marks a
// dead lane: it is snapped to -INF so it fails every slab test, even with
// its origin inside a box.

#include <cuda_runtime.h>

namespace {

constexpr float kInf = 1e30f;
constexpr float kTMin = 5e-4f;
constexpr float kParallelEps = 1e-5f;
constexpr int kMaxStack = 128;
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

// intersect.ray_triangle_pre, op for op; ndoto = n.o is passed in because
// K2's classes share it. Returns hit; *t_hit gets the plane distance.
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

// intersect.ray_aabb: the box overlaps (0, limit] along the ray
__device__ __forceinline__ bool slab(const BoxDiff& b, float ix, float iy,
                                     float iz, float limit) {
  const float f0 = b.maxx * ix;
  const float n0 = b.minx * ix;
  const float f1 = b.maxy * iy;
  const float n1 = b.miny * iy;
  const float f2 = b.maxz * iz;
  const float n2 = b.minz * iz;
  const float t1 = fminf(fmaxf(f0, n0), fminf(fmaxf(f1, n1), fmaxf(f2, n2)));
  const float t0 = fmaxf(fminf(f0, n0), fmaxf(fminf(f1, n1), fminf(f2, n2)));
  return (t1 >= fmaxf(t0, 0.0f)) && (t0 < limit) && (t1 > 0.0f);
}

// Which child of `node` is near for a ray whose direction component on the
// node's split axis is d_axis.
__device__ __forceinline__ bool near_is_left(const Tables& tb, int node,
                                             float dx, float dy, float dz) {
  const int axis = tb.m(3, node);
  const float da = axis == 0 ? dx : (axis == 1 ? dy : dz);
  return (da > 0.0f) == (tb.m(4, node) == 1);
}

// ---------------------------------------------------------------- K1
template <bool kAnyHit, bool kCommonOrigin>
__global__ void __launch_bounds__(kBlock)
trace_k1(Tables tb, const float* __restrict__ orig,
         const float* __restrict__ dir, const float* __restrict__ t_max,
         float* __restrict__ t_out, int* __restrict__ idx_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* o = kCommonOrigin ? orig : orig + 3 * static_cast<size_t>(i);
  const float ox = o[0], oy = o[1], oz = o[2];
  const float dx = dir[3 * static_cast<size_t>(i)];
  const float dy = dir[3 * static_cast<size_t>(i) + 1];
  const float dz = dir[3 * static_cast<size_t>(i) + 2];
  const float tm = t_max[i];
  float t = kInf;
  int idx = -1;

  if (tm > 0.0f) {  // a dead lane (t_max <= 0) never enters the tree
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);

    auto scan_leaf = [&](int node) {
      const int first = tb.m(0, node);
      const int count = tb.m(1, node);
      for (int j = 0; j < count; ++j) {
        const int ti = first + j;
        const Tri r = load_tri(tb, ti);
        const float ndoto = r.nx * ox + r.ny * oy + r.nz * oz;
        float th;
        if (tri_test(r, ndoto, ox, oy, oz, dx, dy, dz, &th) && th < t &&
            th < tm) {
          t = th;
          idx = ti;
          if (kAnyHit) return;
        }
      }
    };

    int stack[kMaxStack];
    int sp = 0;
    if (slab(box_diff(tb, 0, ox, oy, oz), ix, iy, iz, fminf(t, tm))) {
      if (tb.m(1, 0) > 0) {
        scan_leaf(0);
      } else {
        stack[sp++] = 0;
      }
    }
    while (sp > 0) {
      if (kAnyHit && idx >= 0) break;
      const int node = stack[--sp];
      const int left = node + 1;
      const int right = tb.m(2, node);
      const float limit = fminf(t, tm);
      const bool hl = slab(box_diff(tb, left, ox, oy, oz), ix, iy, iz, limit);
      const bool hr = slab(box_diff(tb, right, ox, oy, oz), ix, iy, iz, limit);
      if (!hl && !hr) continue;
      const bool nl = near_is_left(tb, node, dx, dy, dz);
      const int near = nl ? left : right;
      const int far = nl ? right : left;
      const int cn = (nl ? hl : hr) ? tb.m(1, near) : -1;
      const int cf = (nl ? hr : hl) ? tb.m(1, far) : -1;
      // leaf children are scanned now, inner ones pushed far below near
      if (cn > 0) scan_leaf(near);
      if (cf > 0 && !(kAnyHit && idx >= 0)) scan_leaf(far);
      if (cf == 0) stack[sp++] = far;
      if (cn == 0) stack[sp++] = near;
    }
  }
  t_out[i] = t;
  idx_out[i] = idx;
}

// ---------------------------------------------------------------- K2
struct MultiArgs {
  const float* dir[3];
  const float* t_max[3];
  float* t_out[3];
  int* idx_out[3];
};

template <int M>
__global__ void __launch_bounds__(kBlock)
trace_k2(Tables tb, const float* __restrict__ orig, MultiArgs a,
         int any_mask, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = orig[3 * static_cast<size_t>(i)];
  const float oy = orig[3 * static_cast<size_t>(i) + 1];
  const float oz = orig[3 * static_cast<size_t>(i) + 2];
  float dx[M], dy[M], dz[M], ix[M], iy[M], iz[M], tm[M], t[M];
  int idx[M];
  bool any[M];
  bool live_any = false;
#pragma unroll
  for (int c = 0; c < M; ++c) {
    dx[c] = a.dir[c][3 * static_cast<size_t>(i)];
    dy[c] = a.dir[c][3 * static_cast<size_t>(i) + 1];
    dz[c] = a.dir[c][3 * static_cast<size_t>(i) + 2];
    ix[c] = safe_inv(dx[c]);
    iy[c] = safe_inv(dy[c]);
    iz[c] = safe_inv(dz[c]);
    const float tmi = a.t_max[c][i];
    tm[c] = tmi <= 0.0f ? -kInf : tmi;  // dead class of this lane
    live_any |= tmi > 0.0f;
    t[c] = kInf;
    idx[c] = -1;
    any[c] = (any_mask >> c) & 1;
  }

  // the union walk is over once every class is dead or has its any-hit
  auto all_done = [&]() {
    bool done = true;
#pragma unroll
    for (int c = 0; c < M; ++c)
      done &= (tm[c] == -kInf) || (any[c] && idx[c] >= 0);
    return done;
  };
  // per-class slab hits of one node against the current limits, as a mask
  auto slab_mask = [&](int node) {
    const BoxDiff b = box_diff(tb, node, ox, oy, oz);
    int mask = 0;
#pragma unroll
    for (int c = 0; c < M; ++c) {
      const float limit = (any[c] && idx[c] >= 0) ? -kInf : fminf(t[c], tm[c]);
      mask |= slab(b, ix[c], iy[c], iz[c], limit) ? (1 << c) : 0;
    }
    return mask;
  };
  // leaf scan: each class tests only if its own slab test entered the leaf
  auto scan_leaf = [&](int node, int mask) {
    float tl[M];
#pragma unroll
    for (int c = 0; c < M; ++c) {
      tl[c] = ((mask >> c) & 1) ? fminf(t[c], tm[c]) : -kInf;
      if (any[c] && idx[c] >= 0) tl[c] = -kInf;
    }
    const int first = tb.m(0, node);
    const int count = tb.m(1, node);
    for (int j = 0; j < count; ++j) {
      const int ti = first + j;
      const Tri r = load_tri(tb, ti);
      const float ndoto = r.nx * ox + r.ny * oy + r.nz * oz;
#pragma unroll
      for (int c = 0; c < M; ++c) {
        float th;
        if (tri_test(r, ndoto, ox, oy, oz, dx[c], dy[c], dz[c], &th) &&
            th < tl[c]) {
          t[c] = th;
          idx[c] = ti;
          tl[c] = fminf(tl[c], th);
          if (any[c]) tl[c] = -kInf;
        }
      }
    }
  };

  if (live_any) {
    int stack[kMaxStack];
    int sp = 0;
    const int root = slab_mask(0);
    if (root) {
      if (tb.m(1, 0) > 0) {
        scan_leaf(0, root);
      } else {
        stack[sp++] = 0;
      }
    }
    while (sp > 0) {
      if (all_done()) break;
      const int node = stack[--sp];
      const int left = node + 1;
      const int right = tb.m(2, node);
      const int hl = slab_mask(left);
      const int hr = slab_mask(right);
      if (!hl && !hr) continue;
      // near-first by class 0's direction (the closest-hit bounce class
      // when present; any-hit classes do not care about order)
      const bool nl = near_is_left(tb, node, dx[0], dy[0], dz[0]);
      const int near = nl ? left : right;
      const int far = nl ? right : left;
      const int hn = nl ? hl : hr;
      const int hf = nl ? hr : hl;
      const int cn = hn ? tb.m(1, near) : -1;
      const int cf = hf ? tb.m(1, far) : -1;
      if (cn > 0) scan_leaf(near, hn);
      if (cf > 0) scan_leaf(far, hf);
      if (cf == 0) stack[sp++] = far;
      if (cn == 0) stack[sp++] = near;
    }
  }
#pragma unroll
  for (int c = 0; c < M; ++c) {
    a.t_out[c][i] = t[c];
    a.idx_out[c][i] = idx[c];
  }
}

}  // namespace

extern "C" {

// K1. orig is (1, 3) when common_origin, else (n, 3); dir (n, 3);
// t_max (n,); outputs t_out (n,) f32, idx_out (n,) i32. Returns the
// cudaError_t of the launch (0 = success).
int tpuray_trace_packets(const int* meta, const float* aabb,
                         const float* tverts, int n_nodes, int n_tris,
                         const float* orig, const float* dir,
                         const float* t_max, float* t_out, int* idx_out,
                         int n, int any_hit, int common_origin,
                         void* stream) {
  if (n <= 0) return 0;
  const Tables tb{meta, aabb, tverts, n_nodes, n_tris};
  const dim3 grid((n + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit) {
    if (common_origin)
      trace_k1<true, true><<<grid, kBlock, 0, s>>>(tb, orig, dir, t_max, t_out, idx_out, n);
    else
      trace_k1<true, false><<<grid, kBlock, 0, s>>>(tb, orig, dir, t_max, t_out, idx_out, n);
  } else {
    if (common_origin)
      trace_k1<false, true><<<grid, kBlock, 0, s>>>(tb, orig, dir, t_max, t_out, idx_out, n);
    else
      trace_k1<false, false><<<grid, kBlock, 0, s>>>(tb, orig, dir, t_max, t_out, idx_out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2. m classes (1..3) from shared per-ray origins orig (n, 3); class c has
// dirs[c] (n, 3), t_maxs[c] (n,) and is any-hit iff bit c of any_mask.
// Unused class slots are NULL.
int tpuray_trace_multi(const int* meta, const float* aabb,
                       const float* tverts, int n_nodes, int n_tris,
                       const float* orig,
                       const float* d0, const float* d1, const float* d2,
                       const float* tm0, const float* tm1, const float* tm2,
                       float* t0, float* t1, float* t2,
                       int* i0, int* i1, int* i2,
                       int n, int m, int any_mask, void* stream) {
  if (n <= 0) return 0;
  if (m < 1 || m > 3) return static_cast<int>(cudaErrorInvalidValue);
  const Tables tb{meta, aabb, tverts, n_nodes, n_tris};
  const MultiArgs a{{d0, d1, d2}, {tm0, tm1, tm2}, {t0, t1, t2}, {i0, i1, i2}};
  const dim3 grid((n + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 1)
    trace_k2<1><<<grid, kBlock, 0, s>>>(tb, orig, a, any_mask, n);
  else if (m == 2)
    trace_k2<2><<<grid, kBlock, 0, s>>>(tb, orig, a, any_mask, n);
  else
    trace_k2<3><<<grid, kBlock, 0, s>>>(tb, orig, a, any_mask, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
