// BVH traversal kernels for the H100 (sm_90a), hand-written CUDA C++.
//
// Replaces tpuray/kernels/trace_pallas.py:_kernel (K1: closest-hit or
// any-hit trace of the camera primaries, common origin),
// trace_pallas.py:_kernel_batched (K3: the same function for incoherent
// rays with per-ray origins: the separate-walk shadow and bounce rays and
// the MIS integrator's walks) and trace_pallas.py:_kernel_multi (K2: one
// walk for up to three ray classes that share their origins: the bounce
// ray, the env-map shadow ray and the point-light shadow ray of one
// bounce). The forest walk K6 is trace_chunked.cu; the device code all of
// them share is trace_common.cuh.
//
// Design. The TPU kernels walk a 32x128 packet in lock step with one scalar
// stack in SMEM (K3 pops up to 8 nodes a step to hide the TPU's
// vector-to-scalar stalls). Here one thread walks one ray with its own stack
// of kMaxStack int32 in local memory (pack_scene in kernels/trace.py checks
// that no DFS order of the tree can need more). Children are visited near
// first by the ray's own direction sign on the node's split axis. The
// node and triangle tables stay in device memory and are read through the
// read-only cache; a 20k-triangle scene is ~1.3 MB, far inside the 50 MB L2.
// K1 and K3 are one walk (walk_subtree) and differ only in where the
// origin comes from.
//
// What bounds it on this card: dependent global loads (the node record,
// then its children, then up to eight triangle records) at every node
// visit, and warp divergence between rays that take different paths (K3's
// incoherent rays most). Not FLOPs, and not device-memory bandwidth. wgmma
// and TMA have nothing to do in a pointer-chasing walk. This first version
// does nothing about either bound; wide nodes, ray sorting or persistent
// threads are later work.

#include "trace_common.cuh"

namespace {

using namespace tpuray;

// ---------------------------------------------------------------- K1, K3
template <bool kAnyHit, bool kCommonOrigin>
__global__ void __launch_bounds__(kBlock)
trace_k1(Tables tb, const float* __restrict__ orig,
         const float* __restrict__ dir, const float* __restrict__ t_max,
         float* __restrict__ t_out, int* __restrict__ idx_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = make_ray(kCommonOrigin ? orig : orig + 3 * static_cast<size_t>(i),
                         dir + 3 * static_cast<size_t>(i));
  const float tm = t_max[i];
  float t = kInf;
  int idx = -1;
  // a dead lane (t_max <= 0) never enters the tree
  if (tm > 0.0f && slab(box_diff(tb, 0, r.ox, r.oy, r.oz), r.ix, r.iy, r.iz, tm))
    walk_subtree<kAnyHit>(tb, 0, r, tm, &t, &idx);
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

template <bool kCommonOrigin>
int launch_k1(const int* meta, const float* aabb, const float* tverts,
              int n_nodes, int n_tris, const float* orig, const float* dir,
              const float* t_max, float* t_out, int* idx_out, int n,
              int any_hit, void* stream) {
  if (n <= 0) return 0;
  const Tables tb{meta, aabb, tverts, n_nodes, n_tris};
  const dim3 grid((n + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit)
    trace_k1<true, kCommonOrigin><<<grid, kBlock, 0, s>>>(tb, orig, dir, t_max, t_out, idx_out, n);
  else
    trace_k1<false, kCommonOrigin><<<grid, kBlock, 0, s>>>(tb, orig, dir, t_max, t_out, idx_out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1. orig (1, 3), shared by every ray; dir (n, 3); t_max (n,); outputs
// t_out (n,) f32, idx_out (n,) i32. Returns the cudaError_t of the launch
// (0 = success).
int tpuray_trace_packets(const int* meta, const float* aabb,
                         const float* tverts, int n_nodes, int n_tris,
                         const float* orig, const float* dir,
                         const float* t_max, float* t_out, int* idx_out,
                         int n, int any_hit, void* stream) {
  return launch_k1<true>(meta, aabb, tverts, n_nodes, n_tris, orig, dir, t_max,
                         t_out, idx_out, n, any_hit, stream);
}

// K3. As K1 with per-ray origins orig (n, 3).
int tpuray_trace_batched(const int* meta, const float* aabb,
                         const float* tverts, int n_nodes, int n_tris,
                         const float* orig, const float* dir,
                         const float* t_max, float* t_out, int* idx_out,
                         int n, int any_hit, void* stream) {
  return launch_k1<false>(meta, aabb, tverts, n_nodes, n_tris, orig, dir, t_max,
                          t_out, idx_out, n, any_hit, stream);
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
