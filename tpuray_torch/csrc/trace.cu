// BVH traversal kernels for the H100 (sm_90a), hand-written CUDA C++.
//
// Replaces tpuray/kernels/trace_pallas.py:_kernel (K1: closest-hit or
// any-hit trace of the camera primaries, common origin),
// trace_pallas.py:_kernel_batched (K3: the same function for incoherent
// rays with per-ray origins: the separate-walk shadow and bounce rays and
// the MIS integrator's walks) and trace_pallas.py:416 _kernel_multi (K2:
// up to three ray classes that share their origins: the bounce ray, the
// env-map shadow ray and the point-light shadow ray of one bounce). The
// forest walk K6 is trace_chunked.cu; the device code all of them share is
// trace_common.cuh.
//
// Design. The TPU kernels walk a 32x128 packet in lock step with one scalar
// stack in SMEM (K3 pops up to 8 nodes a step to hide the TPU's
// vector-to-scalar stalls). Here one thread walks one ray with its own stack
// of kMaxStack int32 in local memory (pack_scene in kernels/trace.py checks
// that no DFS order of the tree can need more), children near-first by the
// ray's own direction sign on the node's split axis. K1 and K3 are one walk
// (trace_common.cuh:walk_subtree) and differ only in where the origin comes
// from.
//
// K2. The TPU walked the three classes as one union walk, because the
// packet's lanes shared each scalar node load. On this card every thread
// has its own stack, and a union walk in one thread serialises three
// unrelated walks: it visits every node any class enters, keeps three
// rays' registers, and orders children by class 0's direction only. So K2
// launches M x N threads, class-major (a warp holds one class's rays),
// and each runs K1's walk from its shared origin with its class's
// direction, t_max and any-hit flag. Each class's result is exactly its
// own single-class trace (K3 on that class alone).
//
// What bounds them on this card: dependent global loads at every node
// visit (the node record, then up to eight triangle records) and warp
// divergence between rays that take different paths (K3's incoherent rays
// most). Not FLOPs, and not device-memory bandwidth: a 20k-triangle scene's
// records are ~1 MB, far inside the 50 MB L2. The records
// (trace_common.cuh) turn each node visit's ~17 dependent 4-byte loads
// from the SoA tables into four 16-byte loads, and a triangle's 12 into 3.
// wgmma and TMA have nothing to do in a pointer-chasing walk. Wider nodes,
// ray sorting or persistent threads are later work.

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
  float t;
  int idx;
  trace_ray<kAnyHit>(tb, r, t_max[i], &t, &idx);
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

template <typename T>
__device__ __forceinline__ T pick(int c, T a, T b, T d) {
  return c == 0 ? a : (c == 1 ? b : d);  // no dynamic index into the params
}

// thread g walks ray g % n of class g / n
__global__ void __launch_bounds__(kBlock)
trace_k2(Tables tb, const float* __restrict__ orig, MultiArgs a, int any_mask,
         int n, int m) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= static_cast<long long>(m) * n) return;
  const int c = static_cast<int>(g / n);
  const size_t i = static_cast<size_t>(g - static_cast<long long>(c) * n);
  const Ray r = make_ray(orig + 3 * i, pick(c, a.dir[0], a.dir[1], a.dir[2]) + 3 * i);
  const float tm = pick(c, a.t_max[0], a.t_max[1], a.t_max[2])[i];
  float t;
  int idx;
  if ((any_mask >> c) & 1)
    trace_ray<true>(tb, r, tm, &t, &idx);
  else
    trace_ray<false>(tb, r, tm, &t, &idx);
  pick(c, a.t_out[0], a.t_out[1], a.t_out[2])[i] = t;
  pick(c, a.idx_out[0], a.idx_out[1], a.idx_out[2])[i] = idx;
}

template <bool kCommonOrigin>
int launch_k1(const Tables& tb, const float* orig, const float* dir,
              const float* t_max, float* t_out, int* idx_out, int n,
              int any_hit, void* stream) {
  if (n <= 0) return 0;
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

// The scene operands of every entry below (kernels/trace.py:TraceTables):
// nodes (R, 16) node records, tris (T, 12) triangle records, root_box (6,),
// root the root's ref.

// K1. orig (1, 3), shared by every ray; dir (n, 3); t_max (n,); outputs
// t_out (n,) f32, idx_out (n,) i32. Returns the cudaError_t of the launch
// (0 = success).
int tpuray_trace_packets(const float* nodes, const float* tris,
                         const float* root_box, int root,
                         const float* orig, const float* dir,
                         const float* t_max, float* t_out, int* idx_out,
                         int n, int any_hit, void* stream) {
  const Tables tb{reinterpret_cast<const float4*>(nodes),
                  reinterpret_cast<const float4*>(tris), root_box, root};
  return launch_k1<true>(tb, orig, dir, t_max, t_out, idx_out, n, any_hit, stream);
}

// K3. As K1 with per-ray origins orig (n, 3).
int tpuray_trace_batched(const float* nodes, const float* tris,
                         const float* root_box, int root,
                         const float* orig, const float* dir,
                         const float* t_max, float* t_out, int* idx_out,
                         int n, int any_hit, void* stream) {
  const Tables tb{reinterpret_cast<const float4*>(nodes),
                  reinterpret_cast<const float4*>(tris), root_box, root};
  return launch_k1<false>(tb, orig, dir, t_max, t_out, idx_out, n, any_hit, stream);
}

// K2. m classes (1..3) from shared per-ray origins orig (n, 3); class c has
// dirs[c] (n, 3), t_maxs[c] (n,) and is any-hit iff bit c of any_mask.
// Unused class slots are NULL.
int tpuray_trace_multi(const float* nodes, const float* tris,
                       const float* root_box, int root,
                       const float* orig,
                       const float* d0, const float* d1, const float* d2,
                       const float* tm0, const float* tm1, const float* tm2,
                       float* t0, float* t1, float* t2,
                       int* i0, int* i1, int* i2,
                       int n, int m, int any_mask, void* stream) {
  if (n <= 0) return 0;
  if (m < 1 || m > 3) return static_cast<int>(cudaErrorInvalidValue);
  const Tables tb{reinterpret_cast<const float4*>(nodes),
                  reinterpret_cast<const float4*>(tris), root_box, root};
  const MultiArgs a{{d0, d1, d2}, {tm0, tm1, tm2}, {t0, t1, t2}, {i0, i1, i2}};
  const long long threads = static_cast<long long>(m) * n;
  const dim3 grid(static_cast<unsigned>((threads + kBlock - 1) / kBlock));
  trace_k2<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(tb, orig, a, any_mask, n, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
