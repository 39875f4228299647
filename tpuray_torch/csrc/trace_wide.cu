// K3: the BVH walk for incoherent rays on the H100 (sm_90a), hand-written
// CUDA C++.
//
// Replaces tpuray/kernels/trace_pallas.py:67 _kernel_batched (K1's
// closest-hit or any-hit trace for rays with per-ray origins: the
// separate-walk shadow and bounce rays and the MIS integrator's walks,
// five a frame). The TPU kernel walks a 32x128 packet in lock step and
// pops up to 8 nodes a step to hide its vector-to-scalar stalls; here one
// thread walks one ray.
//
// What bounds it on this card: the latency of the slowest rays. A walk's
// time is set by its longest chains of dependent loads, not by its bytes
// or FLOPs: the records of a 20k-triangle scene (~0.2 MB of wide nodes,
// ~1 MB of triangles) sit in the 50 MB L2, a launch whose lanes are all
// dead takes ~6 us, and one with only 8 live lanes ~28 us
// (tpuray_torch/traversal_times.py --parts k3split). A ray that grazes a
// surface visits many nodes and leaves one after another, and each step
// waits for its loads before it knows the next.
//
// Design: a 4-wide BVH (kernels/trace.py:wide_tree collapses the same
// binary tree on the host), so a ray makes about half as many visits, and
// a visit issues all of its loads at once:
//
//   wide record, 128 bytes, seven 16-byte loads (the eighth is padding):
//     [0] min.x  [1] max.x  [2] min.y  [3] max.y  [4] min.z  [5] max.z
//         of children 0..3 (f32, the binary tree's own boxes, exact);
//     [6] the four child refs (i32): >= 0 a wide record's row, < 0 a leaf
//         ~(first_tri << 4 | tri_count) as in the binary records.
//   An unused slot's box is +inf on every bound, which no slab test enters
//   (the product of +inf and a nonzero inverse is never NaN).
//
// Per visit, the four slab tests give each entered child its entry
// distance t0; a five-exchange sorting network orders the children by it.
// Leaf children are scanned at once, nearest first, each only while its t0
// is still below the best hit, two triangles at a time (both records
// loaded together, so a leaf costs half as many waits); the nearest inner
// child becomes the next node without touching the stack, and the others
// are pushed far-first with their t0. A pop skips an entry whose t0 is no
// longer below the best hit: a child's box lies inside its parent's, and
// the slab test's subtractions and products are monotonic in a bound, so a
// child's t0 is never below its parent's and the skipped subtree could not
// have passed a slab test. The stack holds at most WIDE_STACK
// (kernels/trace.py) entries, checked at pack time for any child order.
//
// Tried on the card and left out (PERF.md section 6): L1 prefetches of the
// entered children (slower than none), loading the next node's record
// while the leaves are scanned (84 registers; slower), four triangles at a
// time (86 registers; slower on the bounce-0 walks), and warps that refill
// idle lanes from a share of the rays (fewer warps in flight; 1.5-4x
// slower). Sorting the rays was not tried: the sort would count in the
// walk's time.
//
// Exactness: tri_test and slab are trace_common.cuh's, op for op, built
// with -fmad=false; every box tested is a box of the binary tree (the
// boxes of the binary nodes that the collapse skips contain the boxes
// tested below them, so testing fewer of them never drops a hit); the
// paired scan updates the best hit in scan_leaf's order. So `t` is
// bit-equal to the plain version's, and `idx` equal but for exact-t ties,
// which the visiting order decides.

#include "trace_common.cuh"

namespace {

using namespace tpuray;

constexpr int kWideStack = 64;  // kernels/trace.py:WIDE_STACK, checked at pack time

// the slab test of one child, as a sort key: its t0 if entered, else +inf
__device__ __forceinline__ float entry(float lox, float hix, float loy, float hiy,
                                       float loz, float hiz, const Ray& r, float limit) {
  float t0;
  return slab_t0(lox, hix, loy, hiy, loz, hiz, r, limit, &t0) ? t0 : __int_as_float(0x7f800000);
}

__device__ __forceinline__ void exchange(float& ka, int& ra, float& kb, int& rb) {
  const bool s = kb < ka;
  const float k = s ? kb : ka;
  const int r = s ? rb : ra;
  kb = s ? ka : kb;
  rb = s ? ra : rb;
  ka = k;
  ra = r;
}

// scan_leaf (trace_common.cuh) two triangles at a time: both records are
// loaded, and both tests run, before either updates (*t, *idx), in the
// same order and with the same strict comparisons, so the result is
// scan_leaf's; a ray waits for half as many loads.
template <bool kAnyHit>
__device__ __forceinline__ void scan_pairs(const Tables& tb, int ref, const Ray& r,
                                           float tm, float* t, int* idx) {
  const int first = (~ref) >> 4;
  const int count = (~ref) & 15;
  for (int j = 0; j < count; j += 2) {
    const int ta = first + j;
    const bool has_b = j + 1 < count;
    const Tri a = load_tri(tb, ta);
    const Tri b = load_tri(tb, has_b ? ta + 1 : ta);
    float tha, thb;
    const bool ha = tri_test(a, r, &tha);
    const bool hb = tri_test(b, r, &thb) && has_b;
    if (ha && tha < *t && tha < tm) {
      *t = tha;
      *idx = ta;
      if (kAnyHit) return;
    }
    if (hb && thb < *t && thb < tm) {
      *t = thb;
      *idx = ta + 1;
      if (kAnyHit) return;
    }
  }
}

// Closest-hit (or any-hit) walk of the wide tree from its root, whose box
// the caller has entered.
template <bool kAnyHit>
__device__ __forceinline__ void walk_wide(const Tables& tb, const Ray& r, float tm,
                                          float* t, int* idx) {
  int node = tb.root;
  if (node < 0) {
    scan_pairs<kAnyHit>(tb, node, r, tm, t, idx);
    return;
  }
  int stack_ref[kWideStack];
  float stack_t0[kWideStack];
  int sp = 0;
  while (true) {
    const float4* rec = tb.nodes + 8 * static_cast<size_t>(node);
    const float4 lx = __ldg(rec);
    const float4 hx = __ldg(rec + 1);
    const float4 ly = __ldg(rec + 2);
    const float4 hy = __ldg(rec + 3);
    const float4 lz = __ldg(rec + 4);
    const float4 hz = __ldg(rec + 5);
    const int4 ref = __ldg(reinterpret_cast<const int4*>(rec + 6));
    const float limit = fminf(*t, tm);
    float key[4] = {entry(lx.x, hx.x, ly.x, hy.x, lz.x, hz.x, r, limit),
                    entry(lx.y, hx.y, ly.y, hy.y, lz.y, hz.y, r, limit),
                    entry(lx.z, hx.z, ly.z, hy.z, lz.z, hz.z, r, limit),
                    entry(lx.w, hx.w, ly.w, hy.w, lz.w, hz.w, r, limit)};
    int child[4] = {ref.x, ref.y, ref.z, ref.w};
    exchange(key[0], child[0], key[1], child[1]);
    exchange(key[2], child[2], key[3], child[3]);
    exchange(key[0], child[0], key[2], child[2]);
    exchange(key[1], child[1], key[3], child[3]);
    exchange(key[1], child[1], key[2], child[2]);
    // leaf children, nearest first, while they still lie before the best hit
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (child[k] < 0 && key[k] < fminf(*t, tm)) {
        scan_pairs<kAnyHit>(tb, child[k], r, tm, t, idx);
        if (kAnyHit && *idx >= 0) return;
      }
    }
    // inner children: the nearest is next, the others pushed far-first
    int next = -1;
    float next_t0 = 0.0f;
#pragma unroll
    for (int k = 3; k >= 0; --k) {
      if (child[k] >= 0 && key[k] < fminf(*t, tm)) {
        if (next >= 0) {
          stack_ref[sp] = next;
          stack_t0[sp] = next_t0;
          ++sp;
        }
        next = child[k];
        next_t0 = key[k];
      }
    }
    while (next < 0 && sp > 0) {
      --sp;
      if (stack_t0[sp] < fminf(*t, tm)) next = stack_ref[sp];
    }
    if (next < 0) return;
    node = next;
  }
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
trace_k3(Tables tb, const float* __restrict__ orig, const float* __restrict__ dir,
         const float* __restrict__ t_max, float* __restrict__ t_out,
         int* __restrict__ idx_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = make_ray(orig + 3 * static_cast<size_t>(i), dir + 3 * static_cast<size_t>(i));
  const float tm = t_max[i];
  float t = kInf;
  int idx = -1;
  const float* b = tb.root_box;
  if (tm > 0.0f && slab(__ldg(b), __ldg(b + 3), __ldg(b + 1), __ldg(b + 4), __ldg(b + 2),
                        __ldg(b + 5), r, tm))
    walk_wide<kAnyHit>(tb, r, tm, &t, &idx);
  t_out[i] = t;
  idx_out[i] = idx;
}

}  // namespace

extern "C" {

// K3. wide (R4, 32) wide records, tris (T, 12) triangle records, root_box
// (6,) the root's box, root the wide root's ref (kernels/trace.py:
// TraceTables.wide, .tris, .root_box, .wide_root); per-ray origins orig
// (n, 3), dir (n, 3), t_max (n,) (<= 0: a dead lane); outputs t_out (n,)
// f32, idx_out (n,) i32, (1e30, -1) on a miss. Returns the cudaError_t of
// the launch (0 = success).
int tpuray_trace_batched(const float* wide, const float* tris,
                         const float* root_box, int root,
                         const float* orig, const float* dir,
                         const float* t_max, float* t_out, int* idx_out,
                         int n, int any_hit, void* stream) {
  if (n <= 0) return 0;
  const Tables tb{reinterpret_cast<const float4*>(wide),
                  reinterpret_cast<const float4*>(tris), root_box, root};
  const dim3 grid((n + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit)
    trace_k3<true><<<grid, kBlock, 0, s>>>(tb, orig, dir, t_max, t_out, idx_out, n);
  else
    trace_k3<false><<<grid, kBlock, 0, s>>>(tb, orig, dir, t_max, t_out, idx_out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
