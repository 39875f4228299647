// K1 and K3: the BVH walks of a single tree's 4-wide records on the H100
// (sm_90a), hand-written CUDA C++. K3 (incoherent rays, one thread a ray)
// comes first below, then K1 (camera primaries, one walk a warp).
//
// K3 replaces tpuray/kernels/trace_pallas.py:67 _kernel_batched (K1's
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

// K1 replaces tpuray/kernels/trace_pallas.py:233 _kernel (batch_k = 0, via
// the pallas_call at :712): the closest-hit or any-hit trace of the camera
// primaries, N rays from one origin. The frame's rays come in 32x32 image
// tiles (render/tiling.py), so a block's 128 consecutive rays are four
// rows of one tile, and each warp takes an 8x4 patch of them (patch_ray):
// its lanes' walks nearly coincide. K1 walks the same wide records as K3,
// one walk a warp:
//
//   - the warp visits one node at a time; its record is loaded once a
//     visit at a warp-uniform address (one broadcast load, not 32);
//   - each lane slab-tests the four children against its own limit
//     min(t, t_max); a child's warp key is the least max(t0, 0) over the
//     lanes that enter it (__reduce_min_sync on the float's bits, which
//     order non-negative floats), +inf when none does;
//   - the children are sorted by their warp keys (K3's five exchanges);
//     leaf children are scanned at once, nearest first, triangle records
//     loaded four at a time at warp-uniform addresses, each lane testing
//     them only where its own slab test of the leaf's box passed (and its
//     key still lies before its best hit) and updating only its own
//     (t, idx); the nearest inner child that a lane still enters is next,
//     the others are pushed far-first with their warp keys;
//   - the stack is one per warp, warp-uniform, kept in registers across
//     the lanes (entry e in lane e % 32, slot e / 32; a pop is a
//     __shfl_sync), WIDE_STACK entries, which wide_tree checks at pack
//     time for any child order: the warp descends the same tree;
//   - a pop skips an entry whose warp key is not below the largest limit
//     of the warp's active lanes: no lane can enter it;
//   - a dead lane (t_max <= 0) and an any-hit lane that has its hit enter
//     no box; the walk ends when no lane is active or nothing is pending.
//
// The warp visits the union of its lanes' paths. A lane that visits a
// node it would not have visited alone adds no hit: the boxes nest, and
// the slab test's subtractions and products are monotonic in a bound, so
// the lane fails the child boxes of a box it failed (its limit only
// shrinks), and it tests triangles only inside a leaf box it entered
// itself. So `t` is bit-equal to the plain version's and `idx` equal but
// for exact-t ties, as in K3. Any order of the rays gives these results;
// only the time depends on it. The union is wide where the lanes' paths
// part: at silhouettes, and for rays from one origin in random directions,
// where this walk takes 3.4x the first K1's time and 4x K3's walk
// (PERF.md section 6); a train step's row-major primaries
// (train/optimize.py:render_flat) give a warp four 8-ray pieces of one
// image row, and K1 takes there what the first K1 took.
//
// What bounds it on this card: as K3, the latency of a warp's chain of
// dependent loads and the instructions its lanes issue, not bytes (the
// records sit in L2). Here a warp's loads are one broadcast each, its
// stack costs no memory, and its lanes never diverge in the walk's
// control flow. Measured against the first K1 on the default view's
// primaries (PERF.md section 6): K3's walk, one thread a ray, 0.77x; this
// walk on 32x1 rows 0.87x (the union of a row's paths is wide); on 8x4
// patches 0.73x, with four triangles a step (96 registers) 0.70x. Tried
// and left out: K3's walk on 8x4 patches (no faster), K3's walk capped at
// 48 registers (spills; slower), 16x2 patches (slower). t_max is a
// per-ray array or, with a null pointer, one float argument (the frame's
// primaries), so the caller copies nothing to the card.

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

// ---------------------------------------------------------------- K1

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kInfBits = 0x7f800000u;  // +inf's bits: no lane enters
constexpr float kNoEntry = -__builtin_huge_valf();  // a limit that no slab test passes

// the warp's order key of one lane's slab key: the bits of max(t0, 0),
// which order as unsigned ints; +inf (not entered) gives kInfBits
__device__ __forceinline__ unsigned order_bits(float key) {
  return __float_as_uint(key > 0.0f ? key : 0.0f);
}

// K3's exchange for warp-uniform keys: the uniform key wk and child ref
// decide, and each lane's own slab key goes along
__device__ __forceinline__ void exchange_warp(unsigned& wa, float& ka, int& ra,
                                              unsigned& wb, float& kb, int& rb) {
  const bool s = wb < wa;
  const unsigned w = s ? wb : wa;
  const float k = s ? kb : ka;
  const int r = s ? rb : ra;
  wb = s ? wa : wb;
  kb = s ? ka : kb;
  rb = s ? ra : rb;
  wa = w;
  ka = k;
  ra = r;
}

// The warp's stack of pending (ref, warp key) entries, in registers across
// the lanes: entry e lives in lane e % 32, slot e / 32. sp is warp-uniform.
struct WarpStack {
  static_assert(kWideStack == 64, "two slots of 32 lanes");
  int ref0, ref1;
  unsigned key0, key1;
  int sp;

  __device__ __forceinline__ void push(int lane, int ref, unsigned key) {
    if (lane == (sp & 31)) {
      if (sp < 32) {
        ref0 = ref;
        key0 = key;
      } else {
        ref1 = ref;
        key1 = key;
      }
    }
    ++sp;
  }

  __device__ __forceinline__ void pop(int* ref, unsigned* key) {
    --sp;
    const bool hi = sp >= 32;
    *ref = __shfl_sync(kFull, hi ? ref1 : ref0, sp & 31);
    *key = __shfl_sync(kFull, hi ? key1 : key0, sp & 31);
  }
};

// scan_pairs for the warp, four triangles a step: leaf `ref`'s triangle
// records loaded at warp-uniform addresses (one broadcast load each), all
// four tests run before any update; a lane tests them where `mine` and
// updates its own (t, idx) in scan_leaf's order with its strict
// comparisons (an any-hit lane stops at its first hit). Every lane runs
// the loop; the warp leaves it early only in an any-hit walk whose lanes
// all have their hit.
template <bool kAnyHit>
__device__ __forceinline__ void scan_warp(const Tables& tb, int ref, const Ray& r,
                                          float tm, bool mine, float* t, int* idx) {
  const int first = (~ref) >> 4;
  const int count = (~ref) & 15;
  for (int j = 0; j < count; j += 4) {
    if (kAnyHit && !__any_sync(kFull, mine)) return;
    Tri q[4];
    float th[4];
    bool h[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) q[m] = load_tri(tb, first + (j + m < count ? j + m : j));
#pragma unroll
    for (int m = 0; m < 4; ++m) h[m] = tri_test(q[m], r, &th[m]) && j + m < count && mine;
    bool got = false;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (h[m] && !(kAnyHit && got) && th[m] < *t && th[m] < tm) {
        *t = th[m];
        *idx = first + j + m;
        got = true;
      }
    }
    if (kAnyHit) mine = mine && *idx < 0;
  }
}

// One warp's walk of the wide tree from its root, whose box the lanes
// with `live` set have entered. Every lane of the warp calls it, and the
// control flow stays warp-uniform throughout.
template <bool kAnyHit>
__device__ __forceinline__ void walk_warp(const Tables& tb, const Ray& r, float tm,
                                          bool live, int lane, float* t, int* idx) {
  // a lane's slab limit: min(t, t_max) while it is active, else one that
  // no box passes
  auto limit = [&]() {
    return live && !(kAnyHit && *idx >= 0) ? fminf(*t, tm) : kNoEntry;
  };
  if (tb.root < 0) {
    scan_warp<kAnyHit>(tb, tb.root, r, tm, live, t, idx);
    return;
  }
  WarpStack st{0, 0, 0u, 0u, 0};
  int node = tb.root;
  while (true) {
    const float4* rec = tb.nodes + 8 * static_cast<size_t>(node);
    const float4 lx = __ldg(rec);
    const float4 hx = __ldg(rec + 1);
    const float4 ly = __ldg(rec + 2);
    const float4 hy = __ldg(rec + 3);
    const float4 lz = __ldg(rec + 4);
    const float4 hz = __ldg(rec + 5);
    const int4 ref = __ldg(reinterpret_cast<const int4*>(rec + 6));
    const float lim = limit();
    float key[4] = {entry(lx.x, hx.x, ly.x, hy.x, lz.x, hz.x, r, lim),
                    entry(lx.y, hx.y, ly.y, hy.y, lz.y, hz.y, r, lim),
                    entry(lx.z, hx.z, ly.z, hy.z, lz.z, hz.z, r, lim),
                    entry(lx.w, hx.w, ly.w, hy.w, lz.w, hz.w, r, lim)};
    int child[4] = {ref.x, ref.y, ref.z, ref.w};
    unsigned wk[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) wk[k] = __reduce_min_sync(kFull, order_bits(key[k]));
    exchange_warp(wk[0], key[0], child[0], wk[1], key[1], child[1]);
    exchange_warp(wk[2], key[2], child[2], wk[3], key[3], child[3]);
    exchange_warp(wk[0], key[0], child[0], wk[2], key[2], child[2]);
    exchange_warp(wk[1], key[1], child[1], wk[3], key[3], child[3]);
    exchange_warp(wk[1], key[1], child[1], wk[2], key[2], child[2]);
    // leaf children, nearest first, by the lanes that entered them and
    // still have them before their best hit
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (child[k] < 0 && wk[k] != kInfBits) {
        const bool mine = key[k] < limit();
        if (__any_sync(kFull, mine)) scan_warp<kAnyHit>(tb, child[k], r, tm, mine, t, idx);
      }
    }
    if (kAnyHit && !__any_sync(kFull, limit() != kNoEntry)) return;
    // inner children: the nearest that a lane still enters is next, the
    // others pushed far-first
    const float lim2 = limit();
    int next = -1;
    unsigned next_key = 0;
#pragma unroll
    for (int k = 3; k >= 0; --k) {
      if (child[k] >= 0 && wk[k] != kInfBits && __any_sync(kFull, key[k] < lim2)) {
        if (next >= 0) st.push(lane, next, next_key);
        next = child[k];
        next_key = wk[k];
      }
    }
    if (next < 0) {
      // the largest limit of an active lane, as bits (limits are > 0); 0
      // when no lane is active
      const unsigned lim_max =
          __reduce_max_sync(kFull, lim2 != kNoEntry ? __float_as_uint(lim2) : 0u);
      while (st.sp > 0) {
        int ref_p;
        unsigned key_p;
        st.pop(&ref_p, &key_p);
        if (key_p < lim_max) {
          next = ref_p;
          break;
        }
      }
      if (next < 0) return;
    }
    node = next;
  }
}

// The ray that thread tid of a block walks. A block takes kBlock = 128
// consecutive rays, four 32-ray rows of a 32x32 tile in the frame's tile
// order (render/tiling.py), and warp w takes columns 8w..8w+7 of the four
// rows: an 8x4 patch of pixels, whose paths part less than a 32x1 row's.
// Any order of rays gives the same results; only the time depends on it.
__device__ __forceinline__ int patch_ray(int tid) {
  static_assert(kBlock == 128, "four 32-ray rows a block");
  return (tid & 31) / 8 * 32 + (tid >> 5) * 8 + (tid & 7);
}

// Whole warps walk: a lane whose ray lies past n walks as a dead lane.
template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
trace_k1_warp(Tables tb, const float* __restrict__ orig, const float* __restrict__ dir,
              const float* __restrict__ t_max, float t_max_all, float* __restrict__ t_out,
              int* __restrict__ idx_out, int n) {
  const int i = blockIdx.x * blockDim.x + patch_ray(threadIdx.x);
  const bool in = i < n;
  const Ray r = make_ray(orig, dir + 3 * static_cast<size_t>(in ? i : 0));
  const float tm = !in ? 0.0f : (t_max != nullptr ? t_max[i] : t_max_all);
  const float* b = tb.root_box;
  const bool live = tm > 0.0f && slab(__ldg(b), __ldg(b + 3), __ldg(b + 1), __ldg(b + 4),
                                      __ldg(b + 2), __ldg(b + 5), r, tm);
  float t = kInf;
  int idx = -1;
  if (__any_sync(kFull, live))
    walk_warp<kAnyHit>(tb, r, tm, live, threadIdx.x & 31, &t, &idx);
  if (in) {
    t_out[i] = t;
    idx_out[i] = idx;
  }
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

// K1. The scene operands as K3's; one origin orig (1, 3) shared by every
// ray, dir (n, 3); t_max (n,) (<= 0: a dead lane), or NULL and t_max_all
// for every ray; outputs t_out (n,) f32, idx_out (n,) i32, (1e30, -1) on a
// miss. Returns the cudaError_t of the launch (0 = success).
int tpuray_trace_packets(const float* wide, const float* tris,
                         const float* root_box, int root,
                         const float* orig, const float* dir,
                         const float* t_max, float t_max_all, float* t_out,
                         int* idx_out, int n, int any_hit, void* stream) {
  if (n <= 0) return 0;
  const Tables tb{reinterpret_cast<const float4*>(wide),
                  reinterpret_cast<const float4*>(tris), root_box, root};
  const dim3 grid((n + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit)
    trace_k1_warp<true><<<grid, kBlock, 0, s>>>(tb, orig, dir, t_max, t_max_all, t_out,
                                                idx_out, n);
  else
    trace_k1_warp<false><<<grid, kBlock, 0, s>>>(tb, orig, dir, t_max, t_max_all, t_out,
                                                 idx_out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
