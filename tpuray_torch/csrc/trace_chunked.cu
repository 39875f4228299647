// K6: closest-hit or any-hit traversal of a uniform forest of chunk BVHs,
// for the H100 (sm_90a), hand-written CUDA C++.
//
// Replaces tpuray/kernels/trace_chunked.py:66 _kernel with the host loop of
// _trace_chunked_impl around it. The TPU kernel exists because the
// single-tree kernel keeps the whole scene in SMEM (~15-20k triangles):
// one pallas_call per chunk streams that chunk's tables into SMEM and
// sweeps only the ray packets that interval bounds say can enter it, front
// to back by the packets' mean origin. None of that carries over: the card
// reads the records from device memory through its 50 MB L2 (64 bytes a
// node row and 48 a triangle row; chip_smoke.py prints their size), so one
// launch walks the whole forest.
//
// Design. kernels/trace_chunked.py:pack_forest builds a small top-level
// BVH over the chunk roots' boxes (at most MAX_CHUNKS = 256 leaves) on the
// host and appends its inner records after the forest's node records; its
// leaves are the chunk roots' refs. K6 is then K1's walk
// (trace_common.cuh:walk_subtree) from the top-level root: one thread per
// ray, near-first, and the slab limit min(t, t_max) culls whole chunks
// that lie beyond the best hit, as a list of entered chunks sorted by
// entry distance would. Indices in the records are global
// (kernels/trace.py:pack_tables), so a hit's idx is the forest-wide
// triangle row. Padding nodes (inverted boxes that every slab test enters)
// are never reached from a chunk root; padding triangles are all-zero and
// never hit.
//
// What bounds it on this card: as K1, dependent global loads at every node
// visit and warp divergence. The first version of K6 slab-tested every
// chunk root per ray from the SoA rows (16 at 131k triangles, 64 at 524k,
// six scalar loads each) and insertion-sorted the entered ones in a
// 2.5 KB local-memory frame (float entry[256], int chunk[256]). The
// top-level tree replaces both: log2(chunks) levels of 64-byte records that
// every ray's warp reads from L1, and no per-ray list. Staging the chunk
// roots' boxes in shared memory was the alternative; it would keep the
// per-ray test of every root and the sorted list, which the tree removes.
// A fused multi-class forest walk (as K2) is later work.
//
// Exactness: as K1, the triangle test's float ops are the plain version's
// (-fmad=false), so t is bit-equal to integrator/intersect.py's skip-link
// walk over the same forest; idx may differ only on an exact-t tie, which
// the visiting order decides.

#include "trace_common.cuh"

namespace {

using namespace tpuray;

template <bool kAnyHit, bool kCommonOrigin>
__global__ void __launch_bounds__(kBlock)
trace_k6(Tables tb, const float* __restrict__ orig, const float* __restrict__ dir,
         const float* __restrict__ t_max, float* __restrict__ t_out,
         int* __restrict__ idx_out, int n) {
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

template <bool kAnyHit>
void launch(const Tables& tb, const float* orig, const float* dir, const float* t_max,
            float* t_out, int* idx_out, int n, int common_origin, cudaStream_t s) {
  const dim3 grid((n + kBlock - 1) / kBlock);
  if (common_origin)
    trace_k6<kAnyHit, true><<<grid, kBlock, 0, s>>>(tb, orig, dir, t_max, t_out, idx_out, n);
  else
    trace_k6<kAnyHit, false><<<grid, kBlock, 0, s>>>(tb, orig, dir, t_max, t_out, idx_out, n);
}

}  // namespace

extern "C" {

// K6. The forest's records with its top-level tree (nodes (R, 16), tris
// (T, 12), root_box (6,), root = the top-level root's ref; global indices);
// orig (1, 3) when common_origin, else (n, 3); dir (n, 3); t_max (n,);
// outputs t_out (n,) f32, idx_out (n,) i32. Returns the cudaError_t of the
// launch (0 = success).
int tpuray_trace_chunked(const float* nodes, const float* tris, const float* root_box,
                         int root, const float* orig, const float* dir,
                         const float* t_max, float* t_out, int* idx_out, int n,
                         int any_hit, int common_origin, void* stream) {
  if (n <= 0) return 0;
  const Tables tb{reinterpret_cast<const float4*>(nodes),
                  reinterpret_cast<const float4*>(tris), root_box, root};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit)
    launch<true>(tb, orig, dir, t_max, t_out, idx_out, n, common_origin, s);
  else
    launch<false>(tb, orig, dir, t_max, t_out, idx_out, n, common_origin, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
