// K6: closest-hit or any-hit traversal of a uniform forest of chunk BVHs,
// for the H100 (sm_90a), hand-written CUDA C++.
//
// Replaces tpuray/kernels/trace_chunked.py:_kernel with the host loop of
// _trace_chunked_impl around it. The TPU kernel exists because the
// single-tree kernel keeps the whole scene in SMEM (~15-20k triangles):
// one pallas_call per chunk streams that chunk's tables into SMEM and
// sweeps only the ray packets that interval bounds say can enter it, front
// to back by the packets' mean origin. None of that carries over: the card
// reads the tables from device memory through L2 (~8 MB at 131k
// triangles, ~33 MB at 524k, against a 50 MB L2), so one launch walks the
// whole forest.
//
// Design. One thread per ray, as K1 (trace.cu). The thread slab-tests each
// chunk root (node c * chunk_nodes), keeps the entered chunks in a local
// list sorted by entry distance, and walks them in that order with K1's
// near-first DFS (trace_common.cuh:walk_subtree) from the chunk's root. A
// chunk whose entry distance is not below the best hit so far is skipped,
// and so is every chunk after it; an any-hit ray stops at its first hit.
// Indices in the tables are global (kernels/trace.py:pack_tables), so a
// hit's idx is the forest-wide triangle row. Padding nodes (inverted boxes
// that every slab test enters) are never reached from a chunk root; padding
// triangles are all-zero and never hit.
//
// What bounds it on this card: as K1, dependent global loads at every node
// visit and warp divergence, plus the chunk-root tests every ray pays (16
// at 131k triangles, 64 at 524k). A fused multi-class forest walk (as K2)
// and a warp-coherent chunk order are later work.
//
// Exactness: as K1, the triangle test's float ops are the plain version's
// (-fmad=false), so t is bit-equal to integrator/intersect.py's skip-link
// walk over the same forest; idx may differ only on an exact-t tie, which
// the visiting order decides.

#include "trace_common.cuh"

namespace {

using namespace tpuray;

constexpr int kMaxChunks = 256;  // kernels/trace_chunked.py:MAX_CHUNKS

template <bool kAnyHit, bool kCommonOrigin>
__global__ void __launch_bounds__(kBlock)
trace_k6(Tables tb, int chunk_nodes, int n_chunks,
         const float* __restrict__ orig, const float* __restrict__ dir,
         const float* __restrict__ t_max, float* __restrict__ t_out,
         int* __restrict__ idx_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = make_ray(kCommonOrigin ? orig : orig + 3 * static_cast<size_t>(i),
                         dir + 3 * static_cast<size_t>(i));
  const float tm = t_max[i];
  float t = kInf;
  int idx = -1;
  if (tm > 0.0f) {  // a dead lane (t_max <= 0) enters no chunk
    // entered chunk roots, insertion-sorted by entry distance (stable in
    // chunk order on equal distances)
    float entry[kMaxChunks];
    int chunk[kMaxChunks];
    int k = 0;
    for (int c = 0; c < n_chunks; ++c) {
      float t0;
      if (!slab_t0(box_diff(tb, c * chunk_nodes, r.ox, r.oy, r.oz), r.ix, r.iy,
                   r.iz, tm, &t0))
        continue;
      int j = k++;
      while (j > 0 && entry[j - 1] > t0) {
        entry[j] = entry[j - 1];
        chunk[j] = chunk[j - 1];
        --j;
      }
      entry[j] = t0;
      chunk[j] = c;
    }
    for (int j = 0; j < k; ++j) {
      if (entry[j] >= fminf(t, tm)) break;  // this chunk and the rest lie beyond
      walk_subtree<kAnyHit>(tb, chunk[j] * chunk_nodes, r, tm, &t, &idx);
      if (kAnyHit && idx >= 0) break;
    }
  }
  t_out[i] = t;
  idx_out[i] = idx;
}

template <bool kAnyHit>
void launch(const Tables& tb, int chunk_nodes, int n_chunks, const float* orig,
            const float* dir, const float* t_max, float* t_out, int* idx_out,
            int n, int common_origin, cudaStream_t s) {
  const dim3 grid((n + kBlock - 1) / kBlock);
  if (common_origin)
    trace_k6<kAnyHit, true><<<grid, kBlock, 0, s>>>(
        tb, chunk_nodes, n_chunks, orig, dir, t_max, t_out, idx_out, n);
  else
    trace_k6<kAnyHit, false><<<grid, kBlock, 0, s>>>(
        tb, chunk_nodes, n_chunks, orig, dir, t_max, t_out, idx_out, n);
}

}  // namespace

extern "C" {

// K6. Tables of n_chunks chunks of chunk_nodes nodes each (meta (5,
// n_nodes), aabb (6, n_nodes), tverts (12, n_tris), global indices);
// orig (1, 3) when common_origin, else (n, 3); dir (n, 3); t_max (n,);
// outputs t_out (n,) f32, idx_out (n,) i32. Returns the cudaError_t of the
// launch (0 = success).
int tpuray_trace_chunked(const int* meta, const float* aabb,
                         const float* tverts, int n_nodes, int n_tris,
                         int chunk_nodes, int n_chunks, const float* orig,
                         const float* dir, const float* t_max, float* t_out,
                         int* idx_out, int n, int any_hit, int common_origin,
                         void* stream) {
  if (n <= 0) return 0;
  if (n_chunks < 1 || n_chunks > kMaxChunks || chunk_nodes < 1 ||
      static_cast<long long>(n_chunks) * chunk_nodes != n_nodes)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tables tb{meta, aabb, tverts, n_nodes, n_tris};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit)
    launch<true>(tb, chunk_nodes, n_chunks, orig, dir, t_max, t_out, idx_out, n,
                 common_origin, s);
  else
    launch<false>(tb, chunk_nodes, n_chunks, orig, dir, t_max, t_out, idx_out, n,
                  common_origin, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
