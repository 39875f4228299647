// K7: the one-hot hi/lo gather for the H100 (sm_90a), hand-written CUDA C++.
//
// Replaces tpuray/kernels/gather_pallas.py:_kernel (entered through
// onehot_gather). The TPU kernel gathers table rows as one-hot matmuls on
// the MXU with the table split into an exact bf16 pair, hi = bf16(x) and
// lo = bf16(x - hi), and f32 accumulation, so each gathered value is
// f32(hi) + f32(lo) rounded once in f32: table[idx] to ~2^-17 relative,
// not bit for bit. This kernel computes that same function: out[n, c] =
// f32(hi) + f32(lo) of table[idx[n], c] for 0 <= idx[n] < T, and 0 for
// every other index (the JAX kernel returns zeros for its zero padding rows
// [T, ceil512(T)) and for the negative indices its chunk slice wraps into
// them, such as the miss sentinel -1; other indices outside [0, T) read
// wrapped or out-of-table rows there, which the port does not copy).
//
// What bounds it on this card: device-memory bytes. The output, N * W * 4
// bytes, is written once and never read here; the indices are read once;
// the table (T rows of W floats, ~2 MB for the triangle table) stays in
// the L2 while its rows are read again and again. A few float ops per
// value are far below the compute roofline.
//
// Design. The 512-row chunks, the 8192-index blocks and the [min, max]
// chunk skipping answer the MXU and VMEM; a gather needs none of them
// here. A warp copies 32 rows: each lane loads one of the 32 indices (one
// coalesced 128-byte load), and __shfl_sync hands a row's index to the
// lanes that copy it. The warp's 32 output rows are one contiguous run of
// 32 * W floats, which the lanes write in vectors of V = 4, 2 or 1 floats
// (the widest that the row stride W * 4 bytes and the pointers' alignment
// allow), each vector's values read from the same place in its table row,
// with streaming stores (__stcs: the output is written once, so it should
// not push the table out of the L2). A row outside [0, T) loads nothing
// and writes zeros. The widths the port gathers at are compile-time
// instances, W = 26 (the triangle table, V = 2), 18 (the material table,
// V = 2) and 44 (V = 4), so the division of a vector's position by the
// row's W / V vectors is a multiply and a shift; one run-time-W instance
// with V = 1 takes any other width. All index arithmetic is 32-bit; only
// the pointer offsets widen to 64 bits. The bf16 split is done in
// registers (__float2bfloat16_rn, round to nearest even as the JAX astype).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;  // 8 warps, 256 rows a block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float hi_lo(float x) {
  const float hi = __bfloat162float(__float2bfloat16_rn(x));
  const float lo = __bfloat162float(__float2bfloat16_rn(x - hi));
  return hi + lo;
}

template <int V> struct Vec;
template <> struct Vec<1> {
  using T = float;
  __device__ static T hi_lo_of(T x) { return hi_lo(x); }
};
template <> struct Vec<2> {
  using T = float2;
  __device__ static T hi_lo_of(T x) { return make_float2(hi_lo(x.x), hi_lo(x.y)); }
};
template <> struct Vec<4> {
  using T = float4;
  __device__ static T hi_lo_of(T x) {
    return make_float4(hi_lo(x.x), hi_lo(x.y), hi_lo(x.z), hi_lo(x.w));
  }
};

// kW > 0: rows of kW floats; kW == 0: rows of w_rt floats (V must be 1).
template <int kW, int V>
__global__ void __launch_bounds__(kBlock)
gather_rows(const float* __restrict__ table, const int* __restrict__ idx,
            float* __restrict__ out, int t_rows, int w_rt, int n) {
  using T = typename Vec<V>::T;
  const int w = kW > 0 ? kW : w_rt;
  const int vw = w / V;  // vectors a row
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kBlock + (threadIdx.x & ~31);
  if (row0 >= n) return;  // whole warps leave together
  const int rows = min(32, n - row0);
  const int mine = lane < rows ? __ldg(idx + row0 + lane) : -1;
  const T* src = reinterpret_cast<const T*>(table);
  T* dst = reinterpret_cast<T*>(out + static_cast<size_t>(row0) * w);
  const int total = rows * vw;
#pragma unroll 4
  for (int base = 0; base < total; base += 32) {
    const int e = base + lane;
    const int r = e / vw;
    const int i = __shfl_sync(kFull, mine, min(r, 31));  // every lane takes part
    if (e < total) {
      T v = {};
      if (i >= 0 && i < t_rows)
        v = Vec<V>::hi_lo_of(__ldg(src + static_cast<size_t>(i) * vw + (e - r * vw)));
      __stcs(dst + e, v);
    }
  }
}

template <int kW, int V>
void launch(const float* table, const int* idx, float* out, int t_rows, int w, int n,
            cudaStream_t stream) {
  const int blocks = (n + kBlock - 1) / kBlock;
  gather_rows<kW, V><<<blocks, kBlock, 0, stream>>>(table, idx, out, t_rows, w, n);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// table (T, W) f32, idx (N,) int32, out (N, W) f32, all contiguous on the
// device, N < 2^31; launches on `stream` and returns cudaGetLastError().
extern "C" int tpuray_onehot_gather(const float* table, const int* idx, float* out,
                                    int t_rows, int w, int n, cudaStream_t stream) {
  if (n <= 0 || w <= 0) return 0;
  const bool v4 = aligned(table, 16) && aligned(out, 16);
  const bool v2 = aligned(table, 8) && aligned(out, 8);
  if (w == 26 && v2)
    launch<26, 2>(table, idx, out, t_rows, w, n, stream);
  else if (w == 18 && v2)
    launch<18, 2>(table, idx, out, t_rows, w, n, stream);
  else if (w == 44 && v4)
    launch<44, 4>(table, idx, out, t_rows, w, n, stream);
  else
    launch<0, 1>(table, idx, out, t_rows, w, n, stream);
  return static_cast<int>(cudaGetLastError());
}
