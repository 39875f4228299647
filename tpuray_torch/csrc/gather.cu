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
// Design. The 512-row chunks, the 8192-index blocks and the [min, max]
// chunk skipping answer the MXU and VMEM; a gather needs none of them
// here. Each output element is one thread: the W consecutive threads of a
// row form its group, read idx[n] once between them (one broadcast
// transaction), read the row's W contiguous floats and write W contiguous
// floats, so loads and stores are coalesced for any W. The bf16 split is
// done in registers (__float2bfloat16_rn, round to nearest even as the
// JAX astype), not in two table copies. A grid-stride loop covers N * W.
//
// What bounds it on this card: device-memory bytes (N*W*4 written, N*4 of
// indices and the table read once; the table itself sits in L2). A few
// float ops per element are far below the compute roofline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ float hi_lo(float x) {
  const float hi = __bfloat162float(__float2bfloat16_rn(x));
  const float lo = __bfloat162float(__float2bfloat16_rn(x - hi));
  return hi + lo;
}

__global__ void __launch_bounds__(kBlock)
onehot_gather_k7(const float* __restrict__ table, const int* __restrict__ idx,
                 float* __restrict__ out, int t_rows, int w, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long n = e / w;
    const int c = static_cast<int>(e - n * w);
    const int i = __ldg(idx + n);
    float v = 0.0f;
    if (i >= 0 && i < t_rows) v = hi_lo(__ldg(table + static_cast<long long>(i) * w + c));
    out[e] = v;
  }
}

}  // namespace

// table (T, W) f32, idx (N,) int32, out (N, W) f32, all contiguous on the
// device; launches on `stream` and returns cudaGetLastError().
extern "C" int tpuray_onehot_gather(const float* table, const int* idx, float* out,
                                    int t_rows, int w, long long n, cudaStream_t stream) {
  const long long total = n * w;
  if (total == 0) return 0;
  const long long want = (total + kBlock - 1) / kBlock;
  const int blocks = static_cast<int>(want < (1 << 20) ? want : (1 << 20));
  onehot_gather_k7<<<blocks, kBlock, 0, stream>>>(table, idx, out, t_rows, w, total);
  return static_cast<int>(cudaGetLastError());
}
