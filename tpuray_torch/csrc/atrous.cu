// K5: one SVGF edge-aware a-trous wavelet iteration for the H100 (sm_90a),
// hand-written CUDA C++.
//
// Replaces tpuray/kernels/atrous_pallas.py:_kernel (driven by atrous_chain,
// one launch per iteration with step 1 << i): the 3x3 variance pre-blur
// (clamp to edge, no mask; the identity under reference_quirks), the
// depth/normal/luminance edge-stopping weights, the B3-spline 5x5 dilated
// stencil, the variance filtered with squared weights and divided by
// sum_w^2, and sky passthrough. Its plain version is
// tpuray_torch/denoise/atrous.py:atrous_iteration.
//
// Design. One thread per pixel; the 24 dilated taps and the 9 pre-blur taps
// are read straight from device memory through L1/L2. The chain
// (kernels/atrous.py) packs the static G-buffer once per frame, as float4
// (nx, ny, nz, linear_z) plus fwidth_z, and the dynamic state as float4
// (r, g, b, variance), so a tap is two 16-byte loads; iterations ping-pong
// between two buffers, and the history-tap iteration writes a buffer of its
// own that stays alive as next frame's history.
// What bounds it on this card: per iteration 9 floats read and 4 written
// per pixel (the neighbours' re-reads hit L1/L2), and ~1.1k flops per
// pixel (24 weights, each with seven squarings, an exp and two divisions):
// bytes and operations take about the same time. This first version uses
// no shared memory; a shared-memory tile per step is later work.
//
// Exactness. Built with -fmad=false, IEEE division and sqrt and no fast
// math, the op order repeats the plain version's, so outputs equal it up to
// expf's last bits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

struct Params {
  int h, w, step;
  float sigma_n;
  int n_sq;  // sigma_n == 2^n_sq: repeated squaring; -1: powf
  float sigma_l;
  int quirks;
};

// max / min that return a NaN first operand, as torch.clamp_min/_max do
__device__ __forceinline__ float maxp(float a, float b) { return (a != a || a > b) ? a : b; }
__device__ __forceinline__ float minp(float a, float b) { return (a != a || a < b) ? a : b; }
__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

__device__ __forceinline__ float lum(float r, float g, float b) {
  return 0.2125f * r + 0.7154f * g + 0.0721f * b;
}

__device__ __forceinline__ float pow_weight(float x, const Params& p) {
  x = minp(maxp(x, 0.f), 1.f);
  if (p.n_sq < 0) return powf(x, p.sigma_n);
  for (int i = 0; i < p.n_sq; ++i) x = x * x;
  return x;
}

// B3-spline 1D weights by |offset| (svgf_Atrous.frag:66), in double as the
// plain version forms their products before rounding to float
__device__ __forceinline__ double k1d(int a) {
  return a == 0 ? 1.0 : (a == 1 ? 2.0 / 3.0 : 1.0 / 6.0);
}

__global__ void __launch_bounds__(256) atrous_step(const float4* __restrict__ dyn,
                                                   const float4* __restrict__ stat,
                                                   const float* __restrict__ fwidth_z,
                                                   float4* __restrict__ out, Params p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= p.w || y >= p.h) return;
  const int w = p.w, h = p.h;
  const int i = y * w + x;
  const float4 c = dyn[i];
  const float4 s = stat[i];  // nx, ny, nz, linear_z
  if (s.w == 1.f) {          // sky passthrough (svgf_Atrous.frag:77-82)
    out[i] = c;
    return;
  }
  const float l_c = lum(c.x, c.y, c.z);

  // 3x3 variance pre-blur, clamp to edge (svgf_Atrous.frag:24-36)
  float var_blur = c.w;
  if (!p.quirks) {
    var_blur = 0.f;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const float k = (dx == 0 ? 2.f : 1.f) * (dy == 0 ? 2.f : 1.f) * 0.0625f;
        const int j = clampi(y + dy, 0, h - 1) * w + clampi(x + dx, 0, w - 1);
        var_blur = var_blur + k * dyn[j].w;
      }
    }
  }
  const float phi_l = maxp(p.sigma_l * sqrtf(maxp(1e-10f + var_blur, 1e-10f)), 1e-10f);
  const float phi_depth = maxp(fwidth_z[i], 1e-8f) * static_cast<float>(p.step);

  float sum_w = 1.f, sr = c.x, sg = c.y, sb = c.z, sv = c.w;  // centre: weight 1
#pragma unroll
  for (int yy = -2; yy <= 2; ++yy) {
#pragma unroll
    for (int xx = -2; xx <= 2; ++xx) {
      if (xx == 0 && yy == 0) continue;
      const int dy = yy * p.step, dx = xx * p.step;
      const bool inside = y + dy >= 0 && y + dy < h && x + dx >= 0 && x + dx < w;
      const int j = clampi(y + dy, 0, h - 1) * w + clampi(x + dx, 0, w - 1);
      const float4 q = dyn[j];
      const float4 t = stat[j];
      const float kernel = static_cast<float>(k1d(xx < 0 ? -xx : xx) * k1d(yy < 0 ? -yy : yy));
      const float dist = static_cast<float>(sqrt(static_cast<double>(xx * xx + yy * yy)));
      // computeWeight (svgf_Atrous.frag:43-55)
      const float w_normal = pow_weight(s.x * t.x + s.y * t.y + s.z * t.z, p);
      const float phi_d = phi_depth * dist;
      const float w_z = (phi_d == 0.f) ? 0.f : fabsf(s.w - t.w) / phi_d;
      const float w_l = fabsf(l_c - lum(q.x, q.y, q.z)) / phi_l;
      float wgt = expf(-maxp(w_l, 0.f) - maxp(w_z, 0.f)) * w_normal;
      wgt = inside ? wgt * kernel : 0.f;
      sum_w = sum_w + wgt;
      sr = sr + wgt * q.x;
      sg = sg + wgt * q.y;
      sb = sb + wgt * q.z;
      sv = sv + wgt * wgt * q.w;
    }
  }
  out[i] = make_float4(sr / sum_w, sg / sum_w, sb / sum_w, sv / (sum_w * sum_w));
}

}  // namespace

extern "C" int tpuray_atrous_step(const void* dyn, const void* stat, const float* fwidth_z,
                                  void* out, int h, int w, int step, float sigma_n, int n_sq,
                                  float sigma_l, int quirks, cudaStream_t stream) {
  const Params p{h, w, step, sigma_n, n_sq, sigma_l, quirks};
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  atrous_step<<<grid, block, 0, stream>>>(static_cast<const float4*>(dyn),
                                          static_cast<const float4*>(stat), fwidth_z,
                                          static_cast<float4*>(out), p);
  return static_cast<int>(cudaGetLastError());
}
