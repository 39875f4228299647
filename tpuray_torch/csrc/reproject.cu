// K4: SVGF temporal reprojection + spatial variance fallback for the H100
// (sm_90a), hand-written CUDA C++.
//
// Replaces tpuray/kernels/reproject_pallas.py:_kernel (reproject_variance_
// fused): demodulate, reproject by the motion vectors (4 bilinear history
// taps with depth and normal validity, then a 3x3 rescue), the EMA with
// alpha_min and history_cap, then the 7x7 cross-bilateral variance fallback
// where the history is shorter than 4 frames.
//
// Semantics. The TPU kernel computes the tile-windowed ("tiled") history
// read, the TPU's answer to slow gathers. This kernel computes the JAX
// package's exact path instead, reproject(reproject_gather="exact") plus
// estimate_variance (tpuray_torch/denoise/reproject.py and variance.py,
// its plain versions), including the clamps of the quad-packed history
// fetch: bilinear taps come from the 2x2 quad at the clamped base, whose
// neighbours clamp at the last row/column, with validity on the unclamped
// position; rescue taps come from 4 quads with bases clamped to
// [0, dim - 2], so an edge tap can count twice at the border.
//
// Design. One thread per pixel, two launches:
//  (a) reproject: reads the 17 current and 11 history floats the exact path
//      reads, gathers the 4 bilinear taps (and the 16 rescue taps, only
//      where the bilinear taps fail) straight from the history planes in
//      device memory through L1/L2, and writes rep_illum, rep_variance,
//      moments and history_len;
//  (b) variance: where history_len < 4 and not sky, the 7x7 filter over
//      pass (a)'s outputs and the G-buffer; elsewhere a copy of rep_*.
// What bounds it on this card: device-memory bytes, 28 floats read and 11
// written per pixel (the history gather of (a) and the 7x7 window of (b)
// mostly hit L1/L2). The fallback's 49 taps are ~2k flops where it runs.
// This first version keeps the (H, W, C) layouts of the public function
// and uses no shared memory; a single pass with a +-3 halo tile in shared
// memory is later work.
//
// Exactness. Built with -fmad=false, IEEE division and sqrt and no fast
// math, every operation repeats the plain version's op order, so the
// outputs equal the plain PyTorch version's up to expf/powf's last bits;
// history_len and the validity decisions are exact. jnp.round is half to
// even (rintf); max/min propagate NaN like torch.clamp_min.

#include <cuda_runtime.h>
#include <math.h>

namespace {

struct Params {
  int h, w;
  float depth_thr, normal_thr, history_cap, alpha_min;
  float sigma_n;
  int n_sq;  // sigma_n == 2^n_sq: repeated squaring; -1: powf
  float sigma_l;
  int quirks;
};

struct Inputs {
  const float* __restrict__ color;          // (H, W, 3)
  const float* __restrict__ emission;       // (H, W, 3)
  const float* __restrict__ albedo;         // (H, W, 3)
  const float* __restrict__ motion;         // (H, W, 2)
  const float* __restrict__ normal;         // (H, W, 3)
  const float* __restrict__ linear_z;       // (H, W)
  const float* __restrict__ fwidth_normal;  // (H, W)
  const float* __restrict__ fwidth_z;       // (H, W)
  const float* __restrict__ prev_illum;     // (H, W, 3)
  const float* __restrict__ prev_variance;  // (H, W)
  const float* __restrict__ prev_normal;    // (H, W, 3)
  const float* __restrict__ prev_linear_z;  // (H, W)
  const float* __restrict__ prev_moments;   // (H, W, 2)
  const float* __restrict__ prev_hist;      // (H, W)
};

struct Outputs {
  float* __restrict__ rep_illum;     // (H, W, 3)
  float* __restrict__ rep_variance;  // (H, W)
  float* __restrict__ moments;       // (H, W, 2)
  float* __restrict__ history_len;   // (H, W)
  float* __restrict__ var_illum;     // (H, W, 3)
  float* __restrict__ var_variance;  // (H, W)
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

// computeWeight (svgf_variance.frag:23-35); phi_l is already floored
__device__ __forceinline__ float edge_weight(float z_c, float z_p, float phi_d,
                                             const float* n_c, const float* n_p,
                                             const Params& p, float l_c, float l_p,
                                             float phi_l) {
  float w_normal = pow_weight(n_c[0] * n_p[0] + n_c[1] * n_p[1] + n_c[2] * n_p[2], p);
  float w_z = (phi_d == 0.f) ? 0.f : fabsf(z_c - z_p) / phi_d;
  float w_l = fabsf(l_c - l_p) / phi_l;
  return expf(-maxp(w_l, 0.f) - maxp(w_z, 0.f)) * w_normal;
}

struct HistRow {
  float iv[4];  // illum rgb, variance
  float n[3];
  float z;
  float m[2];
  float hl;
};

__device__ __forceinline__ HistRow fetch(const Inputs& in, int y, int x, int w) {
  const int j = y * w + x;
  HistRow r;
  r.iv[0] = in.prev_illum[3 * j];
  r.iv[1] = in.prev_illum[3 * j + 1];
  r.iv[2] = in.prev_illum[3 * j + 2];
  r.iv[3] = in.prev_variance[j];
  r.n[0] = in.prev_normal[3 * j];
  r.n[1] = in.prev_normal[3 * j + 1];
  r.n[2] = in.prev_normal[3 * j + 2];
  r.z = in.prev_linear_z[j];
  r.m[0] = in.prev_moments[2 * j];
  r.m[1] = in.prev_moments[2 * j + 1];
  r.hl = in.prev_hist[j];
  return r;
}

// isReprjValid (svgf_reproject.frag:31-43)
__device__ __forceinline__ bool tap_valid(int yi, int xi, const Params& p, float z,
                                          float fw_z, const float* n, float fw_n,
                                          const HistRow& t) {
  const bool in_b = xi >= 0 && xi < p.w && yi >= 0 && yi < p.h;
  const bool depth_ok = (fabsf(t.z - z) / (fw_z + 1e-2f)) <= p.depth_thr;
  const float d0 = n[0] - t.n[0], d1 = n[1] - t.n[1], d2 = n[2] - t.n[2];
  const float nd = sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
  const bool normal_ok = (nd / (fw_n + 1e-2f)) <= p.normal_thr;
  return in_b && depth_ok && normal_ok;
}

// quad tap k = (dx, dy) = (k & 1, k >> 1): (0,0) (1,0) (0,1) (1,1);
// rescue quad b has its base at (dy, dx) = (-1,-1) (-1,1) (1,-1) (1,1)
__device__ __forceinline__ int qdx(int k) { return k & 1; }
__device__ __forceinline__ int qdy(int k) { return k >> 1; }
__device__ __forceinline__ int bdx(int b) { return (b & 1) * 2 - 1; }
__device__ __forceinline__ int bdy(int b) { return (b >> 1) * 2 - 1; }

__global__ void __launch_bounds__(256) reproject_pass(Inputs in, Outputs out, Params p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= p.w || y >= p.h) return;
  const int i = y * p.w + x;
  const int w = p.w, h = p.h;

  const float z = in.linear_z[i];
  const bool sky = z == 1.f;
  const float fw_z = in.fwidth_z[i], fw_n = in.fwidth_normal[i];
  const float n[3] = {in.normal[3 * i], in.normal[3 * i + 1], in.normal[3 * i + 2]};

  // demodulate (svgf_reproject.frag:26-29, 174)
  float il[3], col[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    col[c] = in.color[3 * i + c];
    const float v = (col[c] - in.emission[3 * i + c]) / maxp(in.albedo[3 * i + c], 1e-3f);
    il[c] = (v != v) ? 0.f : v;
  }

  // back-projected pixel position
  const float wf = static_cast<float>(w), hf = static_cast<float>(h);
  const float uv_x = (static_cast<float>(x) + 0.5f) / wf - in.motion[2 * i];
  const float uv_y = (static_cast<float>(y) + 0.5f) / hf - in.motion[2 * i + 1];
  const float fx = uv_x * wf - 0.5f;
  const float fy = uv_y * hf - 0.5f;
  const float x0f = floorf(fx), y0f = floorf(fy);
  float frac_x, frac_y;
  if (p.quirks) {
    // jnp.remainder: fmod, then + d where the remainder is negative; d is
    // 1/w in double rounded to float, as the plain version's scalar is
    const float dx = static_cast<float>(1.0 / w), dy = static_cast<float>(1.0 / h);
    frac_x = fmodf(uv_x, dx);
    frac_y = fmodf(uv_y, dy);
    if (frac_x < 0.f) frac_x = frac_x + dx;
    if (frac_y < 0.f) frac_y = frac_y + dy;
  } else {
    frac_x = fx - x0f;
    frac_y = fy - y0f;
  }
  const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);

  // the 4 bilinear taps: one quad at the clamped base
  const int yc = clampi(y0, 0, h - 1), xc = clampi(x0, 0, w - 1);
  const float wts[4] = {(1.f - frac_x) * (1.f - frac_y), frac_x * (1.f - frac_y),
                        (1.f - frac_x) * frac_y, frac_x * frac_y};
  HistRow taps[4];
  float sum_w = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f}, acc_m[2] = {0.f, 0.f};
  bool any_valid = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    taps[k] = fetch(in, min(yc + qdy(k), h - 1), min(xc + qdx(k), w - 1), w);
    const bool v = tap_valid(y0 + qdy(k), x0 + qdx(k), p, z, fw_z, n, fw_n, taps[k]);
    any_valid = any_valid || v;
    const float wv = v ? wts[k] : 0.f;
    sum_w = sum_w + wv;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = acc[c] + wv * taps[k].iv[c];
    acc_m[0] = acc_m[0] + wv * taps[k].m[0];
    acc_m[1] = acc_m[1] + wv * taps[k].m[1];
  }
  const bool bilinear_ok = any_valid && (sum_w >= 0.01f);
  const float safe_w = maxp(sum_w, 1e-6f);
  float prev_i[4], prev_m[2];
#pragma unroll
  for (int c = 0; c < 4; ++c) prev_i[c] = bilinear_ok ? acc[c] / safe_w : 0.f;
  prev_m[0] = bilinear_ok ? acc_m[0] / safe_w : 0.f;
  prev_m[1] = bilinear_ok ? acc_m[1] / safe_w : 0.f;

  // 3x3 rescue (svgf_reproject.frag:111-141): 4 quads, bases clamped to
  // [0, dim - 2]; only read where the bilinear taps failed
  bool rescue_ok = false;
  if (!bilinear_ok) {
    float n_valid = 0.f, r[4] = {0.f, 0.f, 0.f, 0.f}, r_m[2] = {0.f, 0.f};
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int yb = clampi(y0 + bdy(b), 0, h - 2);
      const int xb = clampi(x0 + bdx(b), 0, w - 2);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ty = yb + qdy(q), tx = xb + qdx(q);
        bool in_window = abs(ty - y0) <= 1 && abs(tx - x0) <= 1;
        // only the first quad owns taps with ty <= y0 and tx <= x0
        if (b != 0) in_window = in_window && !(ty <= y0 && tx <= x0);
        const HistRow t = fetch(in, ty, tx, w);
        const bool v = in_window && tap_valid(ty, tx, p, z, fw_z, n, fw_n, t);
        const float vf = v ? 1.f : 0.f;
        n_valid = n_valid + vf;
#pragma unroll
        for (int c = 0; c < 4; ++c) r[c] = r[c] + vf * t.iv[c];
        r_m[0] = r_m[0] + vf * t.m[0];
        r_m[1] = r_m[1] + vf * t.m[1];
      }
    }
    rescue_ok = n_valid > 0.f;
    if (rescue_ok) {
      const float safe_n = maxp(n_valid, 1.f);
#pragma unroll
      for (int c = 0; c < 4; ++c) prev_i[c] = r[c] / safe_n;
      prev_m[0] = r_m[0] / safe_n;
      prev_m[1] = r_m[1] / safe_n;
    }
  }
  const bool success = bilinear_ok || rescue_ok;

  // history length at round(f): one of the 4 bilinear corners
  const bool near_x = clampi(static_cast<int>(rintf(fx)), 0, w - 1) > xc;
  const bool near_y = clampi(static_cast<int>(rintf(fy)), 0, h - 1) > yc;
  const float hist_prev = near_y ? (near_x ? taps[3].hl : taps[2].hl)
                                 : (near_x ? taps[1].hl : taps[0].hl);
  // EMA + history-length tail (svgf_reproject.frag:143-205)
  float hist = minp(success ? hist_prev + 1.f : 1.f, p.history_cap);
  const float alpha = success ? maxp(1.f / hist, p.alpha_min) : 1.f;
  const float l = lum(il[0], il[1], il[2]);
  const float mom_new[2] = {l, l * l};
  float mom[2];
  mom[0] = (1.f - alpha) * prev_m[0] + alpha * mom_new[0];
  mom[1] = (1.f - alpha) * prev_m[1] + alpha * mom_new[1];
  float variance = maxp(mom[1] - mom[0] * mom[0], 0.f);
  float o[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) o[c] = (1.f - alpha) * prev_i[c] + alpha * il[c];

  // sky passthrough (frag:166-171): raw colour, the prior moments
  if (sky) {
#pragma unroll
    for (int c = 0; c < 3; ++c) o[c] = col[c];
    variance = 0.f;
    mom[0] = in.prev_moments[2 * i];
    mom[1] = in.prev_moments[2 * i + 1];
    hist = in.prev_hist[i];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) out.rep_illum[3 * i + c] = o[c];
  out.rep_variance[i] = variance;
  out.moments[2 * i] = mom[0];
  out.moments[2 * i + 1] = mom[1];
  out.history_len[i] = hist;
}

// estimate_variance (svgf_variance.frag) on pass (a)'s outputs
__global__ void __launch_bounds__(256) variance_pass(Inputs in, Outputs out, Params p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= p.w || y >= p.h) return;
  const int i = y * p.w + x;
  const int w = p.w, h = p.h;
  const float hl = out.history_len[i];
  const float z = in.linear_z[i];
  if (!(hl < 4.f && !(z == 1.f))) {
#pragma unroll
    for (int c = 0; c < 3; ++c) out.var_illum[3 * i + c] = out.rep_illum[3 * i + c];
    out.var_variance[i] = out.rep_variance[i];
    return;
  }
  const float n_c[3] = {in.normal[3 * i], in.normal[3 * i + 1], in.normal[3 * i + 2]};
  const float l_c = lum(out.rep_illum[3 * i], out.rep_illum[3 * i + 1], out.rep_illum[3 * i + 2]);
  const float phi_depth = maxp(in.fwidth_z[i], 1e-8f) * 3.0f;
  const float phi_l = maxp(p.sigma_l, 1e-10f);

  float sum_w = 0.f, s_il[3] = {0.f, 0.f, 0.f}, s_m[2] = {0.f, 0.f};
#pragma unroll
  for (int dy = -3; dy <= 3; ++dy) {
#pragma unroll
    for (int dx = -3; dx <= 3; ++dx) {
      const bool inside = y + dy >= 0 && y + dy < h && x + dx >= 0 && x + dx < w;
      const int j = clampi(y + dy, 0, h - 1) * w + clampi(x + dx, 0, w - 1);
      const float il_p[3] = {out.rep_illum[3 * j], out.rep_illum[3 * j + 1],
                             out.rep_illum[3 * j + 2]};
      const float n_p[3] = {in.normal[3 * j], in.normal[3 * j + 1], in.normal[3 * j + 2]};
      const float dist = static_cast<float>(sqrt(static_cast<double>(dx * dx + dy * dy)));
      float wgt = edge_weight(z, in.linear_z[j], phi_depth * dist, n_c, n_p, p, l_c,
                              lum(il_p[0], il_p[1], il_p[2]), phi_l);
      wgt = inside ? wgt : 0.f;
      sum_w = sum_w + wgt;
#pragma unroll
      for (int c = 0; c < 3; ++c) s_il[c] = s_il[c] + wgt * il_p[c];
      s_m[0] = s_m[0] + wgt * out.moments[2 * j];
      s_m[1] = s_m[1] + wgt * out.moments[2 * j + 1];
    }
  }
  sum_w = maxp(sum_w, 1e-6f);
#pragma unroll
  for (int c = 0; c < 3; ++c) out.var_illum[3 * i + c] = s_il[c] / sum_w;
  const float m0 = s_m[0] / sum_w, m1 = s_m[1] / sum_w;
  out.var_variance[i] = (m1 - m0 * m0) * (4.f / maxp(hl, 1e-3f));
}

}  // namespace

extern "C" int tpuray_reproject_variance(
    const float* color, const float* emission, const float* albedo, const float* motion,
    const float* normal, const float* linear_z, const float* fwidth_normal,
    const float* fwidth_z, const float* prev_illum, const float* prev_variance,
    const float* prev_normal, const float* prev_linear_z, const float* prev_moments,
    const float* prev_history_len, float* rep_illum, float* rep_variance, float* moments,
    float* history_len, float* var_illum, float* var_variance, int h, int w,
    float depth_thr, float normal_thr, float history_cap, float alpha_min, float sigma_n,
    int n_sq, float sigma_l, int quirks, cudaStream_t stream) {
  const Inputs in{color, emission, albedo, motion, normal, linear_z, fwidth_normal,
                  fwidth_z, prev_illum, prev_variance, prev_normal, prev_linear_z,
                  prev_moments, prev_history_len};
  const Outputs out{rep_illum, rep_variance, moments, history_len, var_illum, var_variance};
  const Params p{h, w, depth_thr, normal_thr, history_cap, alpha_min, sigma_n, n_sq,
                 sigma_l, quirks};
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  reproject_pass<<<grid, block, 0, stream>>>(in, out, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  variance_pass<<<grid, block, 0, stream>>>(in, out, p);
  return static_cast<int>(cudaGetLastError());
}
