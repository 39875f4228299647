// TAA: temporal anti-aliasing as one kernel for the H100 (sm_90a),
// hand-written CUDA C++.
//
// Replaces no TPU kernel: the JAX package computes TAA with XLA ops
// (tpuray/denoise/taa.py), and the port did with ~550 PyTorch ops a call
// (tpuray_torch/denoise/taa.py:taa): nine rounds of shift2d, tonemap and
// YCoCg-R for the neighbourhood, each op a kernel and a host launch. It was
// added because those ops were the largest block of the frame's host issue
// and, at 1080p, of its device time.
//
// Semantics. The kernel computes denoise/taa.py:taa under the exact history
// read, op for op and in the same order: the 3x3 closest-depth velocity
// (the first strict minimum in dy-major order, best z from +inf), the
// clamped history uv and bilinear_fetch_clamped's clamps, tonemap then
// YCoCg-R of the pixel and of the history, the 3x3 m1 / m2 sums in dy-major
// order, mu and sigma, clip_aabb, untonemap, the velocity-scaled blend, and
// the passthrough of sky (linear_z == 1) and of frame 0. Neighbour reads
// clamp to the array's own edges, as shift2d does. Two template arguments
// pick the instance: the static camera (velocity 0, the history the same
// pixel) and the row window (row0, global_h) of a halo-extended row shard
// (dist/frame.py): uv takes image rows, the history taps are read at image
// row - row0 and a pixel whose taps leave the rows in memory rejects its
// history (blend 1), as the plain version's in_shard does.
//
// What bounds it on this card: device-memory bytes. It reads the current
// colour, the history (4 taps, mostly from L1/L2), velocity and depth once
// and writes one colour: 48 bytes a pixel, 30.7 MB at 800x800 (0.009 ms at
// 3.35 TB/s), 99.5 MB at 1920x1080 (0.030 ms). Its ~150 float operations a
// pixel are far under the byte bound.
//
// Design: one launch, one thread a pixel, 32 x 8 pixels a block (K4's
// tile, csrc/reproject.cu). A block whose pixels are all sky (or frame 0)
// writes its passthrough and ends (__syncthreads_or). Otherwise it stages
// its tile and a 1-pixel halo, 34 x 10 points, in shared memory: linear_z,
// velocity and the current colour already tonemapped and in YCoCg-R, each
// point the pixel at its clamped coordinate. So each neighbour's transform
// is computed once, not nine times, with the same instructions and so the
// same bits. The 4 history taps read device memory directly; the output is
// written once.
//
// Exactness. Built with -fmad=false, IEEE division and sqrt and no fast
// math, every operation repeats the plain version's op as PyTorch computes
// it on the card. PyTorch divides a CUDA tensor by a Python number as a
// product with the number's float reciprocal (div_true_kernel_cuda), so
// m1 / 9.0, m2 / 9.0, (x + 0.5) / w and (y + 0.5) / global_h are products
// with 1.f / 9.f, 1.f / w and 1.f / global_h, rounded on the host as PyTorch
// rounds them. max/min propagate NaN as torch.clamp and torch.amax do
// (denoise_common.cuh).

#include "denoise_common.cuh"

namespace {

using denoise::clampi;
using denoise::maxp;
using denoise::minp;

constexpr int BW = 32, BH = 8;  // pixels a block
constexpr int SW = BW + 2, SH = BH + 2;
constexpr int TILE = SW * SH;  // 340 points

struct Params {
  int h, w;      // the rows and columns in memory
  int row0, gh;  // local row 0 is image row row0 of gh (the row window)
  int first;     // frame 0: every pixel passes through
  float inv_w, inv_gh, inv_9;  // 1.f / w, 1.f / gh, 1.f / 9.f
};

struct Inputs {
  const float* __restrict__ cur;   // (H, W, 3)
  const float* __restrict__ prev;  // (H, W, 3)
  const float* __restrict__ vel;   // (H, W, 2)
  const float* __restrict__ z;     // (H, W)
};

// the Python floats of taa.py as PyTorch casts them to float32
constexpr float kQuarter = 0.25f, kHalf = 0.5f;
constexpr float kEps6 = static_cast<float>(1e-6), kEps12 = static_cast<float>(1e-12);
constexpr float kBlend0 = static_cast<float>(0.05), kSpeed = 100.f;

__device__ __forceinline__ float taa_lum(const float* c) {
  return (kQuarter * c[0] + kHalf * c[1]) + kQuarter * c[2];
}

// rgb_to_ycocgr(taa_tonemap(c))
__device__ __forceinline__ void to_ycc(const float* c, float* o) {
  const float d = 1.f + taa_lum(c);
  const float t0 = c[0] / d, t1 = c[1] / d, t2 = c[2] / d;
  const float co = t0 - t2;
  const float tmp = t2 + co * kHalf;
  const float cg = t1 - tmp;
  o[0] = tmp + cg * kHalf;
  o[1] = co;
  o[2] = cg;
}

// taa_untonemap(ycocgr_to_rgb(c))
__device__ __forceinline__ void to_rgb(const float* c, float* o) {
  const float tmp = c[0] - c[2] * kHalf;
  const float g = c[2] + tmp;
  const float b = tmp - c[1] * kHalf;
  const float rgb[3] = {b + c[1], g, b};
  const float d = maxp(1.f - taa_lum(rgb), kEps6);
#pragma unroll
  for (int k = 0; k < 3; ++k) o[k] = rgb[k] / d;
}

template <bool kStatic, bool kWin>
__global__ void __launch_bounds__(BW * BH) taa_kernel(Inputs in, float* __restrict__ out,
                                                      Params p) {
  __shared__ float4 s_c[TILE];  // YCoCg-R of the tonemapped colour, linear_z
  __shared__ float2 s_v[kStatic ? 1 : TILE];  // velocity

  const int w = p.w, h = p.h;
  const int bx0 = blockIdx.x * BW, by0 = blockIdx.y * BH;
  const int x = bx0 + threadIdx.x, y = by0 + threadIdx.y;
  const bool in_img = x < w && y < h;
  const int i = y * w + x;
  const bool needs = in_img && !p.first && !(in.z[i] == 1.f);
  if (!__syncthreads_or(needs)) {  // sky or frame 0: the current colour
    if (in_img) {
#pragma unroll
      for (int c = 0; c < 3; ++c) out[3 * i + c] = in.cur[3 * i + c];
    }
    return;
  }
  for (int k = threadIdx.y * BW + threadIdx.x; k < TILE; k += BW * BH) {
    const int gx = clampi(bx0 + k % SW - 1, 0, w - 1);
    const int gy = clampi(by0 + k / SW - 1, 0, h - 1);
    const int j = gy * w + gx;
    const float c[3] = {in.cur[3 * j], in.cur[3 * j + 1], in.cur[3 * j + 2]};
    float ycc[3];
    to_ycc(c, ycc);
    s_c[k] = make_float4(ycc[0], ycc[1], ycc[2], in.z[j]);
    if (!kStatic) s_v[k] = make_float2(in.vel[2 * j], in.vel[2 * j + 1]);
  }
  __syncthreads();
  if (!in_img) return;
  if (!needs) {
#pragma unroll
    for (int c = 0; c < 3; ++c) out[3 * i + c] = in.cur[3 * i + c];
    return;
  }
  const int c0 = (threadIdx.y + 1) * SW + threadIdx.x + 1;  // own tile point

  // closest_velocity, then the history fetch
  float vx = 0.f, vy = 0.f, prev[3];
  bool hist_ok = true;
  if constexpr (kStatic) {
#pragma unroll
    for (int c = 0; c < 3; ++c) prev[c] = in.prev[3 * i + c];
  } else {
    float best_z = INFINITY;
    float2 best = s_v[c0];
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int e = c0 + dy * SW + dx;
        const float zn = s_c[e].w;
        if (zn < best_z) {
          best_z = zn;
          best = s_v[e];
        }
      }
    }
    vx = best.x;
    vy = best.y;
    const int row0 = kWin ? p.row0 : 0, gh = kWin ? p.gh : h;
    const float u = minp(maxp((static_cast<float>(x) + 0.5f) * p.inv_w - vx, 0.f), 1.f);
    const float v = minp(maxp((static_cast<float>(y + row0) + 0.5f) * p.inv_gh - vy, 0.f), 1.f);
    // bilinear_fetch_clamped
    const float xf = u * static_cast<float>(w) - 0.5f;
    const float yf = v * static_cast<float>(gh) - 0.5f;
    const float x0f = floorf(xf), y0f = floorf(yf);
    const float fx = xf - x0f, fy = yf - y0f;
    const int x0 = clampi(static_cast<int>(x0f), 0, w - 1);
    int y0 = clampi(static_cast<int>(y0f), 0, gh - 1);
    const int x1 = min(x0 + 1, w - 1);
    int y1 = min(y0 + 1, gh - 1);
    if (kWin) {
      y0 -= row0;
      y1 -= row0;
      hist_ok = y0 >= 0 && y1 < h;
      y0 = clampi(y0, 0, h - 1);
      y1 = clampi(y1, 0, h - 1);
    }
    const float* c00 = in.prev + 3 * (y0 * w + x0);
    const float* c10 = in.prev + 3 * (y0 * w + x1);
    const float* c01 = in.prev + 3 * (y1 * w + x0);
    const float* c11 = in.prev + 3 * (y1 * w + x1);
    const float gx = 1.f - fx, gy = 1.f - fy;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      prev[c] = (c00[c] * gx + c10[c] * fx) * gy + (c01[c] * gx + c11[c] * fx) * fy;
  }

  const float4 own = s_c[c0];
  const float now_ycc[3] = {own.x, own.y, own.z};
  float prev_ycc[3];
  to_ycc(prev, prev_ycc);

  // the neighbourhood's moments
  float m1[3] = {0.f, 0.f, 0.f}, m2[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const float4 n = s_c[c0 + dy * SW + dx];
      const float cn[3] = {n.x, n.y, n.z};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        m1[c] = m1[c] + cn[c];
        m2[c] = m2[c] + cn[c] * cn[c];
      }
    }
  }

  // clip_aabb (gamma 1: gamma * sigma is sigma)
  float p_clip[3], v_clip[3], ma = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float mu = m1[c] * p.inv_9;
    const float sigma = sqrtf(fabsf(m2[c] * p.inv_9 - mu * mu));
    const float lo = mu - sigma, hi = mu + sigma;
    p_clip[c] = kHalf * (hi + lo);
    const float e_clip = kHalf * (hi - lo);
    v_clip[c] = prev_ycc[c] - p_clip[c];
    const float v_unit = v_clip[c] / (fabsf(e_clip) < kEps12 ? kEps12 : e_clip);
    ma = c == 0 ? fabsf(v_unit) : maxp(ma, fabsf(v_unit));
  }
  if (ma > 1.f) {
    const float d = maxp(ma, kEps12);
#pragma unroll
    for (int c = 0; c < 3; ++c) prev_ycc[c] = p_clip[c] + v_clip[c] / d;
  }

  float now_rgb[3], prev_rgb[3];
  to_rgb(now_ycc, now_rgb);
  to_rgb(prev_ycc, prev_rgb);
  const float speed = sqrtf(vx * vx + vy * vy);
  float blend = minp(maxp(kBlend0 + speed * kSpeed, 0.f), 1.f);
  if (kWin && !hist_ok) blend = 1.f;  // no history: the current colour
  const float keep = 1.f - blend;
#pragma unroll
  for (int c = 0; c < 3; ++c) out[3 * i + c] = blend * now_rgb[c] + keep * prev_rgb[c];
}

}  // namespace

extern "C" int tpuray_taa(const float* cur, const float* prev, const float* vel,
                          const float* linear_z, float* out, int h, int w, int row0,
                          int global_h, int first, int static_camera, cudaStream_t stream) {
  if (h < 1 || w < 1 || global_h < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Inputs in{cur, prev, vel, linear_z};
  // the reciprocals as PyTorch takes them: float(1.0) / float(divisor)
  const Params p{h, w, row0, global_h, first,
                 1.f / static_cast<float>(w), 1.f / static_cast<float>(global_h), 1.f / 9.f};
  const bool win = row0 != 0 || global_h != h;
  const dim3 block(BW, BH);
  const dim3 grid((w + BW - 1) / BW, (h + BH - 1) / BH);
  // the static camera reads no velocity and no other row: no window instance
  decltype(&taa_kernel<false, false>) kernel = &taa_kernel<false, false>;
  if (static_camera)
    kernel = &taa_kernel<true, false>;
  else if (win)
    kernel = &taa_kernel<false, true>;
  kernel<<<grid, block, 0, stream>>>(in, out, p);
  return static_cast<int>(cudaGetLastError());
}
