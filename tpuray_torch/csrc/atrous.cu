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
// What bounds it on this card: instruction issue. Per iteration a pixel
// reads 9 floats and writes 4 (~33 MB at 800x800, ~10 us of HBM, and the
// state sits in the 50 MB L2), but its 24 taps cost ~1k float operations
// (a 3-term dot, seven squarings, an exp, the luminance and depth terms,
// five accumulations each): ~5 us of the card's float32 peak, and several
// times that in issued instructions (address arithmetic, clamps, selects,
// IEEE divisions). The first version read every tap from L1/L2
// through clamped addresses, divided twice a tap and took 0.0875 ms an
// iteration.
//
// Design.
//  * One block per 32 pixels in x by 8 lattice rows of one class of
//    y mod step. In x the block covers CX classes of x mod step side by
//    side (CX = 1, 2, 4, 8, 8 for steps 1 to 16: the largest power of two
//    dividing the step, at most 8) and 32 / CX lattice columns of each, so
//    its pixels come in runs of CX consecutive pixels. On that lattice the
//    dilated 5x5 stencil is a dense 5x5 around each pixel's own point. At
//    steps 1 to 8 the block's columns are dense: 32 consecutive pixels.
//  * Staging: the tile holds, for each of the CX classes, (32 / CX + 4) x
//    12 lattice points (the block's points and a halo of 2), each the texel
//    at its clamped image coordinate (clamp to edge, as the plain version's
//    shift2d), read once from the (H, W, 3) + (H, W) layouts the chain is
//    given: illum rgb + variance and normal + linear_z as two float4s and
//    the luminance of illum, 36 bytes a point. Consecutive points are
//    consecutive pixels, so the reads come in runs of at least CX pixels.
//    Tile (y x x x classes): 12 x 36 x 1 / 12 x 20 x 2 / 12 x 12 x 4 /
//    12 x 8 x 8 points for CX = 1 / 2 / 4 / 8, i.e. 432 / 480 / 576 / 768
//    points, 1.69 to 3 a pixel; 13,824 / 15,360 / 18,432 / 24,576 bytes
//    read from L2 / HBM a block (32 a point) into 15,552 / 17,280 /
//    20,736 / 27,648 bytes of static shared memory (no
//    cudaFuncSetAttribute); 56 registers, no stack (ptxas). (A first
//    version took one class per block at every step: at steps 8 and 16
//    its lanes read pixels a step apart, a 32-byte sector per 4-byte value,
//    and those steps cost 1.9-2.6x step 1 at 1920x1080; now each step
//    takes about the same, ~0.03 ms at 800x800 on the H100, PERF.md.)
//  * The 24 taps read the tile at constant offsets from the thread's own
//    point, with no address arithmetic; a tap outside the image is masked
//    with the same select as before. The 3x3 pre-blur reads the tile at
//    step 1 and the variance plane (L1/L2, runs of CX pixels) at larger
//    steps, where the pixel's neighbours belong to other classes.
//  * Per-pixel constants are hoisted: 1 / phi_l, and 1 / (phi_depth * d)
//    for the five tap distances d. Sky pixels still return after staging.
//  * The chain writes each iteration's output in the (H, W, 3) + (H, W)
//    layout, so the wrapper packs and unpacks nothing; the output of the
//    history-tap iteration is a buffer of its own (next frame's history).
//
// Row window. A rank of a row-sharded frame (tpuray_torch/dist/frame.py)
// passes its rows extended by 2 * step + 1 a side: local row y is image row
// row0 + y of an image global_h rows tall. Only the taps' inside bits take
// image rows (the entry point turns the window into local bounds, [-row0,
// global_h - row0)); the staging and the pre-blur clamp to the rows in
// memory, as the plain version's shift2d, and the classes of y mod step
// stay local (the taps sit at fixed offsets from the pixel). The window
// is a template argument: without it (row0 0, global_h h) the kernel is the
// whole-image one (bounds [0, h), 56 registers; the bounds from parameters
// took 58, ptxas).
//
// Exactness. Built with -fmad=false, IEEE sqrt and no fast math, the op
// order is the plain version's but for two changes: w_z = |dz| * (1 /
// phi_d) and w_l = |dl| * (1 / phi_l), a multiplication by a reciprocal
// taken once per pixel where the plain version divides per tap (up to
// 1.5 ulp in the exp's argument; the outputs stay within rtol 1e-5 / atol
// 1e-6 of the plain version). Identities, not reorderings: the clamps of
// w_l and w_z at 0 are dropped (both are >= +0 or NaN), and so is the
// phi_d == 0 select (phi_d >= 1e-8 * step or NaN). The kernel weights and
// distances are float constants (each the float of the plain version's
// double), so no FP64 instruction is left.

#include "denoise_common.cuh"

namespace {

using denoise::clampi;
using denoise::lum;
using denoise::maxp;

constexpr int TW = 32, TH = 8;  // pixels a block: 32 in x, 8 lattice rows in y
constexpr int R = 2;            // stencil radius in lattice points

// classes of x mod step a block covers, side by side: the largest power of
// two that divides the step, at most 8 (1, 2, 4, 8, 8 for steps 1 to 16)
inline int classes_x(int step) {
  return step % 8 == 0 ? 8 : step % 4 == 0 ? 4 : step % 2 == 0 ? 2 : 1;
}

struct Params {
  int h, w, step;
  int y_lo, y_hi;  // the image's rows as local rows: [-row0, global_h - row0)
  float sigma_n;
  int n_sq;  // sigma_n == 2^n_sq: repeated squaring; -1: powf
  float sigma_l;
  int quirks;
};

// B3-spline weights k(|xx|) * k(|yy|) (svgf_Atrous.frag:66) and tap
// distances sqrt(xx^2 + yy^2), each the float of the plain version's double
__device__ __forceinline__ float b3(int a, int b) {
  const int lo = a < b ? a : b, hi = a < b ? b : a;
  return lo == 0 ? (hi == 0 ? 0x1p+0f : hi == 1 ? 0x1.555556p-1f : 0x1.555556p-3f)
       : lo == 1 ? (hi == 1 ? 0x1.c71c72p-2f : 0x1.c71c72p-4f)
                 : 0x1.c71c72p-6f;
}
// index of a tap's distance in {1, sqrt2, 2, sqrt5, sqrt8}
__device__ __forceinline__ int dist_index(int ax, int ay) {
  const int d2 = ax * ax + ay * ay;
  return d2 == 1 ? 0 : (d2 == 2 ? 1 : (d2 == 4 ? 2 : (d2 == 5 ? 3 : 4)));
}

template <int kSq, int CX, bool kWin>
__global__ void __launch_bounds__(TW * TH) atrous_step(
    const float* __restrict__ illum, const float* __restrict__ variance,
    const float* __restrict__ normal, const float* __restrict__ linear_z,
    const float* __restrict__ fwidth_z, float* __restrict__ out_illum,
    float* __restrict__ out_variance, Params p) {
  constexpr int LX = TW / CX;                      // lattice columns a block
  constexpr int SX = LX + 2 * R, SY = TH + 2 * R;  // tile points a class, x and y
  constexpr int TILE = SX * SY * CX;               // 432, 480, 576, 768 for CX 1 to 8
  __shared__ float4 s_iv[TILE];  // illum rgb, variance
  __shared__ float4 s_nz[TILE];  // normal, linear_z
  __shared__ float s_l[TILE];    // luminance of illum

  const int s = p.step, w = p.w, h = p.h;
  const int groups = s / CX;     // blocks side by side in x per lattice column block
  const int rx0 = static_cast<int>(blockIdx.x % groups) * CX;  // first x class
  const int ry = blockIdx.y % s;                                // the y class
  const int li0 = static_cast<int>(blockIdx.x / groups) * LX;  // first lattice column
  const int lj0 = static_cast<int>(blockIdx.y / s) * TH;       // first lattice row
  const int tid = threadIdx.y * TW + threadIdx.x;

  // stage the tile, point (ey, ex, c) at (ey * SX + ex) * CX + c: the texel
  // at the clamped coordinate of x class rx0 + c, lattice column li0 + ex - R
  // and lattice row lj0 + ey - R; consecutive points, consecutive pixels
  for (int e = tid; e < TILE; e += TW * TH) {
    const int c = e % CX, ex = (e / CX) % SX, ey = e / (CX * SX);
    const int gx = clampi(rx0 + c + s * (li0 + ex - R), 0, w - 1);
    const int gy = clampi(ry + s * (lj0 + ey - R), 0, h - 1);
    const int j = gy * w + gx;
    const float r = illum[3 * j], g = illum[3 * j + 1], b = illum[3 * j + 2];
    s_iv[e] = make_float4(r, g, b, variance[j]);
    s_nz[e] = make_float4(normal[3 * j], normal[3 * j + 1], normal[3 * j + 2], linear_z[j]);
    s_l[e] = lum(r, g, b);
  }
  __syncthreads();

  // thread (c, column) = (threadIdx.x % CX, threadIdx.x / CX): consecutive
  // threads, consecutive pixels of a run of CX, and consecutive tile points
  const int tc = threadIdx.x % CX, tcol = threadIdx.x / CX;
  const int x = rx0 + tc + s * (li0 + tcol);
  const int y = ry + s * (lj0 + static_cast<int>(threadIdx.y));
  if (x >= w || y >= h) return;
  const int i = y * w + x;
  const int c0 = ((threadIdx.y + R) * SX + tcol + R) * CX + tc;  // own tile point
  const float4 c = s_iv[c0];
  const float4 n = s_nz[c0];
  if (n.w == 1.f) {  // sky passthrough (svgf_Atrous.frag:77-82)
    out_illum[3 * i] = c.x;
    out_illum[3 * i + 1] = c.y;
    out_illum[3 * i + 2] = c.z;
    out_variance[i] = c.w;
    return;
  }
  const float l_c = s_l[c0];

  // 3x3 variance pre-blur, clamp to edge (svgf_Atrous.frag:24-36)
  float var_blur = c.w;
  if (!p.quirks) {
    var_blur = 0.f;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const float k = (dx == 0 ? 2.f : 1.f) * (dy == 0 ? 2.f : 1.f) * 0.0625f;
        float v;
        if (CX == 1 && s == 1) {  // the tile holds the 3x3 neighbours
          v = s_iv[c0 + dy * SX + dx].w;
        } else {
          v = variance[clampi(y + dy, 0, h - 1) * w + clampi(x + dx, 0, w - 1)];
        }
        var_blur = var_blur + k * v;
      }
    }
  }
  const float phi_l = maxp(p.sigma_l * sqrtf(maxp(1e-10f + var_blur, 1e-10f)), 1e-10f);
  const float inv_l = 1.f / phi_l;
  const float phi_depth = maxp(fwidth_z[i], 1e-8f) * static_cast<float>(s);
  const float inv_d[5] = {1.f / (phi_depth * 0x1p+0f), 1.f / (phi_depth * 0x1.6a09e6p+0f),
                          1.f / (phi_depth * 0x1p+1f), 1.f / (phi_depth * 0x1.1e377ap+1f),
                          1.f / (phi_depth * 0x1.6a09e6p+1f)};
  // bit k + 2 of in_x / in_y: tap offset k inside the image
  unsigned in_x = 0, in_y = 0;
#pragma unroll
  for (int k = -2; k <= 2; ++k) {
    in_x |= static_cast<unsigned>(x + k * s >= 0 && x + k * s < w) << (k + 2);
    const int yk = y + k * s;
    in_y |= static_cast<unsigned>(kWin ? yk >= p.y_lo && yk < p.y_hi : yk >= 0 && yk < h)
            << (k + 2);
  }

  float sum_w = 1.f, sr = c.x, sg = c.y, sb = c.z, sv = c.w;  // centre: weight 1
#pragma unroll
  for (int yy = -2; yy <= 2; ++yy) {
#pragma unroll
    for (int xx = -2; xx <= 2; ++xx) {
      if (xx == 0 && yy == 0) continue;
      const int e = c0 + (yy * SX + xx) * CX;
      const float4 q = s_iv[e];
      const float4 t = s_nz[e];
      const int ax = xx < 0 ? -xx : xx, ay = yy < 0 ? -yy : yy;
      // computeWeight (svgf_Atrous.frag:43-55)
      const float w_normal =
          denoise::pow_weight<kSq>(n.x * t.x + n.y * t.y + n.z * t.z, p.sigma_n, p.n_sq);
      const float w_z = fabsf(n.w - t.w) * inv_d[dist_index(ax, ay)];
      const float w_l = fabsf(l_c - s_l[e]) * inv_l;
      float wgt = expf(-w_l - w_z) * w_normal;
      const bool inside = (in_x >> (xx + 2)) & (in_y >> (yy + 2)) & 1u;
      wgt = inside ? wgt * b3(ax, ay) : 0.f;
      sum_w = sum_w + wgt;
      sr = sr + wgt * q.x;
      sg = sg + wgt * q.y;
      sb = sb + wgt * q.z;
      sv = sv + wgt * wgt * q.w;
    }
  }
  out_illum[3 * i] = sr / sum_w;
  out_illum[3 * i + 1] = sg / sum_w;
  out_illum[3 * i + 2] = sb / sum_w;
  out_variance[i] = sv / (sum_w * sum_w);
}

using StepKernel = void (*)(const float*, const float*, const float*, const float*,
                           const float*, float*, float*, Params);

// the instance for cx classes of x a block
template <int kSq, bool kWin>
StepKernel step_kernel(int cx) {
  return cx == 1 ? atrous_step<kSq, 1, kWin>
       : cx == 2 ? atrous_step<kSq, 2, kWin>
       : cx == 4 ? atrous_step<kSq, 4, kWin>
                 : atrous_step<kSq, 8, kWin>;
}

}  // namespace

extern "C" int tpuray_atrous_step(const float* illum, const float* variance,
                                  const float* normal, const float* linear_z,
                                  const float* fwidth_z, float* out_illum,
                                  float* out_variance, int h, int w, int row0, int global_h,
                                  int step, float sigma_n, int n_sq, float sigma_l, int quirks,
                                  cudaStream_t stream) {
  const int cx = classes_x(step);
  const int nbx = ((w + step - 1) / step + TW / cx - 1) / (TW / cx);
  const int nby = ((h + step - 1) / step + TH - 1) / TH;
  const Params p{h, w, step, -row0, global_h - row0, sigma_n, n_sq, sigma_l, quirks};
  const dim3 block(TW, TH);
  const dim3 grid(nbx * (step / cx), nby * step);
  constexpr int kS = denoise::kDefaultSquarings;
  const bool sq = n_sq == kS, win = row0 != 0 || global_h != h;
  const StepKernel kernel = sq ? (win ? step_kernel<kS, true>(cx) : step_kernel<kS, false>(cx))
                               : (win ? step_kernel<-1, true>(cx) : step_kernel<-1, false>(cx));
  kernel<<<grid, block, 0, stream>>>(illum, variance, normal, linear_z, fwidth_z, out_illum,
                                     out_variance, p);
  return static_cast<int>(cudaGetLastError());
}
