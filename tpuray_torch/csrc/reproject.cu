// K4: SVGF temporal reprojection + spatial variance fallback for the H100
// (sm_90a), hand-written CUDA C++.
//
// Replaces tpuray/kernels/reproject_pallas.py:_kernel (reproject_variance_
// fused): demodulate, reproject by the motion vectors (4 bilinear history
// taps with depth and normal validity, then a 3x3 rescue), the EMA with
// alpha_min and history_cap, then the 7x7 cross-bilateral variance fallback
// where the history is shorter than 4 frames.
//
// Semantics. The kernel computes reproject followed by estimate_variance
// (tpuray_torch/denoise/reproject.py and variance.py, and kernels/
// reproject.py's plain versions) under one of four tap rules, a template
// argument beside the row window, each its own instance:
//  * kExact: the JAX package's exact path, reproject(reproject_gather=
//    "exact"), including the clamps of the quad-packed history fetch:
//    bilinear taps come from the 2x2 quad at the clamped base, whose
//    neighbours clamp at the last row/column, with validity on the unclamped
//    position; rescue taps come from 4 quads with bases clamped to
//    [0, dim - 2], so an edge tap can count twice at the border.
//  * kTiled: what the TPU kernel (reproject_pallas._kernel) computes, the
//    tile-windowed read in its geometry: each 32 x 128 tile's window offsets
//    (passed in, computed by the wrapper with torch ops) gate every bilinear
//    and ring tap by the resolution predicate of tile_gather.py:resolve;
//    a resolved tap is the exact read at (clip(y0) + dy, clip(x0) + dx), so
//    it is read directly. Every reprojection of a block, its fallback halo
//    included, takes the window of the TPU tile holding the block, as the
//    TPU kernel reprojects its extended block with its tile's window.
//  * kTiledRows: tpuray's sharded stage, tile_gather's 40 x 160 tiles on a
//    row window, each pixel in its own tile.
//  * kFast: the exact bilinear taps; rescue tap (dy, dx) is the base tap of
//    pixel (y + dy, x + dx) under the edge clamp, with that pixel's bounds.
// The tiled rules' 9-tap rescue reads around the clipped base and drops
// the taps that do not resolve; it never runs the exact rule's quads.
//
// What bounds it on this card: device-memory bytes, 28 floats read and 11
// written per pixel (~100 MB at 800x800, 0.03 ms); the history gather
// follows the motion vectors and mostly hits L1/L2. The 7x7 fallback's 49
// taps are ~2k flops where it runs. The first version took two
// launches, the second (the fallback) waiting for the whole grid of the
// first and reading its outputs and a 7x7 window of the G-buffer back from
// L2 with 9 scalar loads, an exp and two divisions a tap: 0.128 ms.
//
// Design: one launch, one thread per pixel, 32 x 8 pixels a block,
// at most 85 registers (3 blocks an SM: the history gather is latency-bound).
//  * Each thread reprojects its pixel (reproject_px) and writes rep_illum,
//    rep_variance, moments and history_len from registers. A sky pixel
//    (about half of a default-view frame) writes its passthrough without
//    reading the history or demodulating: those outputs do not depend on
//    them.
//  * __syncthreads_or tells the block whether any of its pixels needs the
//    fallback (history_len < 4, not sky). If none does, each thread writes
//    var_* = rep_* from registers and the block ends.
//  * Otherwise the block fills a 38 x 14 tile (its pixels and a halo of 3)
//    in shared memory: rep_illum rgb and its luminance, the current normal
//    and linear_z, and moments, 40 bytes a point, each point the pixel at
//    its clamped coordinate (clamp to edge, as shift2d). Its own 256 points
//    come from registers; the 276 halo points are reprojected again by the
//    block (reproject_px on that pixel: the same instructions, so the same
//    bits as the pixel's own block computes), each reading what a pixel's
//    reprojection reads (~28 floats and its 4 to 20 history taps). Shared
//    memory: 532 points x 40 B = 21,280 bytes a block, static (no
//    cudaFuncSetAttribute); 80 registers, an 8-byte stack frame (ptxas).
//    On a moving frame 1.9% of the blocks stage a tile (PERF.md).
//  * The 7x7 fallback reads the tile only: constant offsets from the
//    thread's own point, the inside-the-image mask as a select.
//
// Row window. A rank of a row-sharded frame (tpuray_torch/dist/frame.py)
// passes its rows extended by its neighbours': local row y is image row
// row0 + y of an image global_h rows tall. The pixel and uv arithmetic,
// the tap bounds and the fallback's inside bits take image rows; every
// memory read takes the local row, clamped to the extended rows (the
// tile's halo too, as the plain version's shift2d); a pixel whose bilinear
// or rescue taps leave the extended rows fails its reprojection, as the
// plain version's in_shard does. The window is a template argument: without
// it (row0 0, global_h h) the kernel is the whole-image one.
//
// Exactness. Built with -fmad=false, IEEE division and sqrt and no fast
// math, every operation repeats the plain version's op order, so the
// outputs equal the plain PyTorch version's up to expf/powf's last bits;
// history_len and the validity decisions are exact. (Reciprocals taken once
// per pixel, as K5 takes them, moved var_variance = m1 - m0^2 past rtol
// 1e-5 where the two moments nearly cancel: the fallback divides per tap,
// which costs little, since it runs on under 1% of a moving frame's pixels.)
// Identities, not reorderings: the clamps of w_l and w_z at 0 are dropped
// (both are >= +0 or NaN). Distances are float constants (the float of the plain version's double
// sqrt) and the quirks path's 1 / w is rounded on the host, so no FP64
// instruction is left. jnp.round is half to even (rintf); max/min
// propagate NaN like torch.clamp_min (denoise_common.cuh).

#include "denoise_common.cuh"

namespace {

using denoise::clampi;
using denoise::lum;
using denoise::maxp;
using denoise::minp;

constexpr int BW = 32, BH = 8;  // pixels a block
constexpr int HR = 3;           // the fallback's radius
constexpr int SW = BW + 2 * HR, SH = BH + 2 * HR;
constexpr int TILE = SW * SH;            // 532 points
constexpr int RING = TILE - BW * BH;     // 276 halo points

struct Params {
  int h, w;        // the rows and columns in memory
  int row0, gh;    // local row 0 is image row row0 of gh (the row window)
  float depth_thr, normal_thr, history_cap, alpha_min;
  float sigma_n;
  int n_sq;  // sigma_n == 2^n_sq: repeated squaring; -1: powf
  float sigma_l;
  int quirks;
  float texel_w, texel_h;  // float(1.0 / w), float(1.0 / gh)
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

// isReprjValid (svgf_reproject.frag:31-43); yi an image row of h
__device__ __forceinline__ bool tap_valid(int yi, int xi, int h, const Params& p, float z,
                                          float fw_z, const float* n, float fw_n,
                                          const HistRow& t) {
  const bool in_b = xi >= 0 && xi < p.w && yi >= 0 && yi < h;
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

// what the reprojection gives a pixel, and its current G-buffer normal and z
struct Rep {
  float o[3];    // rep_illum
  float var;     // rep_variance
  float mom[2];  // moments
  float hl;      // history_len
  float n[3];
  float z;
};

// the history reads (tap rules): the exact read, the TPU kernel's tile-
// windowed read (its geometry, whole image), tpuray's sharded tile-windowed
// read (tile_gather's geometry, a row window) and the shifted rescue
enum Rule { kExact = 0, kTiled = 1, kTiledRows = 2, kFast = 3 };

// the tile-windowed rules' windows, computed by the wrapper
struct Tiles {
  const int* __restrict__ oy;  // (nty, ntx) window offsets
  const int* __restrict__ ox;
  int nty, ntx, ty, tx, span;
};

// the back-projected history position of pixel (x, y) of memory (local row y)
struct Base {
  float fx, fy, frac_x, frac_y;
  int x0, y0;  // the floor of (fx, fy); y0 an image row
};

template <bool kWin>
__device__ __forceinline__ Base back_project(const Inputs& in, const Params& p, int x, int y) {
  const int i = y * p.w + x;
  const int w = p.w, h = kWin ? p.gh : p.h, row0 = kWin ? p.row0 : 0;
  const float wf = static_cast<float>(w), hf = static_cast<float>(h);
  const float uv_x = (static_cast<float>(x) + 0.5f) / wf - in.motion[2 * i];
  const float uv_y = (static_cast<float>(y + row0) + 0.5f) / hf - in.motion[2 * i + 1];
  Base b;
  b.fx = uv_x * wf - 0.5f;
  b.fy = uv_y * hf - 0.5f;
  const float x0f = floorf(b.fx), y0f = floorf(b.fy);
  if (p.quirks) {
    // jnp.remainder: fmod, then + d where the remainder is negative; d is
    // 1/w in double rounded to float (on the host), as the plain version's
    // scalar is
    const float dx = p.texel_w, dy = p.texel_h;
    b.frac_x = fmodf(uv_x, dx);
    b.frac_y = fmodf(uv_y, dy);
    if (b.frac_x < 0.f) b.frac_x = b.frac_x + dx;
    if (b.frac_y < 0.f) b.frac_y = b.frac_y + dy;
  } else {
    b.frac_x = b.fx - x0f;
    b.frac_y = b.fy - y0f;
  }
  b.x0 = static_cast<int>(x0f);
  b.y0 = static_cast<int>(y0f);
  return b;
}

// a pixel under a tile-windowed rule: the image rows [lo, hi) its read
// takes, its image row and column, its clipped residuals, its tile's window
struct Window {
  int lo, hi, y, x, rp, cp, oy, ox;
};

// tap (dy, dx) of the tile-windowed read (tpuray_torch/denoise/
// tile_gather.py:resolve): the neighbour pixel (y + dy, x + dx), clamped to
// the image, selects its texel (ty, tx) by its residual where it lies in the
// window (sel); the tap resolves where, besides, the residual is the pixel's
// own and the texel lies in the image, and then it is the exact read. Past
// the image the neighbour's base moves with it: kTiled clips it after the
// move (the TPU kernel's edge-padded planes), kTiledRows before
// (tile_gather's edge-padded residuals).
template <int kRule, bool kWin>
__device__ __forceinline__ bool ring_tap(const Inputs& in, const Params& p, const Tiles& tl,
                                         const Window& g, int dy, int dx, bool& sel, int& ty,
                                         int& tx) {
  const int row0 = kWin ? p.row0 : 0;
  const int qy = g.y + dy, qx = g.x + dx;
  const int cy = clampi(qy, g.lo, g.hi - 1), cx = clampi(qx, 0, p.w - 1);
  const Base b = back_project<kWin>(in, p, cx, cy - row0);
  if (kRule == kTiled) {
    ty = clampi(b.y0 + (qy - cy), g.lo, g.hi - 1);
    tx = clampi(b.x0 + (qx - cx), 0, p.w - 1);
  } else {
    ty = clampi(b.y0, g.lo, g.hi - 1) + (qy - cy);
    tx = clampi(b.x0, 0, p.w - 1) + (qx - cx);
  }
  const int rq = ty - qy, cq = tx - qx;
  sel = rq >= g.oy && rq <= g.oy + tl.span && cq >= g.ox && cq <= g.ox + tl.span;
  return sel && rq == g.rp && cq == g.cp && ty >= g.lo && ty < g.hi && tx >= 0 && tx < p.w;
}

// the reprojection of pixel (x, y) of memory (local row y) under rule kRule;
// (ti, tj) the tile whose window kTiled reads (the block's); a sky pixel's
// outputs are its passthrough, so it reads no history
template <int kRule, bool kWin>
__device__ __forceinline__ Rep reproject_px(const Inputs& in, const Params& p, const Tiles& tl,
                                            int x, int y, int ti, int tj) {
  const int i = y * p.w + x;
  // w, h: the image's columns and rows; y + row0: the pixel's image row
  const int w = p.w, h = kWin ? p.gh : p.h, row0 = kWin ? p.row0 : 0;
  // the memory row of image row t, clamped to the rows in memory
  auto local = [&](int t) { return kWin ? clampi(t - row0, 0, p.h - 1) : t; };
  Rep r;
  r.z = in.linear_z[i];
  const float z = r.z;
#pragma unroll
  for (int c = 0; c < 3; ++c) r.n[c] = in.normal[3 * i + c];
  if (z == 1.f) {  // sky passthrough (frag:166-171): raw colour, the prior moments
#pragma unroll
    for (int c = 0; c < 3; ++c) r.o[c] = in.color[3 * i + c];
    r.var = 0.f;
    r.mom[0] = in.prev_moments[2 * i];
    r.mom[1] = in.prev_moments[2 * i + 1];
    r.hl = in.prev_hist[i];
    return r;
  }
  const float fw_z = in.fwidth_z[i], fw_n = in.fwidth_normal[i];
  const float* n = r.n;

  // demodulate (svgf_reproject.frag:26-29, 174)
  float il[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v = (in.color[3 * i + c] - in.emission[3 * i + c]) /
                    maxp(in.albedo[3 * i + c], 1e-3f);
    il[c] = (v != v) ? 0.f : v;
  }

  // back-projected pixel position
  const Base bp = back_project<kWin>(in, p, x, y);
  const float fx = bp.fx, fy = bp.fy, frac_x = bp.frac_x, frac_y = bp.frac_y;
  const int x0 = bp.x0, y0 = bp.y0;

  const int yc = clampi(y0, 0, h - 1), xc = clampi(x0, 0, w - 1);
  const float wts[4] = {(1.f - frac_x) * (1.f - frac_y), frac_x * (1.f - frac_y),
                        (1.f - frac_x) * frac_y, frac_x * frac_y};
  float hls[4];
  float sum_w = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f}, acc_m[2] = {0.f, 0.f};
  bool any_valid = false;
  bool in_shard = true;
  Window g{};
  if constexpr (kRule == kTiled || kRule == kTiledRows) {
    // the 4 bilinear taps are ring taps (dy, dx) = (qdy(k), qdx(k)), each
    // counted where it resolves; the history length is the nearest corner's
    // texel, resolved or not
    // the read's image: the whole image (kTiled), the rows in memory, each
    // pixel in its own tile (kTiledRows: tpuray's sharded stage)
    g.lo = row0;
    g.hi = row0 + p.h;
    if (kRule == kTiledRows) {
      ti = y / tl.ty;
      tj = x / tl.tx;
    }
    g.y = y + row0;
    g.x = x;
    g.rp = clampi(y0, g.lo, g.hi - 1) - g.y;
    g.cp = xc - x;
    g.oy = tl.oy[ti * tl.ntx + tj];
    g.ox = tl.ox[ti * tl.ntx + tj];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      bool sel;
      int ty, tx;
      const bool res = ring_tap<kRule, kWin>(in, p, tl, g, qdy(k), qdx(k), sel, ty, tx);
      hls[k] = 0.f;
      if (res) {
        const HistRow t = fetch(in, ty - row0, tx, w);
        hls[k] = t.hl;
        if (tap_valid(y0 + qdy(k), x0 + qdx(k), h, p, z, fw_z, n, fw_n, t)) {
          any_valid = true;
          const float wv = wts[k];
          sum_w = sum_w + wv;
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[c] = acc[c] + wv * t.iv[c];
          acc_m[0] = acc_m[0] + wv * t.m[0];
          acc_m[1] = acc_m[1] + wv * t.m[1];
        }
      } else if (sel && ty >= g.lo && ty < g.hi && tx >= 0 && tx < w) {
        hls[k] = in.prev_hist[(ty - row0) * w + tx];
      }
    }
  } else {
    // the 4 bilinear taps: one quad at the clamped base
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const HistRow t = fetch(in, local(min(yc + qdy(k), h - 1)), min(xc + qdx(k), w - 1), w);
      hls[k] = t.hl;
      const bool v = tap_valid(y0 + qdy(k), x0 + qdx(k), h, p, z, fw_z, n, fw_n, t);
      any_valid = any_valid || v;
      const float wv = v ? wts[k] : 0.f;
      sum_w = sum_w + wv;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] = acc[c] + wv * t.iv[c];
      acc_m[0] = acc_m[0] + wv * t.m[0];
      acc_m[1] = acc_m[1] + wv * t.m[1];
    }
    // a window's pixel whose bilinear or rescue taps leave the rows in
    // memory fails (the plain version's in_shard)
    if (kWin) {
      const int lo = min(yc, clampi(y0 - 1, 0, h - 2));
      const int hi = max(min(yc + 1, h - 1), clampi(y0 + 1, 0, h - 2) + 1);
      in_shard = lo >= row0 && hi < row0 + p.h;
    }
  }
  const bool bilinear_ok = any_valid && (sum_w >= 0.01f) && in_shard;
  const float safe_w = maxp(sum_w, 1e-6f);
  float prev_i[4], prev_m[2];
#pragma unroll
  for (int c = 0; c < 4; ++c) prev_i[c] = bilinear_ok ? acc[c] / safe_w : 0.f;
  prev_m[0] = bilinear_ok ? acc_m[0] / safe_w : 0.f;
  prev_m[1] = bilinear_ok ? acc_m[1] / safe_w : 0.f;

  // 3x3 rescue (svgf_reproject.frag:111-141), only read where the bilinear
  // taps failed
  bool rescue_ok = false;
  if (!bilinear_ok && in_shard) {
    float n_valid = 0.f, rs[4] = {0.f, 0.f, 0.f, 0.f}, rs_m[2] = {0.f, 0.f};
    if constexpr (kRule == kTiled || kRule == kTiledRows) {
      // the 9 taps around the clipped base, each where it resolves
      for (int dy = -1; dy <= 1; ++dy) {
        for (int dx = -1; dx <= 1; ++dx) {
          bool sel;
          int ty, tx;
          if (!ring_tap<kRule, kWin>(in, p, tl, g, dy, dx, sel, ty, tx)) continue;
          const HistRow t = fetch(in, ty - row0, tx, w);
          if (!tap_valid(y0 + dy, x0 + dx, h, p, z, fw_z, n, fw_n, t)) continue;
          n_valid = n_valid + 1.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) rs[c] = rs[c] + t.iv[c];
          rs_m[0] = rs_m[0] + t.m[0];
          rs_m[1] = rs_m[1] + t.m[1];
        }
      }
    } else if constexpr (kRule == kFast) {
      // tap (y0 + dy, x0 + dx) taken as the base tap of the pixel
      // (y + dy, x + dx), edge clamped (shift2d); its bounds test is that
      // pixel's
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          const Base bq = back_project<kWin>(in, p, clampi(x + dx, 0, w - 1),
                                             clampi(y + dy, 0, p.h - 1));
          const HistRow t = fetch(in, clampi(bq.y0, 0, h - 1), clampi(bq.x0, 0, w - 1), w);
          const bool v = tap_valid(bq.y0, bq.x0, h, p, z, fw_z, n, fw_n, t);
          const float vf = v ? 1.f : 0.f;
          n_valid = n_valid + vf;
#pragma unroll
          for (int c = 0; c < 4; ++c) rs[c] = rs[c] + vf * t.iv[c];
          rs_m[0] = rs_m[0] + vf * t.m[0];
          rs_m[1] = rs_m[1] + vf * t.m[1];
        }
      }
    } else {
      // 4 quads, bases clamped to [0, dim - 2]
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
          const HistRow t = fetch(in, local(ty), tx, w);
          const bool v = in_window && tap_valid(ty, tx, h, p, z, fw_z, n, fw_n, t);
          const float vf = v ? 1.f : 0.f;
          n_valid = n_valid + vf;
#pragma unroll
          for (int c = 0; c < 4; ++c) rs[c] = rs[c] + vf * t.iv[c];
          rs_m[0] = rs_m[0] + vf * t.m[0];
          rs_m[1] = rs_m[1] + vf * t.m[1];
        }
      }
    }
    rescue_ok = n_valid > 0.f;
    if (rescue_ok) {
      const float safe_n = maxp(n_valid, 1.f);
#pragma unroll
      for (int c = 0; c < 4; ++c) prev_i[c] = rs[c] / safe_n;
      prev_m[0] = rs_m[0] / safe_n;
      prev_m[1] = rs_m[1] / safe_n;
    }
  }
  const bool success = bilinear_ok || rescue_ok;

  // history length at round(f): one of the 4 bilinear corners
  const bool near_x = clampi(static_cast<int>(rintf(fx)), 0, w - 1) > xc;
  const bool near_y = clampi(static_cast<int>(rintf(fy)), 0, h - 1) > yc;
  const float hist_prev = near_y ? (near_x ? hls[3] : hls[2]) : (near_x ? hls[1] : hls[0]);
  // EMA + history-length tail (svgf_reproject.frag:143-205)
  r.hl = minp(success ? hist_prev + 1.f : 1.f, p.history_cap);
  const float alpha = success ? maxp(1.f / r.hl, p.alpha_min) : 1.f;
  const float l = lum(il[0], il[1], il[2]);
  const float mom_new[2] = {l, l * l};
  r.mom[0] = (1.f - alpha) * prev_m[0] + alpha * mom_new[0];
  r.mom[1] = (1.f - alpha) * prev_m[1] + alpha * mom_new[1];
  r.var = maxp(r.mom[1] - r.mom[0] * r.mom[0], 0.f);
#pragma unroll
  for (int c = 0; c < 3; ++c) r.o[c] = (1.f - alpha) * prev_i[c] + alpha * il[c];
  return r;
}

// halo point k of the tile (the ring around the block's 32 x 8) -> (ex, ey)
__device__ __forceinline__ void ring_point(int k, int& ex, int& ey) {
  if (k < 2 * HR * SW) {  // the top and bottom bands, full width
    const int band = k / (HR * SW), rem = k % (HR * SW);
    ey = band * (SH - HR) + rem / SW;
    ex = rem % SW;
  } else {  // the left and right columns beside the block's rows
    k -= 2 * HR * SW;
    ey = HR + k / (2 * HR);
    const int c = k % (2 * HR);
    ex = c < HR ? c : BW + c;
  }
}

// tap distance sqrt(d2) of the 7x7 window for d2 = dx^2 + dy^2 in {0, 1, 2,
// 4, 5, 8, 9, 10, 13, 18}, the float of the plain version's double
__device__ __forceinline__ float dist7(int d2) {
  return d2 == 0 ? 0.f : d2 == 1 ? 0x1p+0f : d2 == 2 ? 0x1.6a09e6p+0f : d2 == 4 ? 0x1p+1f
       : d2 == 5 ? 0x1.1e377ap+1f : d2 == 8 ? 0x1.6a09e6p+1f : d2 == 9 ? 0x1.8p+1f
       : d2 == 10 ? 0x1.94c584p+1f : d2 == 13 ? 0x1.cd82b4p+1f : 0x1.0f876cp+2f;
}

template <int kSq, bool kWin, int kRule>
__global__ void __launch_bounds__(BW * BH, 3) reproject_variance(Inputs in, Outputs out,
                                                                 Params p, Tiles tl) {
  __shared__ float4 s_il[TILE];  // rep_illum rgb, its luminance
  __shared__ float4 s_nz[TILE];  // normal, linear_z
  __shared__ float2 s_m[TILE];   // moments

  const int w = p.w, h = p.h;
  const int bx0 = blockIdx.x * BW, by0 = blockIdx.y * BH;
  const int x = bx0 + threadIdx.x, y = by0 + threadIdx.y;
  const bool in_img = x < w && y < h;
  const int i = y * w + x;
  const int c0 = (threadIdx.y + HR) * SW + threadIdx.x + HR;  // own tile point
  // kTiled: the TPU kernel's tile holding the block, whose window every
  // reprojection of the block reads, its halo's too
  const int ti = kRule == kTiled ? by0 / tl.ty : 0, tj = kRule == kTiled ? bx0 / tl.tx : 0;
  float var, hl;  // what the fallback or its passthrough needs besides the tile
  bool needs;
  {
    // a thread past the ragged edge reprojects the clamped pixel: its tile point
    const Rep r = reproject_px<kRule, kWin>(in, p, tl, min(x, w - 1), min(y, h - 1), ti, tj);
    if (in_img) {
#pragma unroll
      for (int c = 0; c < 3; ++c) out.rep_illum[3 * i + c] = r.o[c];
      out.rep_variance[i] = r.var;
      out.moments[2 * i] = r.mom[0];
      out.moments[2 * i + 1] = r.mom[1];
      out.history_len[i] = r.hl;
    }
    // estimate_variance (svgf_variance.frag) where history_len < 4, not sky
    needs = in_img && r.hl < 4.f && !(r.z == 1.f);
    if (!__syncthreads_or(needs)) {
      if (in_img) {
#pragma unroll
        for (int c = 0; c < 3; ++c) out.var_illum[3 * i + c] = r.o[c];
        out.var_variance[i] = r.var;
      }
      return;
    }
    s_il[c0] = make_float4(r.o[0], r.o[1], r.o[2], lum(r.o[0], r.o[1], r.o[2]));
    s_nz[c0] = make_float4(r.n[0], r.n[1], r.n[2], r.z);
    s_m[c0] = make_float2(r.mom[0], r.mom[1]);
    var = r.var;
    hl = r.hl;
  }
  for (int k = threadIdx.y * BW + threadIdx.x; k < RING; k += BW * BH) {
    int ex, ey;
    ring_point(k, ex, ey);
    const Rep q = reproject_px<kRule, kWin>(in, p, tl, clampi(bx0 + ex - HR, 0, w - 1),
                                            clampi(by0 + ey - HR, 0, h - 1), ti, tj);
    const int e = ey * SW + ex;
    s_il[e] = make_float4(q.o[0], q.o[1], q.o[2], lum(q.o[0], q.o[1], q.o[2]));
    s_nz[e] = make_float4(q.n[0], q.n[1], q.n[2], q.z);
    s_m[e] = make_float2(q.mom[0], q.mom[1]);
  }
  __syncthreads();
  if (!in_img) return;
  const float4 own = s_il[c0];
  if (!needs) {
    out.var_illum[3 * i] = own.x;
    out.var_illum[3 * i + 1] = own.y;
    out.var_illum[3 * i + 2] = own.z;
    out.var_variance[i] = var;
    return;
  }

  const float4 nz = s_nz[c0];
  const float l_c = own.w;
  const float phi_depth = maxp(in.fwidth_z[i], 1e-8f) * 3.0f;
  const float phi_l = maxp(p.sigma_l, 1e-10f);
  // bit k + 3 of in_x / in_y: offset k inside the image (image rows)
  const int gy = kWin ? y + p.row0 : y, gh = kWin ? p.gh : h;
  unsigned in_x = 0, in_y = 0;
#pragma unroll
  for (int k = -HR; k <= HR; ++k) {
    in_x |= static_cast<unsigned>(x + k >= 0 && x + k < w) << (k + HR);
    in_y |= static_cast<unsigned>(gy + k >= 0 && gy + k < gh) << (k + HR);
  }

  float sum_w = 0.f, s_i[3] = {0.f, 0.f, 0.f}, s_mo[2] = {0.f, 0.f};
#pragma unroll
  for (int dy = -HR; dy <= HR; ++dy) {
#pragma unroll
    for (int dx = -HR; dx <= HR; ++dx) {
      const int e = c0 + dy * SW + dx;
      const float4 a = s_il[e];
      const float4 g = s_nz[e];
      const float2 m = s_m[e];
      // computeWeight (svgf_variance.frag:23-35)
      const float w_normal =
          denoise::pow_weight<kSq>(nz.x * g.x + nz.y * g.y + nz.z * g.z, p.sigma_n, p.n_sq);
      const float phi_d = phi_depth * dist7(dx * dx + dy * dy);
      const float w_z = (phi_d == 0.f) ? 0.f : fabsf(nz.w - g.w) / phi_d;
      const float w_l = fabsf(l_c - a.w) / phi_l;
      float wgt = expf(-w_l - w_z) * w_normal;
      const bool inside = (in_x >> (dx + HR)) & (in_y >> (dy + HR)) & 1u;
      wgt = inside ? wgt : 0.f;
      sum_w = sum_w + wgt;
      s_i[0] = s_i[0] + wgt * a.x;
      s_i[1] = s_i[1] + wgt * a.y;
      s_i[2] = s_i[2] + wgt * a.z;
      s_mo[0] = s_mo[0] + wgt * m.x;
      s_mo[1] = s_mo[1] + wgt * m.y;
    }
  }
  sum_w = maxp(sum_w, 1e-6f);
#pragma unroll
  for (int c = 0; c < 3; ++c) out.var_illum[3 * i + c] = s_i[c] / sum_w;
  const float m0 = s_mo[0] / sum_w, m1 = s_mo[1] / sum_w;
  out.var_variance[i] = (m1 - m0 * m0) * (4.f / maxp(hl, 1e-3f));
}

}  // namespace

extern "C" int tpuray_reproject_variance(
    const float* color, const float* emission, const float* albedo, const float* motion,
    const float* normal, const float* linear_z, const float* fwidth_normal,
    const float* fwidth_z, const float* prev_illum, const float* prev_variance,
    const float* prev_normal, const float* prev_linear_z, const float* prev_moments,
    const float* prev_history_len, float* rep_illum, float* rep_variance, float* moments,
    float* history_len, float* var_illum, float* var_variance, int h, int w, int row0,
    int global_h, float depth_thr, float normal_thr, float history_cap, float alpha_min,
    float sigma_n, int n_sq, float sigma_l, int quirks, int rule, const int* tile_oy,
    const int* tile_ox, int nty, int ntx, int ty, int tx, int span, cudaStream_t stream) {
  const Inputs in{color, emission, albedo, motion, normal, linear_z, fwidth_normal,
                  fwidth_z, prev_illum, prev_variance, prev_normal, prev_linear_z,
                  prev_moments, prev_history_len};
  const Outputs out{rep_illum, rep_variance, moments, history_len, var_illum, var_variance};
  const Params p{h, w, row0, global_h, depth_thr, normal_thr, history_cap, alpha_min,
                 sigma_n, n_sq, sigma_l, quirks, static_cast<float>(1.0 / w),
                 static_cast<float>(1.0 / global_h)};
  const Tiles tl{tile_oy, tile_ox, nty, ntx, ty, tx, span};
  const dim3 block(BW, BH);
  const dim3 grid((w + BW - 1) / BW, (h + BH - 1) / BH);
  constexpr int kS = denoise::kDefaultSquarings;
  const bool sq = n_sq == kS, win = row0 != 0 || global_h != h;
  // kTiled takes the whole image, in tiles that hold whole blocks (a block
  // reads its tile's window); kTiledRows a row window; kFast no window (a
  // row shard reads kTiledRows)
  if ((rule == kTiled && (win || ty % BH || tx % BW)) || (rule == kFast && win) ||
      rule < kExact || rule > kFast || (rule != kExact && rule != kFast && !tile_oy))
    return static_cast<int>(cudaErrorInvalidValue);
  decltype(&reproject_variance<kS, false, kExact>) kernel;
  switch (rule) {
    case kTiled:
      kernel = sq ? reproject_variance<kS, false, kTiled> : reproject_variance<-1, false, kTiled>;
      break;
    case kTiledRows:
      kernel = sq ? reproject_variance<kS, true, kTiledRows>
                  : reproject_variance<-1, true, kTiledRows>;
      break;
    case kFast:
      kernel = sq ? reproject_variance<kS, false, kFast> : reproject_variance<-1, false, kFast>;
      break;
    default:
      kernel = sq ? (win ? reproject_variance<kS, true, kExact>
                         : reproject_variance<kS, false, kExact>)
                  : (win ? reproject_variance<-1, true, kExact>
                         : reproject_variance<-1, false, kExact>);
  }
  kernel<<<grid, block, 0, stream>>>(in, out, p, tl);
  return static_cast<int>(cudaGetLastError());
}
