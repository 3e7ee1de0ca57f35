// What K1 (raster3d_fwd.cu, raster3d_fwd_tile.cuh) and K2 (raster3d_bwd.cu)
// share: the layout, the warp map, sigma rounded as the plain version
// rounds it, and the two tests that let both kernels skip work that
// provably has alpha = 0: a per-pair rejection and a per-warp support box.
//
// For pixel centre (px, py) and a gaussian with fields (mx, my, a, b, c,
// op), dx = px - mx, dy = py - my:
//   sigma = 0.5 a dx^2 + b dx dy + 0.5 c dy^2,
//   alpha = min(op * exp(-sigma), 0.999), 0 below c = fl(1/255).
// `sigma` rounds every product and sum on its own (__fmul_rn, __fadd_rn),
// with no FMA contraction, in the order of the plain PyTorch version
// (horizongs_tpu_torch/ops/raster3d.py `_segment_geometry`), so the 1/255
// and 0.999 cuts fall bit for bit where the plain version's do.
//
// The rejection (`skip_threshold`, plain copy `raster3d.skip_threshold`;
// the pair test `raster3d.segment_reject`). Since 0.999 >= c, alpha > 0
// needs raw = fl(op * expf(-sigma)) >= c. Per gaussian, once at staging,
//   thr = max(tau + m |tau| + delta, -80),  tau = logf(fl(255 op)),
//   m = delta = 1e-5,
// (-1 where op <= 0; NaN, so that nothing is skipped, where op is not
// finite). A pair whose rounded sigma (the kernel's own value, the one its
// exact path feeds to expf) is > thr skips the expf and everything after
// it. Sigma may be negative (Q need not be positive definite), so thr is
// not clamped at 0. Why the margin suffices (u = 2^-24):
//  * exact path: -sigma is exact, expf is within 2 ulp (4u relative) and
//    the product rounds once, so raw_fl = op e^(-sigma) (1 + e), |e| <= 5u,
//    and raw_fl >= c gives sigma <= ln(op / c) + 5u, as long as expf does
//    not overflow (sigma > -88.7): the floor -80 keeps every skipped sigma
//    there, and raising thr only skips less.
//  * threshold: above the floor, 255 op >= 1.8e-35 is a normal number, so
//    fl(255 op) is within u, c within u of 1/255, and logf within 1 ulp
//    (<= 4.8e-7 for |tau| < 8), so |tau - ln(op/c)| <= 2u + 4.8e-7 <= 6e-7;
//    the two roundings of thr cost <= 2u (|tau| + 1e-5) more. For |tau| >= 8
//    the ulp of logf is 2^-23 |tau| at most, which m |tau| covers.
//  So a pair with sigma_fl > thr >= ln(op / c) - 6e-7 - 1.2e-7 (|tau| + 1)
//  + 1e-5 |tau| + 1e-5 > ln(op / c) + 5u has raw_fl < c: alpha = 0 bit for
//  bit. The margin is about ten times the rounding it covers. A NaN sigma or
//  thr compares false: no skip; sigma = +inf has expf = 0 and is skipped
//  rightly for a finite op. op <= 0 (finite): a pair with sigma > -1 has
//  e^(-sigma) < e, so raw <= 0.
//
// The support box (`support_box`, plain copy `raster3d.support_box`), in
// double precision, once per gaussian at staging: the pixel centres outside
// it have alpha = 0. With Q = [[a, b], [b, c]] positive definite, det =
// ac - b^2, the ellipse 0.5 d^T Q d <= t has half extents
//   hx = sqrt(2 t c / det),  hy = sqrt(2 t a / det).
// The rounded sigma differs from the exact form of the exact offset by at
// most gamma * sum |term| (each term two roundings and the rounded dx, dy
// (4u), the two sums (2u): 6u; gamma = 1e-6 > 16u), and sum |term| <=
// kappa * sigma, where kappa = lambda_max / lambda_min of Q ([[a, |b|],
// [|b|, c]] has Q's eigenvalues). So the box takes
//   t = 1.001 thr / (1 - gamma kappa),
// and a pixel centre outside it has sigma_fl >= sigma (1 - gamma kappa) >
// 1.001 thr >= thr: the pair test would reject it. Each side is then
// widened by 1 pixel plus 1e-4 of |centre| + half extent (the bounds are
// rounded to float). The box is the whole plane where thr is NaN, where Q
// is not positive definite (a <= 0 or det <= 0), where gamma kappa > 0.5,
// or where anything is not finite; it is empty where thr < 0 (Q positive
// definite and well conditioned gives sigma_fl >= 0, so raw <= op e^(5u),
// below c). A warp skips a gaussian outright when its pixel centres all lie
// outside the box.
#pragma once

#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "warp_common.cuh"

namespace raster3d {

using namespace warp_common;

constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kPixels = kTileW * kTileH;          // 1024
constexpr int kChunk = 128;                        // G
constexpr int kThreads = 512;
constexpr int kMinBlocks = 3;                      // resident per SM
constexpr int kPixPerThread = kPixels / kThreads;  // 2
constexpr int kFields = 10;
constexpr int kAccRows = 5;
constexpr int kRowCopies = kFields / 2;            // 8-byte copies per row
constexpr float kAlphaCutoff = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.999f;
constexpr float kLogTEps = -9.210340371976184f;   // log(1e-4)
constexpr float kRejectRel = 1e-5f;                // m
constexpr float kRejectAbs = 1e-5f;                // delta
constexpr float kThrFloor = -80.0f;
constexpr double kBoxRhoScale = 1.001;
constexpr double kBoxSigmaRel = 1e-6;              // gamma
constexpr double kBoxMaxLoss = 0.5;                // largest gamma kappa
constexpr double kBoxPadPx = 1.0;
constexpr double kBoxPadRel = 1e-4;

// The warp map of both kernels: warp w of a 512-thread block owns the 8x8
// pixel block at column 8 (w % 4), row 8 (w / 4) of the 32x32 tile; lane l
// its pixels (l % 8, l / 8 + 4k), k = 0, 1, of that block.
constexpr int kWarps = kThreads / 32;              // 16
constexpr int kBlockW = 8;
constexpr int kBlockH = 8;
constexpr int kBlocksX = kTileW / kBlockW;         // warp blocks per row
constexpr int kRowStep = 32 / kBlockW;             // rows between k, k + 1

static_assert(kPixels % kThreads == 0, "pixels must split evenly");
static_assert(kChunk <= kThreads, "one thread derives one gaussian");
static_assert(kWarps * kBlockW * kBlockH == kPixels, "warps tile the tile");
static_assert(kRowStep * kPixPerThread == kBlockH, "lanes tile a block");

__device__ __forceinline__ int warp_pixel(int warp, int lane, int k) {
  const int x = (warp % kBlocksX) * kBlockW + lane % kBlockW;
  const int y = (warp / kBlocksX) * kBlockH + lane / kBlockW + kRowStep * k;
  return y * kTileW + x;
}

// sigma of the header comment, product by product; 0.5 a and 0.5 c are
// exact, so the caller may hoist them (ha, hc) out of the pixel loop
__device__ __forceinline__ float sigma_of(float ha, float b, float hc,
                                          float dx, float dy) {
  return __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(ha, dx), dx),
                             __fmul_rn(__fmul_rn(b, dx), dy)),
                   __fmul_rn(__fmul_rn(hc, dy), dy));
}

// thr of the header comment: -1 where op <= 0, NaN (no pair skipped)
// where op is not finite.
__device__ __forceinline__ float skip_threshold(float op) {
  if (!isfinite(op)) return NAN;
  if (op <= 0.0f) return -1.0f;
  const float tau = logf(__fmul_rn(255.0f, op));
  const float thr =
      __fadd_rn(__fadd_rn(tau, __fmul_rn(kRejectRel, fabsf(tau))), kRejectAbs);
  return fmaxf(thr, kThrFloor);
}

// The support box as pixel-centre bounds x0 <= x <= x1, y0 <= y <= y1.
struct Box {
  float x0, x1, y0, y1;
};

// f points at the gaussian's (mx, my, a, b, c) fields.
__device__ __forceinline__ Box support_box(const float* f, float thr) {
  const Box all = {-INFINITY, INFINITY, -INFINITY, INFINITY};
  if (!(thr == thr)) return all;
  const double mx = f[0], my = f[1], a = f[2], b = f[3], c = f[4];
  const double det = a * c - b * b;
  if (!(a > 0.0 && det > 0.0 && isfinite(det) && isfinite(mx) &&
        isfinite(my)))
    return all;
  // kappa = lambda_max / lambda_min
  const double half = 0.5 * (a + c);
  const double r = sqrt(0.25 * (a - c) * (a - c) + b * b);
  const double kappa = (half + r) / (det / (half + r));
  const double loss = kBoxSigmaRel * kappa;
  if (!(loss <= kBoxMaxLoss)) return all;
  if (thr < 0.0f) return Box{INFINITY, -INFINITY, INFINITY, -INFINITY};
  const double t = kBoxRhoScale * static_cast<double>(thr) / (1.0 - loss);
  const double hx = sqrt(2.0 * t * c / det);
  const double hy = sqrt(2.0 * t * a / det);
  const double pxd = kBoxPadPx + kBoxPadRel * (fabs(mx) + hx);
  const double pyd = kBoxPadPx + kBoxPadRel * (fabs(my) + hy);
  const Box box = {static_cast<float>(mx - hx - pxd),
                   static_cast<float>(mx + hx + pxd),
                   static_cast<float>(my - hy - pyd),
                   static_cast<float>(my + hy + pyd)};
  if (!(fabsf(box.x0) <= FLT_MAX && fabsf(box.x1) <= FLT_MAX &&
        fabsf(box.y0) <= FLT_MAX && fabsf(box.y1) <= FLT_MAX))
    return all;
  return box;
}

// Bit w set: warp w of the tile at (x0, y0) (its top-left pixel corner) has
// a pixel centre inside the box, so it walks the gaussian.
__device__ __forceinline__ unsigned warp_mask(const Box& b, float x0,
                                              float y0) {
  unsigned mask = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float xl = x0 + static_cast<float>((w % kBlocksX) * kBlockW) + 0.5f;
    const float yl = y0 + static_cast<float>((w / kBlocksX) * kBlockH) + 0.5f;
    const float xh = xl + static_cast<float>(kBlockW - 1);
    const float yh = yl + static_cast<float>(kBlockH - 1);
    const bool out = b.x1 < xl || b.x0 > xh || b.y1 < yl || b.y0 > yh;
    mask |= out ? 0u : (1u << w);
  }
  return mask;
}

// A chunk of up to kChunk gaussians' field rows in shared memory: row j,
// field r at rows[j][r / 2] (x for even r, y for odd).
struct Chunk {
  float2 rows[kChunk][kRowCopies];
};

__device__ __forceinline__ const float* row(const Chunk& s, int j) {
  return reinterpret_cast<const float*>(s.rows[j]);
}

// Starts the gather of the m gaussians ids[0..m) into dst with the block's
// threads (the thread of a given (row, piece) is the same for every chunk,
// so a thread's own wait covers the slots it writes) and commits it as one
// group (an empty group where m == 0). fields must be 8-byte aligned.
__device__ __forceinline__ void stage(Chunk& dst,
                                      const float* __restrict__ fields,
                                      const int* __restrict__ ids, int m,
                                      int tid) {
  for (int e = tid; e < m * kRowCopies; e += kThreads) {
    const int j = e / kRowCopies;
    const int p = e - j * kRowCopies;
    cp_async8(&dst.rows[j][p],
              fields + static_cast<size_t>(ids[j]) * kFields + 2 * p);
  }
  cp_async_commit();
}

}  // namespace raster3d
