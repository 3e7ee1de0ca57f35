// The 2DGS ray-splat intersection shared by K3 (raster2d_fwd.cu) and K4
// (raster2d_bwd.cu), so that the backward recomputes every alpha and every
// cut-off exactly as the forward did.
//
// For pixel (px, py) and a surfel with splat transform rows M1, M2, M3,
// projected centre (mx, my) and opacity op (the TPU kernel's `_intersect`,
// horizongs_tpu/ops/pallas/raster2d.py:83-129):
//   hu = px*M3 - M1, hv = py*M3 - M2, k = hu x hv,
//   kz' = kz if |kz| > 1e-9 else 1e-9, (u, v) = (kx, ky) / kz',
//   rho3d = u^2 + v^2, rho2d = 2 * ((px - mx)^2 + (py - my)^2),
//   rho = rho3d if rho3d <= rho2d else rho2d, z = M3 . (u, v, 1),
//   alpha = min(op * exp(-rho / 2), 0.999), 0 below 1/255 or where
//   z <= 0.01.
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn) and the divisions are IEEE (__fdiv_rn), with no FMA
// contraction: the inputs of the comparisons that decide alpha (the kz
// gate, rho3d <= rho2d, the 1/255 and z cut-offs) are bit for bit those of
// the plain PyTorch version (horizongs_tpu_torch/ops/raster2d.py
// `segment_geometry`), which computes one rounded operation at a time in
// the same order.
#pragma once

#include <cuda_runtime.h>

namespace raster2d {

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kPixels = kTileW * kTileH;          // 512
constexpr int kFields = 18;
constexpr int kAccRows = 7;                        // r, g, b, nx, ny, nz, A
constexpr int kAuxRows = 4;                        // log T, D, distortion, median
constexpr float kAlphaCutoff = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.999f;
constexpr float kKzEps = 1e-9f;
constexpr float kZMin = 0.01f;
constexpr float kFilterInvSquare = 2.0f;
constexpr float kLogTEps = -9.210340371976184f;   // log(1e-4)
constexpr float kLogHalf = -0.6931471805599453f;  // log(0.5)

struct Hit {
  float hux, huy, huz, hvx, hvy, hvz;
  float kzs;           // kz, or 1e-9 where |kz| <= 1e-9
  bool kz_ok;
  float u, v, dx, dy;
  bool use3d;          // the ray-splat rho, not the screen low-pass
  float z, raw;        // hit depth; op * exp(-rho/2) before the cap
  float alpha;         // 0 where cut
};

// Surfel fields, in the (N, 18) row order: M1 0-2, M2 3-5, M3 6-8, mx 9,
// my 10, op 11 (rgb 12-14 and the normal 15-17 are not needed here).
__device__ __forceinline__ Hit intersect(float px, float py, float m1x,
                                         float m1y, float m1z, float m2x,
                                         float m2y, float m2z, float m3x,
                                         float m3y, float m3z, float mx,
                                         float my, float op) {
  Hit h;
  h.hux = __fsub_rn(__fmul_rn(px, m3x), m1x);
  h.huy = __fsub_rn(__fmul_rn(px, m3y), m1y);
  h.huz = __fsub_rn(__fmul_rn(px, m3z), m1z);
  h.hvx = __fsub_rn(__fmul_rn(py, m3x), m2x);
  h.hvy = __fsub_rn(__fmul_rn(py, m3y), m2y);
  h.hvz = __fsub_rn(__fmul_rn(py, m3z), m2z);
  const float kx = __fsub_rn(__fmul_rn(h.huy, h.hvz), __fmul_rn(h.huz, h.hvy));
  const float ky = __fsub_rn(__fmul_rn(h.huz, h.hvx), __fmul_rn(h.hux, h.hvz));
  const float kz = __fsub_rn(__fmul_rn(h.hux, h.hvy), __fmul_rn(h.huy, h.hvx));
  h.kz_ok = fabsf(kz) > kKzEps;
  h.kzs = h.kz_ok ? kz : kKzEps;
  h.u = __fdiv_rn(kx, h.kzs);
  h.v = __fdiv_rn(ky, h.kzs);
  const float rho3d = __fadd_rn(__fmul_rn(h.u, h.u), __fmul_rn(h.v, h.v));
  h.dx = __fsub_rn(px, mx);
  h.dy = __fsub_rn(py, my);
  const float rho2d = __fmul_rn(
      kFilterInvSquare,
      __fadd_rn(__fmul_rn(h.dx, h.dx), __fmul_rn(h.dy, h.dy)));
  h.use3d = rho3d <= rho2d;
  const float rho = h.use3d ? rho3d : rho2d;
  h.z = __fadd_rn(__fadd_rn(__fmul_rn(m3x, h.u), __fmul_rn(m3y, h.v)), m3z);
  h.raw = __fmul_rn(op, expf(__fmul_rn(-0.5f, rho)));
  const float alpha = fminf(h.raw, kMaxAlpha);
  h.alpha = (alpha >= kAlphaCutoff && h.z > kZMin) ? alpha : 0.0f;
  return h;
}

}  // namespace raster2d
