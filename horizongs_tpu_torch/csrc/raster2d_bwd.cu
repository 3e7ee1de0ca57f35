// K4 on Hopper: 2DGS (surfel) backward compositing. For each tile it walks
// the depth-sorted instance segment in reverse and adds every instance's
// field gradient straight into its surfel's row of grad_fields (N, 18).
//
// Replaces the Pallas TPU kernel horizongs_tpu/ops/pallas/raster2d.py
// `_bwd_kernel` (launched by `rasterize2d_bwd`), together with the work of
// `zero_dead_grad_columns` and the wrapper's un-sort and per-gaussian
// reduction (horizongs_tpu/ops/raster_pallas.py `_instance_grads_to_fields`):
// the TPU kernel writes one gradient column per instance because it has no
// atomics; here each block adds its instances' gradients to their surfels'
// rows with atomicAdd. grad_fields starts at zero (the wrapper zeroes it)
// and is written only for surfels some pixel walked with alpha > 0, so a
// surfel no pixel walked keeps exactly zero gradient.
//
// The function (the TPU kernel's algebra, raster2d.py:355-439), for pixel p
// of tile t walking the segment from its n_contrib - 1 (K3's record) down
// to 0, with the intersection recomputed as K3 computed it
// (raster2d_common.cuh) and carrying log T after the surfel, S = dlogT +
// sum over later surfels of w * dL/dw, and the strict suffixes A_suf =
// sum of later w and D_suf = sum of later w * z:
//   log T before = log T after - log1p(-alpha),  w = alpha * T before,
//   A_prev = A - A_suf - w,  D_prev = D - D_suf - w z  (A, D from K3),
//   dL/dw = d_acc . (r, g, b, nx, ny, nz, 1) + dD z
//           + 2 ddist ((z A_prev - D_prev) + (D_suf - z A_suf)),
//   dL/dz = dD w + 2 ddist w (A_prev - A_suf) + dmed [p's median is here],
//   alpha dalpha = w dL/dw - S alpha / (1 - alpha)  (0 where raw alpha
//           >= 0.999), drho = -alpha dalpha / 2, dop = alpha dalpha / op,
//   then through rho (u^2 + v^2 or 2 |p - m|^2), z = M3 . (u, v, 1),
//   (u, v) = (kx, ky) / kz (kz gated at 1e-9) and k = hu x hv to M1, M2,
//   M3, mx, my; rgb and the normal take w * their d_acc rows.
// A_prev and D_prev are differences of sums near 1 and near D; their
// cancellation costs about 1e-7 of A and D, far inside the 2e-4 tolerance
// against the plain version, so they are formed from the totals as the TPU
// kernel does, with no prefix record from K3.
//
// What bounds it: the FP32 units. Per walked pixel-surfel pair K3's
// intersection with its skip tests (nothing in a culled warp step, the
// division-free test otherwise, the exact intersection where the test does
// not reject); per pair that contributes a log (log1p), an exp (T), the
// reciprocals 1/(1 - alpha) and 1/kz, and about 140 FP32 operations
// (dL/dw, dL/dz, the chain through the cross product, 18 partial sums).
// Bytes: 64 B read per pixel, 76 B per instance, one 72 B gradient row per
// surfel.
//
// Design: one block of 256 threads per 32x16 tile; warp w owns an 8x8
// pixel block, two pixels per lane (`warp_pixel`, as K3). Each pixel's ten
// cotangents, K3's A and D and its median's position wait in shared memory
// (a slot per thread and pixel, so a warp's reads hit 32 banks) rather
// than in registers. The tile's walked prefix (the block's max n_contrib)
// is staged 128 surfels at a time, last batch first, with each surfel's
// skip threshold and support box mask (raster2d_common.cuh). For each
// surfel, from the warp's furthest n_contrib down (a warp whose pixels all
// stopped before a surfel does not visit it):
//  * a warp outside the surfel's mask skips it outright;
//  * a pair that `rejected` proves to have alpha = 0 costs no division and
//    no exp; every other pair runs the unchanged exact intersection;
//  * the warp ballots its contributing lanes. None: nothing more. One: that
//    lane adds its 18 values. More: a reduce-scatter (a transposed
//    butterfly over 18 sums, 9 + 5 + 3 + 2 + 1 = 20 shuffles, after which
//    lane `lane_field` holds one field's warp total), and those lanes add
//    their totals into the batch's shared [128][18] accumulator with shared
//    atomics, flagging the surfel as hit.
// After the batch, the block's 256 threads go over the hit surfels' 18
// sums, divide field 11 by op, and add each non-zero sum to grad_fields
// with one atomicAdd, zeroing the accumulator for the next batch. Atomics
// sum in no fixed order, so results vary in the last bits from run to run.

#include <cuda_runtime.h>

#include "raster2d_common.cuh"
#include "warp_common.cuh"

namespace {

using namespace raster2d;
using namespace warp_common;

constexpr int kBatch = 128;
constexpr int kThreads = 256;
constexpr int kPixPerThread = kPixels / kThreads;  // 2
constexpr int kCot = 10;   // d_acc's 7 rows, dD, ddist, dmed per pixel

static_assert(kPixels % kThreads == 0, "pixels must split evenly");
static_assert(kThreads / 32 == kWarps, "one 8x8 pixel block per warp");
static_assert(kBatch <= kThreads, "one thread derives one surfel");

__global__ void __launch_bounds__(kThreads, 3)
raster2d_bwd_kernel(const float* __restrict__ fields,
                    const int* __restrict__ gauss_id,
                    const int* __restrict__ tile_starts,
                    const float* __restrict__ d_acc,
                    const float* __restrict__ d_aux,
                    const float* __restrict__ acc,
                    const float* __restrict__ aux,
                    const int* __restrict__ rec,
                    int n_tiles_x,
                    float* __restrict__ grad_fields) {
  __shared__ float s_f[kBatch][kFields];
  __shared__ float s_sum[kBatch][kFields];   // warp totals per surfel
  __shared__ int s_id[kBatch];
  __shared__ float s_thr[kBatch];
  __shared__ unsigned s_mask[kBatch];
  __shared__ int s_hit[kBatch];
  __shared__ float s_g[kCot][kPixPerThread * kThreads];
  __shared__ float s_tot[2][kPixPerThread * kThreads];   // K3's A and D
  __shared__ int s_med[kPixPerThread * kThreads];        // median position
  __shared__ int s_walk;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned wbit = 1u << warp;
  const int field = lane_field<kFields>(lane);
  const int start = tile_starts[t];
  const float x0 = static_cast<float>((t % n_tiles_x) * kTileW);
  const float y0 = static_cast<float>((t / n_tiles_x) * kTileH);

  if (tid == 0) s_walk = 0;
  for (int e = tid; e < kBatch * kFields; e += kThreads)
    (&s_sum[0][0])[e] = 0.0f;

  // the lane's two pixels share a column and lie 4 rows apart
  const float px = x0 + static_cast<float>(warp_pixel(warp, lane, 0) %
                                           kTileW) + 0.5f;
  const float py0 = y0 + static_cast<float>(warp_pixel(warp, lane, 0) /
                                            kTileW) + 0.5f;
  float logT[kPixPerThread], S[kPixPerThread];
  float A_suf[kPixPerThread], D_suf[kPixPerThread];
  int nc[kPixPerThread];
  int my_walk = 0;
  const size_t t_acc = static_cast<size_t>(t) * kAccRows * kPixels;
  const size_t t_aux = static_cast<size_t>(t) * kAuxRows * kPixels;
  const size_t t_rec = static_cast<size_t>(t) * 2 * kPixels;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = warp_pixel(warp, lane, k);
    const int slot = k * kThreads + tid;
#pragma unroll
    for (int r = 0; r < kAccRows; ++r)
      s_g[r][slot] = d_acc[t_acc + r * kPixels + p];
#pragma unroll
    for (int r = 1; r < kAuxRows; ++r)
      s_g[kAccRows - 1 + r][slot] = d_aux[t_aux + r * kPixels + p];
    S[k] = d_aux[t_aux + 0 * kPixels + p];
    s_tot[0][slot] = acc[t_acc + 6 * kPixels + p];
    s_tot[1][slot] = aux[t_aux + 1 * kPixels + p];
    s_med[slot] = rec[t_rec + kPixels + p];
    logT[k] = aux[t_aux + 0 * kPixels + p];
    nc[k] = rec[t_rec + p];
    A_suf[k] = D_suf[k] = 0.0f;
    my_walk = max(my_walk, nc[k]);
  }
  const int warp_walk = __reduce_max_sync(kFull, my_walk);
  __syncthreads();                       // s_walk initialised
  if (lane == 0) atomicMax(&s_walk, warp_walk);
  __syncthreads();
  const int n_walk = s_walk;             // the tile's walked prefix
  const int n_batches = (n_walk + kBatch - 1) / kBatch;

  for (int i = n_batches - 1; i >= 0; --i) {
    const int base = i * kBatch;
    const int m = min(kBatch, n_walk - base);
    __syncthreads();                     // last batch's sums are added
    if (tid < m) {
      s_id[tid] = gauss_id[start + base + tid];
      s_hit[tid] = 0;
    }
    for (int e = tid; e < m * kFields; e += kThreads) {
      const int j = e / kFields;
      const int r = e - j * kFields;
      s_f[j][r] = fields[static_cast<size_t>(gauss_id[start + base + j]) *
                             kFields + r];
    }
    __syncthreads();
    if (tid < m) {
      const float thr = skip_threshold(s_f[tid][11]);
      s_thr[tid] = thr;
      s_mask[tid] = warp_mask(support_box(s_f[tid], thr), x0, y0);
    }
    __syncthreads();

    for (int j = min(m, warp_walk - base) - 1; j >= 0; --j) {
      if (!(s_mask[j] & wbit)) continue;            // culled for this warp
      const int jj = base + j;
      const float* f = s_f[j];
      const float m1x = f[0], m1y = f[1], m1z = f[2];
      const float m2x = f[3], m2y = f[4], m2z = f[5];
      const float m3x = f[6], m3y = f[7], m3z = f[8];
      const float mx = f[9], my = f[10], op = f[11];
      const float thr = s_thr[j];
      float q[kFields];
#pragma unroll
      for (int r = 0; r < kFields; ++r) q[r] = 0.0f;
      bool any = false;
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        if (jj >= nc[k]) continue;
        const float py = py0 + 4.0f * k;
        const Pre pre = prepare(px, py, m1x, m1y, m1z, m2x, m2y, m2z,
                                m3x, m3y, m3z, mx, my);
        if (rejected(pre, thr)) continue;           // alpha = 0
        const Hit h = finish(pre, m3x, m3y, m3z, op);
        if (!(h.alpha > 0.0f)) continue;            // K3 skipped it too
        const int slot = k * kThreads + tid;
        const float gD = s_g[7][slot], gdist = s_g[8][slot];
        const float alpha = h.alpha, z = h.z;
        const float before = logT[k] - log1pf(-alpha);
        const float w = alpha * expf(before);
        const float wz = w * z;
        const float A_prev = s_tot[0][slot] - A_suf[k] - w;
        const float D_prev = s_tot[1][slot] - D_suf[k] - wz;
        float dw = s_g[6][slot] + gD * z
                   + gdist * 2.0f * ((z * A_prev - D_prev)
                                     + (D_suf[k] - z * A_suf[k]));
#pragma unroll
        for (int r = 0; r < 6; ++r) dw += s_g[r][slot] * f[12 + r];
        float dz = gD * w + gdist * 2.0f * w * (A_prev - A_suf[k]);
        if (jj == s_med[slot]) dz += s_g[9][slot];
        const float wdw = w * dw;
        const float adalpha =
            h.raw < kMaxAlpha ? wdw - S[k] * (alpha / (1.0f - alpha)) : 0.0f;
        const float drho = -0.5f * adalpha;
        const float du = (h.use3d ? 2.0f * h.u * drho : 0.0f) + dz * m3x;
        const float dv = (h.use3d ? 2.0f * h.v * drho : 0.0f) + dz * m3y;
        const float c = 2.0f * kFilterInvSquare;
        const float ddx = h.use3d ? 0.0f : c * h.dx * drho;
        const float ddy = h.use3d ? 0.0f : c * h.dy * drho;
        const float rk = 1.0f / h.kzs;
        const float dkx = du * rk;
        const float dky = dv * rk;
        const float dkz = h.kz_ok ? -(h.u * du + h.v * dv) * rk : 0.0f;
        // k = hu x hv: d_hu = hv x dk, d_hv = dk x hu
        const float dhux = h.hvy * dkz - h.hvz * dky;
        const float dhuy = h.hvz * dkx - h.hvx * dkz;
        const float dhuz = h.hvx * dky - h.hvy * dkx;
        const float dhvx = dky * h.huz - dkz * h.huy;
        const float dhvy = dkz * h.hux - dkx * h.huz;
        const float dhvz = dkx * h.huy - dky * h.hux;
        q[0] -= dhux;
        q[1] -= dhuy;
        q[2] -= dhuz;
        q[3] -= dhvx;
        q[4] -= dhvy;
        q[5] -= dhvz;
        q[6] += px * dhux + py * dhvx + dz * h.u;
        q[7] += px * dhuy + py * dhvy + dz * h.v;
        q[8] += px * dhuz + py * dhvz + dz;
        q[9] -= ddx;
        q[10] -= ddy;
        q[11] += adalpha;                         // / op after the sum
#pragma unroll
        for (int r = 0; r < 6; ++r) q[12 + r] += w * s_g[r][slot];
        S[k] += wdw;
        logT[k] = before;
        A_suf[k] += w;
        D_suf[k] += wz;
        any = true;
      }
      const unsigned ballot = __ballot_sync(kFull, any);
      if (ballot == 0) continue;
      if (lane == 0) s_hit[j] = 1;
      if ((ballot & (ballot - 1)) == 0) {         // one contributing lane
        if (any) {
#pragma unroll
          for (int r = 0; r < kFields; ++r)
            if (q[r] != 0.0f) atomicAdd(&s_sum[j][r], q[r]);
        }
      } else {
        reduce_scatter<kFields, 16>(q, lane);
        if (field >= 0 && q[0] != 0.0f) atomicAdd(&s_sum[j][field], q[0]);
      }
    }
    __syncthreads();

    for (int e = tid; e < m * kFields; e += kThreads) {
      const int j = e / kFields;
      const int r = e - j * kFields;
      if (!s_hit[j]) continue;
      float s = s_sum[j][r];
      s_sum[j][r] = 0.0f;
      if (r == 11) {
        const float op = s_f[j][11];
        s = op > 0.0f ? s / fmaxf(op, 1e-12f) : 0.0f;
      }
      if (s != 0.0f)
        atomicAdd(grad_fields + static_cast<size_t>(s_id[j]) * kFields + r,
                  s);
    }
  }
}

}  // namespace

// Launches K4 on `stream` over n_tiles (> 0) blocks and returns
// cudaGetLastError() as an int (0 = launched). All pointers are device
// pointers: fields (N, 18) float32, gauss_id (CAP,) int32, tile_starts
// (n_tiles + 1,) int32, d_acc and acc (n_tiles, 7, 512), d_aux and aux
// (n_tiles, 4, 512) float32, rec (n_tiles, 2, 512) int32, and grad_fields
// (N, 18) float32, zeroed by the caller and added into.
extern "C" int raster2d_bwd(const float* fields, const int* gauss_id,
                            const int* tile_starts, const float* d_acc,
                            const float* d_aux, const float* acc,
                            const float* aux, const int* rec, int n_tiles,
                            int n_tiles_x, float* grad_fields,
                            void* stream) {
  raster2d_bwd_kernel<<<n_tiles, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      fields, gauss_id, tile_starts, d_acc, d_aux, acc, aux, rec, n_tiles_x,
      grad_fields);
  return static_cast<int>(cudaGetLastError());
}

// K4's blocks resident per SM on the current device, written to *blocks.
// Returns the runtime's error as an int (0 = success). Launches nothing.
extern "C" int raster2d_bwd_occupancy(int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, raster2d_bwd_kernel, kThreads, 0));
}
