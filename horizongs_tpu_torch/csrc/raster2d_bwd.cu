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
// Design: one block of 256 threads per 32x16 tile, two pixels per thread
// (as K3). The tile's walked prefix (the block's max n_contrib) is staged
// 64 surfels at a time in shared memory, last batch first. For each surfel
// every thread adds its pixels' 18 field gradients; a warp that has any
// contributing pixel reduces them with shuffles and its lane 0 stores them
// in shared memory (a warp with none stores zeros and skips the shuffles).
// After the batch, thread j sums surfel j's eight warp partials and adds
// the non-zero ones to grad_fields with atomicAdd. 18 partials x 8 warps x
// 64 surfels is 36 KB, so the batch is 64 (K2's 128 with 18 sums would
// not fit the 48 KB of static shared memory). Atomics sum in no fixed
// order, so results vary in the last bits from run to run.
//
// What bounds it: per walked pixel-surfel pair K3's intersection (an exp,
// two IEEE divisions, about 50 FP32 operations); per pair that contributes
// a log (log1p), an exp (T), the reciprocals 1/(1 - alpha) and 1/kz, and
// about 140 FP32 operations (dL/dw, dL/dz, the chain through the cross
// product, 18 partial sums). So per contributing pair 6 special-function
// results against about 190 FP32 operations: at 16 against 256 per SM and
// clock the two are within 20% of each other. Bytes: 64 B read per pixel
// (d_acc, d_aux, A, log T, D, the two records), 76 B per instance, one
// 72 B gradient row per surfel. The 18-value warp reduction (90 shuffles per
// warp and surfel) is the overhead this simple design pays above the bound.

#include <cuda_runtime.h>

#include "raster2d_common.cuh"

namespace {

using namespace raster2d;

constexpr int kBatch = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPixPerThread = kPixels / kThreads;  // 2
constexpr int kSums = kFields;                     // one per field

static_assert(kPixels % kThreads == 0, "pixels must split evenly");
static_assert(kBatch <= kThreads, "one thread finishes one surfel");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
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
  __shared__ float s_f[kFields][kBatch];
  __shared__ int s_id[kBatch];
  // partial sums per (field, warp, surfel of the batch): 36 KB
  __shared__ float s_part[kSums][kWarps][kBatch];
  __shared__ int s_walk;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int start = tile_starts[t];
  const float x0 = static_cast<float>((t % n_tiles_x) * kTileW);
  const float y0 = static_cast<float>((t / n_tiles_x) * kTileH);

  if (tid == 0) s_walk = 0;

  // thread tid owns pixels tid + k*256, as in K3
  float px[kPixPerThread], py[kPixPerThread];
  float logT[kPixPerThread], S[kPixPerThread];
  float A_suf[kPixPerThread], D_suf[kPixPerThread];
  float A_tot[kPixPerThread], D_tot[kPixPerThread];
  float g_acc[kAccRows][kPixPerThread];
  float g_D[kPixPerThread], g_dist[kPixPerThread], g_med[kPixPerThread];
  int nc[kPixPerThread], med_at[kPixPerThread];
  int my_walk = 0;
  const size_t t_acc = static_cast<size_t>(t) * kAccRows * kPixels;
  const size_t t_aux = static_cast<size_t>(t) * kAuxRows * kPixels;
  const size_t t_rec = static_cast<size_t>(t) * 2 * kPixels;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = tid + k * kThreads;
    px[k] = x0 + static_cast<float>(p % kTileW) + 0.5f;
    py[k] = y0 + static_cast<float>(p / kTileW) + 0.5f;
#pragma unroll
    for (int r = 0; r < kAccRows; ++r)
      g_acc[r][k] = d_acc[t_acc + r * kPixels + p];
    S[k] = d_aux[t_aux + 0 * kPixels + p];
    g_D[k] = d_aux[t_aux + 1 * kPixels + p];
    g_dist[k] = d_aux[t_aux + 2 * kPixels + p];
    g_med[k] = d_aux[t_aux + 3 * kPixels + p];
    A_tot[k] = acc[t_acc + 6 * kPixels + p];
    logT[k] = aux[t_aux + 0 * kPixels + p];
    D_tot[k] = aux[t_aux + 1 * kPixels + p];
    nc[k] = rec[t_rec + p];
    med_at[k] = rec[t_rec + kPixels + p];
    A_suf[k] = D_suf[k] = 0.0f;
    my_walk = max(my_walk, nc[k]);
  }
  my_walk = __reduce_max_sync(0xffffffffu, my_walk);
  __syncthreads();                       // s_walk initialised
  if (lane == 0) atomicMax(&s_walk, my_walk);
  __syncthreads();
  const int n_walk = s_walk;             // the tile's walked prefix
  const int n_batches = (n_walk + kBatch - 1) / kBatch;

  for (int i = n_batches - 1; i >= 0; --i) {
    const int base = i * kBatch;
    const int m = min(kBatch, n_walk - base);
    __syncthreads();                     // last batch's reduction is done
    if (tid < m) s_id[tid] = gauss_id[start + base + tid];
    for (int e = tid; e < m * kFields; e += kThreads) {
      const int j = e / kFields;
      const int r = e - j * kFields;
      s_f[r][j] = fields[static_cast<size_t>(gauss_id[start + base + j]) *
                             kFields + r];
    }
    __syncthreads();

    for (int j = m - 1; j >= 0; --j) {
      const int jj = base + j;
      const float m1x = s_f[0][j], m1y = s_f[1][j], m1z = s_f[2][j];
      const float m2x = s_f[3][j], m2y = s_f[4][j], m2z = s_f[5][j];
      const float m3x = s_f[6][j], m3y = s_f[7][j], m3z = s_f[8][j];
      const float mx = s_f[9][j], my = s_f[10][j], op = s_f[11][j];
      float q[kSums];
#pragma unroll
      for (int r = 0; r < kSums; ++r) q[r] = 0.0f;
      bool any = false;
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        if (jj >= nc[k]) continue;
        const Hit h = intersect(px[k], py[k], m1x, m1y, m1z, m2x, m2y, m2z,
                                m3x, m3y, m3z, mx, my, op);
        if (!(h.alpha > 0.0f)) continue;          // K3 skipped it too
        const float alpha = h.alpha, z = h.z;
        const float before = logT[k] - log1pf(-alpha);
        const float w = alpha * expf(before);
        const float wz = w * z;
        const float A_prev = A_tot[k] - A_suf[k] - w;
        const float D_prev = D_tot[k] - D_suf[k] - wz;
        float dw = g_acc[6][k] + g_D[k] * z
                   + g_dist[k] * 2.0f * ((z * A_prev - D_prev)
                                         + (D_suf[k] - z * A_suf[k]));
#pragma unroll
        for (int r = 0; r < 6; ++r) dw += g_acc[r][k] * s_f[12 + r][j];
        float dz = g_D[k] * w + g_dist[k] * 2.0f * w * (A_prev - A_suf[k]);
        if (jj == med_at[k]) dz += g_med[k];
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
        q[6] += px[k] * dhux + py[k] * dhvx + dz * h.u;
        q[7] += px[k] * dhuy + py[k] * dhvy + dz * h.v;
        q[8] += px[k] * dhuz + py[k] * dhvz + dz;
        q[9] -= ddx;
        q[10] -= ddy;
        q[11] += adalpha;                         // / op after the sum
#pragma unroll
        for (int r = 0; r < 6; ++r) q[12 + r] += w * g_acc[r][k];
        S[k] += wdw;
        logT[k] = before;
        A_suf[k] += w;
        D_suf[k] += wz;
        any = true;
      }
      if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int r = 0; r < kSums; ++r) q[r] = warp_sum(q[r]);
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kSums; ++r) s_part[r][warp][j] = q[r];
      }
    }
    __syncthreads();

    if (tid < m) {
      const int j = tid;
      float* out = grad_fields + static_cast<size_t>(s_id[j]) * kFields;
#pragma unroll
      for (int r = 0; r < kSums; ++r) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += s_part[r][w][j];
        if (r == 11) {
          const float op = s_f[11][j];
          s = op > 0.0f ? s / fmaxf(op, 1e-12f) : 0.0f;
        }
        if (s != 0.0f) atomicAdd(out + r, s);
      }
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
