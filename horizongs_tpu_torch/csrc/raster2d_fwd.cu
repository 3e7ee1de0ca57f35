// K3 on Hopper: 2DGS (surfel) front-to-back compositing of each tile's
// depth-sorted instance segment by ray-splat intersection, forward only.
//
// Replaces the Pallas TPU kernel horizongs_tpu/ops/pallas/raster2d.py
// `_fwd_kernel` (launched by `rasterize2d_fwd`) and its `_intersect`. For
// pixel p of 32x16 tile t and the surfels of the segment
// [tile_starts[t], tile_starts[t+1]) in order, it intersects the pixel's
// ray with the splat (raster2d_common.cuh) and, while log T before the
// surfel is > log(1e-4), adds w = alpha * T to
//   acc: w * (r, g, b, nx, ny, nz), A = sum w;
//   aux: D = sum w * z and the distortion 2 * sum w * (z * A_prev - D_prev)
//        (2DGS eq. 15, A_prev and D_prev the sums before the surfel);
// and log T += log1p(-alpha). The median depth is z of the first surfel
// after which log T < log(0.5); its position in the segment is recorded.
//
// Outputs (n_tiles, ., 512) row-major per tile: acc 7 rows (r, g, b, nx,
// ny, nz, A), aux 4 rows (final log T, D, distortion, median depth), rec 2
// int32 rows (n_contrib, median position or -1). The TPU kernel's aux also
// held A (the alpha row is A), i_fin (no tile-wide restart here) and the
// median's column as a float; those are not written.
//
// Contract: each pixel stops on its own once its log T is at or below
// log(1e-4), as the dense oracle does (the TPU kernel walks pairs of chunks
// until every pixel of the tile stopped and keeps adding log1p(-alpha) to a
// stopped pixel's log T). n_contrib is the number of surfels of the segment
// the pixel walked, the one that stopped it included, or the segment's
// length; K4 (raster2d_bwd.cu) starts each pixel's reverse walk there.
// The median is crossed in log space, which saves an exp per contributing
// pair and is the plain version's test too.
//
// What bounds it: per walked pixel-surfel pair the intersection costs one
// exp (alpha) and two IEEE divisions (u, v; one reciprocal each on the
// special-function units plus Newton steps) and about 50 FP32 operations on
// the CUDA cores (an FMA counting two); per pair that contributes a log
// (log1p) and an exp (T) more and about 30 FP32 operations (seven
// accumulators, A, D, the distortion). With 16 SFU results per SM per clock
// against 256 FP32 operations, the SFU (4 results per contributing pair,
// 2 per other walked pair) and the FP32 work are close; bytes (76 B per
// instance read, 52 B per pixel written) are far below both. The design
// keeps both units fed: one block of 256 threads per 32x16 tile, two pixels
// per thread (rows tid/32 and tid/32 + 8, so a warp's loads and stores are
// one contiguous row), the segment staged 128 surfels (18 rows, 9 KB) at a
// time in shared memory with coalesced reads of the (N, 18) rows through
// gauss_id, broadcast reads in the loop, each pixel skipping work once it
// has stopped, and the block leaving as soon as __syncthreads_count says no
// pixel is alive. FP32 throughout, accurate expf / log1pf, no fast math.

#include <cuda_runtime.h>

#include "raster2d_common.cuh"

namespace {

using namespace raster2d;

constexpr int kBatch = 128;
constexpr int kThreads = 256;
constexpr int kPixPerThread = kPixels / kThreads;  // 2

static_assert(kPixels % kThreads == 0, "pixels must split evenly");

__global__ void __launch_bounds__(kThreads)
raster2d_fwd_kernel(const float* __restrict__ fields,
                    const int* __restrict__ gauss_id,
                    const int* __restrict__ tile_starts,
                    int n_tiles_x,
                    float* __restrict__ acc,
                    float* __restrict__ aux,
                    int* __restrict__ rec) {
  __shared__ float s_f[kFields][kBatch];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int start = tile_starts[t];
  const int count = tile_starts[t + 1] - start;
  const int n_batches = (count + kBatch - 1) / kBatch;
  const float x0 = static_cast<float>((t % n_tiles_x) * kTileW);
  const float y0 = static_cast<float>((t / n_tiles_x) * kTileH);

  float px[kPixPerThread], py[kPixPerThread], logT[kPixPerThread];
  float cr[kPixPerThread], cg[kPixPerThread], cb[kPixPerThread];
  float nx[kPixPerThread], ny[kPixPerThread], nz[kPixPerThread];
  float A[kPixPerThread], D[kPixPerThread], dist[kPixPerThread];
  float med[kPixPerThread];
  int med_at[kPixPerThread];
  // n_contrib goes to device memory at once (the segment's length) and
  // again where the pixel stops, as in K1, so it holds no register
  int* nc_t = rec + static_cast<size_t>(t) * 2 * kPixels;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = tid + k * kThreads;
    px[k] = x0 + static_cast<float>(p % kTileW) + 0.5f;
    py[k] = y0 + static_cast<float>(p / kTileW) + 0.5f;
    logT[k] = 0.0f;
    cr[k] = cg[k] = cb[k] = nx[k] = ny[k] = nz[k] = 0.0f;
    A[k] = D[k] = dist[k] = med[k] = 0.0f;
    med_at[k] = -1;
    nc_t[p] = count;
  }

  for (int i = 0; i < n_batches; ++i) {
    const int base = i * kBatch;
    const int m = min(kBatch, count - base);
    // coalesced staging: consecutive threads read consecutive fields of
    // one surfel's row
    for (int e = tid; e < m * kFields; e += kThreads) {
      const int j = e / kFields;
      const int r = e - j * kFields;
      s_f[r][j] = fields[static_cast<size_t>(gauss_id[start + base + j]) *
                             kFields + r];
    }
    __syncthreads();

    for (int j = 0; j < m; ++j) {
      const float m1x = s_f[0][j], m1y = s_f[1][j], m1z = s_f[2][j];
      const float m2x = s_f[3][j], m2y = s_f[4][j], m2z = s_f[5][j];
      const float m3x = s_f[6][j], m3y = s_f[7][j], m3z = s_f[8][j];
      const float mx = s_f[9][j], my = s_f[10][j], op = s_f[11][j];
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        if (logT[k] <= kLogTEps) continue;
        const Hit h = intersect(px[k], py[k], m1x, m1y, m1z, m2x, m2y, m2z,
                                m3x, m3y, m3z, mx, my, op);
        if (!(h.alpha > 0.0f)) continue;
        const float w = h.alpha * expf(logT[k]);
        cr[k] += w * s_f[12][j];
        cg[k] += w * s_f[13][j];
        cb[k] += w * s_f[14][j];
        nx[k] += w * s_f[15][j];
        ny[k] += w * s_f[16][j];
        nz[k] += w * s_f[17][j];
        const float wz = w * h.z;
        dist[k] += w * (h.z * A[k] - D[k]);
        A[k] += w;
        D[k] += wz;
        logT[k] += log1pf(-h.alpha);
        if (med_at[k] < 0 && logT[k] < kLogHalf) {
          med[k] = h.z;
          med_at[k] = base + j;
        }
        if (logT[k] <= kLogTEps) nc_t[tid + k * kThreads] = base + j + 1;
      }
    }

    int alive = 0;
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) alive |= (logT[k] > kLogTEps);
    // also the barrier before the next batch overwrites s_f
    if (__syncthreads_count(alive) == 0) break;
  }

  float* a_t = acc + static_cast<size_t>(t) * kAccRows * kPixels;
  float* x_t = aux + static_cast<size_t>(t) * kAuxRows * kPixels;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = tid + k * kThreads;
    a_t[0 * kPixels + p] = cr[k];
    a_t[1 * kPixels + p] = cg[k];
    a_t[2 * kPixels + p] = cb[k];
    a_t[3 * kPixels + p] = nx[k];
    a_t[4 * kPixels + p] = ny[k];
    a_t[5 * kPixels + p] = nz[k];
    a_t[6 * kPixels + p] = A[k];
    x_t[0 * kPixels + p] = logT[k];
    x_t[1 * kPixels + p] = D[k];
    x_t[2 * kPixels + p] = 2.0f * dist[k];
    x_t[3 * kPixels + p] = med[k];
    nc_t[kPixels + p] = med_at[k];
  }
}

}  // namespace

// Launches K3 on `stream` over n_tiles (> 0) blocks and returns
// cudaGetLastError() as an int (0 = launched). All pointers are device
// pointers; fields is (N, 18) float32 row-major, gauss_id (CAP,) int32,
// tile_starts (n_tiles + 1,) int32, acc (n_tiles, 7, 512) and aux
// (n_tiles, 4, 512) float32, rec (n_tiles, 2, 512) int32.
extern "C" int raster2d_fwd(const float* fields, const int* gauss_id,
                            const int* tile_starts, int n_tiles,
                            int n_tiles_x, float* acc, float* aux, int* rec,
                            void* stream) {
  raster2d_fwd_kernel<<<n_tiles, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      fields, gauss_id, tile_starts, n_tiles_x, acc, aux, rec);
  return static_cast<int>(cudaGetLastError());
}
