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
// Pixel rows start at row0 (0 for a view; a band of the view composited
// on its own passes its first row, so its pixels keep the view's
// coordinates and the intersection rounds as in the view).
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
// What bounds it: the FP32 units. A walked pixel-surfel pair in a warp
// step that the support box does not cull costs the division-free part of
// the intersection and the rejection test (about 32 FP32 operations); a
// pair the test does not reject, the rest of the exact intersection (one
// exp, two IEEE divisions, each a reciprocal on the special-function units
// plus Newton steps, and about 23 FP32 operations more); a pair that
// contributes (about a quarter of the walked ones at 1080p) a log1p and an
// exp (T) more and about 30 FP32 operations. Bytes (76 B per instance
// read, 52 B per pixel written) are far below.
//
// Design: one block of 256 threads per tile; warp w owns an 8x8 pixel
// block, two pixels per lane (`warp_pixel`), so a warp's pixels lie close
// together on screen. Each pixel's colour and normal sums live in shared
// memory (a slot per thread and pixel), which holds the kernel to 64
// registers and 4 blocks (32 warps) per SM: the walk is a chain of
// dependent divisions, exps and logs, and resident warps hide it (on an
// H100 at the 1080p flagship's inputs, the kernel ran 3% slower at 3
// blocks per SM and 18% slower at 2). The segment is staged 128 surfels at a time into one
// of two shared buffers with cp.async (8-byte copies of the 72-byte rows,
// gathered through gauss_id): the next batch's gather is in flight while
// the current batch is walked. Once a batch has landed, thread j computes
// surfel j's skip threshold and support box (raster2d_common.cuh) and the
// mask of the warps whose pixels the box reaches. A warp then
//  * skips a surfel outside its mask outright (no per-pair work at all),
//  * skips, per pair, the divisions and the exp where the division-free
//    test `rejected` proves alpha = 0, and runs the unchanged exact
//    intersection on every other pair, so every record matches,
//  * stops walking once none of its pixels is alive (a vote per surfel it
//    walks), and the block leaves once __syncthreads_count says no pixel of
//    the tile is alive. FP32 throughout, accurate expf / log1pf / logf, no
//    fast math.

#include <cuda_runtime.h>

#include "raster2d_common.cuh"
#include "warp_common.cuh"

namespace {

using namespace raster2d;
using namespace warp_common;

constexpr int kBatch = 128;
constexpr int kThreads = 256;
constexpr int kPixPerThread = kPixels / kThreads;  // 2
constexpr int kChunks = kFields / 2;               // 8-byte copies per row

static_assert(kPixels % kThreads == 0, "pixels must split evenly");
static_assert(kThreads / 32 == kWarps, "one 8x8 pixel block per warp");
static_assert(kBatch <= kThreads, "one thread derives one surfel");

// Starts the gather of the m surfels ids[0..m) into dst and commits it as
// one group (an empty group where m == 0).
__device__ __forceinline__ void stage(float2 (*dst)[kChunks],
                                      const float* __restrict__ fields,
                                      const int* __restrict__ ids, int m,
                                      int tid) {
  for (int e = tid; e < m * kChunks; e += kThreads) {
    const int j = e / kChunks;
    const int c = e - j * kChunks;
    cp_async8(&dst[j][c],
              fields + static_cast<size_t>(ids[j]) * kFields + 2 * c);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads, 4)
raster2d_fwd_kernel(const float* __restrict__ fields,
                    const int* __restrict__ gauss_id,
                    const int* __restrict__ tile_starts,
                    int n_tiles_x, int row0,
                    float* __restrict__ acc,
                    float* __restrict__ aux,
                    int* __restrict__ rec) {
  __shared__ float2 s_f[2][kBatch][kChunks];
  __shared__ float s_thr[kBatch];
  __shared__ unsigned s_mask[kBatch];
  // each pixel's colour and normal sums, a slot per thread and pixel
  __shared__ float s_c[6][kPixPerThread * kThreads];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned wbit = 1u << warp;
  const int start = tile_starts[t];
  const int count = tile_starts[t + 1] - start;
  const int n_batches = (count + kBatch - 1) / kBatch;
  const float x0 = static_cast<float>((t % n_tiles_x) * kTileW);
  const float y0 = static_cast<float>((t / n_tiles_x) * kTileH + row0);

  if (n_batches > 0)
    stage(s_f[0], fields, gauss_id + start, min(kBatch, count), tid);

  // the lane's two pixels share a column and lie 4 rows apart
  const float px = x0 + static_cast<float>(warp_pixel(warp, lane, 0) %
                                           kTileW) + 0.5f;
  const float py0 = y0 + static_cast<float>(warp_pixel(warp, lane, 0) /
                                            kTileW) + 0.5f;
  float logT[kPixPerThread];
  float A[kPixPerThread], D[kPixPerThread], dist[kPixPerThread];
  unsigned crossed = 0;                  // bit k: pixel k found its median
  // n_contrib and the median (depth and position) go to device memory at
  // once (the segment's length, 0 and -1) and again where the pixel stops
  // or crosses T = 0.5, as K1's n_contrib, so they hold no register
  int* nc_t = rec + static_cast<size_t>(t) * 2 * kPixels;
  float* a_t = acc + static_cast<size_t>(t) * kAccRows * kPixels;
  float* x_t = aux + static_cast<size_t>(t) * kAuxRows * kPixels;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = warp_pixel(warp, lane, k);
    logT[k] = 0.0f;
#pragma unroll
    for (int r = 0; r < 6; ++r) s_c[r][k * kThreads + tid] = 0.0f;
    A[k] = D[k] = dist[k] = 0.0f;
    nc_t[p] = count;
    nc_t[kPixels + p] = -1;
    x_t[3 * kPixels + p] = 0.0f;
  }
  bool warp_alive = true;

  for (int i = 0; i < n_batches; ++i) {
    const int b = i & 1;
    const int base = i * kBatch;
    const int m = min(kBatch, count - base);
    // the next batch's gather goes into the other buffer, whose last
    // readers passed the barrier that ended the previous batch
    if (i + 1 < n_batches)
      stage(s_f[b ^ 1], fields, gauss_id + start + base + kBatch,
            min(kBatch, count - base - kBatch), tid);
    else
      cp_async_commit();
    cp_async_wait<1>();                  // this batch's copies landed
    __syncthreads();                     // everyone's did
    if (tid < m) {
      const float* f = reinterpret_cast<const float*>(s_f[b][tid]);
      const float thr = skip_threshold(f[11]);
      s_thr[tid] = thr;
      s_mask[tid] = warp_mask(support_box(f, thr), x0, y0);
    }
    __syncthreads();

    for (int j = 0; j < m && warp_alive; ++j) {
      if (!(s_mask[j] & wbit)) continue;            // culled for this warp
      const float* f = reinterpret_cast<const float*>(s_f[b][j]);
      const float m1x = f[0], m1y = f[1], m1z = f[2];
      const float m2x = f[3], m2y = f[4], m2z = f[5];
      const float m3x = f[6], m3y = f[7], m3z = f[8];
      const float mx = f[9], my = f[10], op = f[11];
      const float thr = s_thr[j];
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        if (logT[k] <= kLogTEps) continue;
        const Pre q = prepare(px, py0 + 4.0f * k, m1x, m1y, m1z, m2x, m2y,
                              m2z, m3x, m3y, m3z, mx, my);
        if (rejected(q, thr)) continue;
        const Hit h = finish(q, m3x, m3y, m3z, op);
        if (!(h.alpha > 0.0f)) continue;
        const float w = h.alpha * expf(logT[k]);
#pragma unroll
        for (int r = 0; r < 6; ++r)
          s_c[r][k * kThreads + tid] += w * f[12 + r];
        const float wz = w * h.z;
        dist[k] += w * (h.z * A[k] - D[k]);
        A[k] += w;
        D[k] += wz;
        logT[k] += log1pf(-h.alpha);
        if (!(crossed & (1u << k)) && logT[k] < kLogHalf) {
          crossed |= 1u << k;
          x_t[3 * kPixels + warp_pixel(warp, lane, k)] = h.z;
          nc_t[kPixels + warp_pixel(warp, lane, k)] = base + j;
        }
        if (logT[k] <= kLogTEps)
          nc_t[warp_pixel(warp, lane, k)] = base + j + 1;
      }
      warp_alive = __any_sync(0xffffffffu, logT[0] > kLogTEps ||
                                               logT[1] > kLogTEps);
    }

    int alive = 0;
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) alive |= (logT[k] > kLogTEps);
    // also the barrier before the next batch's gather overwrites s_f[b]
    if (__syncthreads_count(alive) == 0) break;
  }
  cp_async_wait<0>();                    // no copy in flight at exit

#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = warp_pixel(warp, lane, k);
#pragma unroll
    for (int r = 0; r < 6; ++r)
      a_t[r * kPixels + p] = s_c[r][k * kThreads + tid];
    a_t[6 * kPixels + p] = A[k];
    x_t[0 * kPixels + p] = logT[k];
    x_t[1 * kPixels + p] = D[k];
    x_t[2 * kPixels + p] = 2.0f * dist[k];
  }
}

}  // namespace

// Launches K3 on `stream` over n_tiles (> 0) blocks and returns
// cudaGetLastError() as an int (0 = launched). All pointers are device
// pointers; fields is (N, 18) float32 row-major and 8-byte aligned,
// gauss_id (CAP,) int32, tile_starts (n_tiles + 1,) int32, acc (n_tiles, 7,
// 512) and aux (n_tiles, 4, 512) float32, rec (n_tiles, 2, 512) int32.
extern "C" int raster2d_fwd(const float* fields, const int* gauss_id,
                            const int* tile_starts, int n_tiles,
                            int n_tiles_x, int row0, float* acc, float* aux,
                            int* rec, void* stream) {
  raster2d_fwd_kernel<<<n_tiles, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      fields, gauss_id, tile_starts, n_tiles_x, row0, acc, aux, rec);
  return static_cast<int>(cudaGetLastError());
}

// K3's blocks resident per SM on the current device, written to *blocks.
// Returns the runtime's error as an int (0 = success). Launches nothing.
extern "C" int raster2d_fwd_occupancy(int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, raster2d_fwd_kernel, kThreads, 0));
}
