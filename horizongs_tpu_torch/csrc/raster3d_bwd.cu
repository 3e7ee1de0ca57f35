// K2 on Hopper: 3DGS backward compositing. For each tile it walks the
// depth-sorted instance segment in reverse and adds every instance's field
// gradient straight into its gaussian's row of grad_fields (N, 10).
//
// Replaces the Pallas TPU kernel horizongs_tpu/ops/pallas/raster3d.py
// `_bwd_kernel` (launched by `rasterize_bwd`), together with the work of
// `zero_dead_grad_columns` and the wrapper's un-sort and per-gaussian
// reduction (horizongs_tpu/ops/raster_pallas.py `_instance_grads_to_fields`):
// the TPU kernel writes one gradient column per instance because it has no
// atomics; here each block adds its instances' gradients to their
// gaussians' rows with atomicAdd. grad_fields starts at zero (the wrapper
// zeroes it) and is written only for gaussians to which some walked pixel
// gives alpha >= 1/255, so a gaussian no pixel walked keeps exactly zero
// gradient.
//
// The function, for pixel p of tile t, walking the segment from its
// n_contrib - 1 (K1's per-pixel record of how far it walked) down to 0:
//   alpha    = min(op * exp(-sigma), 0.999), dropped below 1/255 (as K1),
//   log T_before = log T_after - log1p(-alpha)  (from K1's final log T),
//   w        = alpha * T_before (every gaussian below n_contrib was
//              walked with log T_before > log 1e-4 in the forward),
//   dL/dw    = d_acc . [r, g, b, depth, 1],
//   S_after  = dlogT + sum over later gaussians of w * dL/dw,
//   dsigma   = S_after * alpha / (1 - alpha) - w * dL/dw  (= -alpha dalpha,
//              with dalpha = T dL/dw - S_after / (1 - alpha)); zero where
//              raw alpha >= 0.999 or alpha < 1/255,
// and per gaussian, summed over the tile's pixels (dx = px - mx):
//   d mx = -(a Sum dsigma dx + b Sum dsigma dy),
//   d my = -(b Sum dsigma dx + c Sum dsigma dy),
//   d a = Sum dsigma dx^2 / 2, d b = Sum dsigma dx dy (b the off-diagonal),
//   d c = Sum dsigma dy^2 / 2, d op = -Sum dsigma / op,
//   d (r, g, b, depth) = Sum w * d_acc rows.
// sigma is rounded product by product as in K1 (raster3d_common.cuh), so
// the 1/255 and 0.999 cuts fall where the forward's did.
//
// What bounds it, given the skip tests (raster3d_common.cuh): nothing for
// a walked pixel-gaussian pair in a warp step the support box culls; for
// any other walked pair sigma and the rejection test (about 12 FP32
// operations); for a pair the test does not reject, the exp of alpha on
// the special-function units (16 results per SM per clock) and a few FP32
// operations; per pair that contributes (alpha >= 1/255) a log (log1p),
// an exp (T) and a reciprocal (alpha / (1 - alpha)) more on the SFU and
// about 40 FP32 operations (dL/dw, w, dsigma, ten partial sums; an FMA
// counting two). Bytes: 32 B read per pixel (d_acc 5 rows, dlogT, log T,
// n_contrib), 44 B per instance (fields row and gauss_id) and one 40 B
// gradient row per gaussian.
//
// Design: one block of 512 threads per 32x32 tile; warp w owns an 8x8
// pixel block, two pixels per lane (`warp_pixel`, as K1). Each pixel's
// five cotangents wait in shared memory (a slot per thread and pixel, so a
// warp's reads hit 32 banks) rather than in registers. The tile's walked
// prefix (the block's max n_contrib) is staged 128 gaussians at a time,
// last chunk first, into one of two shared buffers with cp.async (8-byte
// copies of the 40-byte rows): the next (earlier) chunk's gather is in
// flight while the current one is walked. Thread j then computes gaussian
// j's skip threshold and the mask of the warps its support box reaches.
// For each gaussian, from the warp's own furthest n_contrib down (a warp
// whose pixels all stopped before a gaussian does not visit it):
//  * a warp outside the gaussian's mask skips it outright;
//  * a pair whose rounded sigma exceeds the threshold (alpha = 0, proved in
//    raster3d_common.cuh) costs no exp; every other pair runs the
//    unchanged arithmetic;
//  * the warp ballots its contributing lanes. None: nothing more. One: that
//    lane adds its ten values into the chunk's shared [128][10]
//    accumulator with shared atomics. More: a reduce-scatter (a transposed
//    butterfly over the ten sums, 5 + 3 + 2 + 1 + 1 = 12 shuffles, after
//    which lane `lane_field` holds one sum's warp total), and those lanes
//    add their totals with shared atomics; either way the gaussian is
//    flagged as hit.
// After the chunk, thread j forms hit gaussian j's ten gradients from its
// sums, adds the non-zero ones to grad_fields with atomicAdd and zeroes the
// sums for the next chunk. Atomics sum in no fixed order, so results vary
// in the last bits from run to run. The exp of alpha and the log1p of the
// walk are the accurate expf / log1pf, as in K1; the weight's T (__expf)
// and alpha / (1 - alpha) (__fdividef, 2 ulp) are fast: they feed the
// gradient sums only, held to 2e-4 of their max.
//
// T2, the cost attribution of K2 (the counterpart of the Pallas tool
// tools/profile_bwd_variants.py `make_bwd`, whose stripped kernels are
// timed beside the full one), is this source built with -DK2_VARIANT=<n>;
// the default build (no define) is K2 and contains none of it:
//   1 no_atomic  the gradients are formed but not added to grad_fields
//                (the TPU tool's no_write);
//   2 no_color   dL/dw takes the alpha row only and the four colour/depth
//                sums are not formed (the counterpart of no_dots);
//   3 no_reduce  no ballot, no reduce-scatter and no shared accumulator,
//                so no per-gaussian sums and no atomics (no_scan's
//                cross-lane work);
//   4 walk_only  the walk with its skip tests, alpha and the log T walk
//                only.
// The compiler deletes work whose result is never stored, so a variant that
// drops a store keeps its result alive with a store guarded by `sentinel`,
// a runtime argument it cannot predict (the wrapper passes NaN, which no
// sum equals, so the store never happens). The variant's entry point is
// raster3d_bwd_variant, with sentinel before the stream.
// A variant that needs fewer registers or less shared memory than K2 would
// keep more blocks resident per SM, and the time it saves would then mix
// the work it leaves out with the latency that more resident warps hide.
// So every build exports raster3d_bwd_occupancy, and the variant's launch
// reserves the dynamic shared memory (unused) that holds it to K2's blocks
// per SM.

#include <cuda_runtime.h>

#include "raster3d_common.cuh"

#ifndef K2_VARIANT
#define K2_VARIANT 0
#endif

#if K2_VARIANT
#define K2_SENTINEL_PARAM , float sentinel
// a variant leaves some of K2's values unused on purpose
#pragma nv_diag_suppress 177
#pragma nv_diag_suppress 550
#else
#define K2_SENTINEL_PARAM
#endif

namespace {

using namespace raster3d;

constexpr int kSums = 10;
constexpr int kCot = kAccRows;   // d_acc's rows per pixel
// the sums a gaussian's gradient is formed from: no_color drops the four
// w * d_acc colour/depth rows
constexpr int kUsedSums = K2_VARIANT == 2 ? 6 : kSums;

// Starts chunk i's gather (of the walked prefix of n_walk instances ids)
// into buffer i % 2 and stores its gaussian ids beside it.
__device__ __forceinline__ void gather(Chunk (&s_f)[2],
                                       int (&s_id)[2][kChunk],
                                       const float* __restrict__ fields,
                                       const int* __restrict__ ids, int i,
                                       int n_walk, int tid) {
  const int base = i * kChunk;
  const int m = min(kChunk, n_walk - base);
  if (tid < m) s_id[i & 1][tid] = ids[base + tid];
  stage(s_f[i & 1], fields, ids + base, m, tid);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
raster3d_bwd_kernel(const float* __restrict__ fields,
                    const int* __restrict__ gauss_id,
                    const int* __restrict__ tile_starts,
                    const float* __restrict__ d_acc,
                    const float* __restrict__ d_logT,
                    const float* __restrict__ log_t,
                    const int* __restrict__ n_contrib,
                    int n_tiles_x,
                    float* __restrict__ grad_fields K2_SENTINEL_PARAM) {
  __shared__ Chunk s_f[2];
  __shared__ int s_id[2][kChunk];
  __shared__ float s_thr[kChunk];
  __shared__ unsigned s_mask[kChunk];
  __shared__ int s_hit[kChunk];
  __shared__ float s_sum[kChunk][kSums];     // warp totals per gaussian
  __shared__ float s_g[kCot][kPixPerThread * kThreads];
  __shared__ int s_walk;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned wbit = 1u << warp;
  const int start = tile_starts[t];
  const int* ids = gauss_id + start;
  const float x0 = static_cast<float>((t % n_tiles_x) * kTileW);
  const float y0 = static_cast<float>((t / n_tiles_x) * kTileH);

  if (tid == 0) s_walk = 0;
  for (int e = tid; e < kChunk * kSums; e += kThreads)
    (&s_sum[0][0])[e] = 0.0f;

  // the lane's pixels share a column and lie kRowStep rows apart
  const int p0 = warp_pixel(warp, lane, 0);
  const float px = x0 + static_cast<float>(p0 % kTileW) + 0.5f;
  const float py0 = y0 + static_cast<float>(p0 / kTileW) + 0.5f;
  float logT[kPixPerThread], S[kPixPerThread];
  int nc[kPixPerThread];
  int my_walk = 0;
#if K2_VARIANT == 3 || K2_VARIANT == 4
  float keep = 0.0f;                     // the result kept alive
#endif
  const size_t pix0 = static_cast<size_t>(t) * kPixels;
  const float* g_t = d_acc + static_cast<size_t>(t) * kAccRows * kPixels;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = p0 + kRowStep * k * kTileW;
#pragma unroll
    for (int r = 0; r < kCot; ++r)
      s_g[r][k * kThreads + tid] = g_t[r * kPixels + p];
    logT[k] = log_t[pix0 + p];
    S[k] = d_logT[pix0 + p];
    nc[k] = n_contrib[pix0 + p];
    my_walk = max(my_walk, nc[k]);
  }
  const int warp_walk = __reduce_max_sync(kFull, my_walk);
  __syncthreads();                       // s_walk initialised
  if (lane == 0) atomicMax(&s_walk, warp_walk);
  __syncthreads();
  const int n_walk = s_walk;             // the tile's walked prefix
  const int n_chunks = (n_walk + kChunk - 1) / kChunk;

  if (n_chunks > 0)
    gather(s_f, s_id, fields, ids, n_chunks - 1, n_walk, tid);

  for (int i = n_chunks - 1; i >= 0; --i) {
    const int b = i & 1;
    const int base = i * kChunk;
    const int m = min(kChunk, n_walk - base);
    cp_async_wait<0>();                  // this chunk's copies landed
    __syncthreads();                     // everyone's did, and the last
                                         // chunk's sums are added
    // the earlier chunk's gather goes into the other buffer, whose last
    // readers (the chunk before this one) passed that barrier
    if (i > 0) gather(s_f, s_id, fields, ids, i - 1, n_walk, tid);
    if (tid < m) {
      const float* f = row(s_f[b], tid);
      const float thr = skip_threshold(f[5]);
      s_thr[tid] = thr;
      s_mask[tid] = warp_mask(support_box(f, thr), x0, y0);
      s_hit[tid] = 0;
    }
    __syncthreads();

    for (int j = min(m, warp_walk - base) - 1; j >= 0; --j) {
      if (!(s_mask[j] & wbit)) continue;            // culled for this warp
      const int jj = base + j;
      const float* f = row(s_f[b], j);
      const float mx = f[0], my = f[1];
      const float ha = 0.5f * f[2], bq = f[3], hc = 0.5f * f[4];
      const float op = f[5];
      const float thr = s_thr[j];
      // s0, sx, sy, sxx, sxy, syy, then w * d_acc rows r, g, b, depth
      float q[kSums];
#pragma unroll
      for (int r = 0; r < kSums; ++r) q[r] = 0.0f;
      bool any = false;
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        if (jj >= nc[k]) continue;
        const float dx = px - mx;
        const float dy = py0 + static_cast<float>(kRowStep * k) - my;
        const float sigma = sigma_of(ha, bq, hc, dx, dy);
        if (sigma > thr) continue;                  // alpha = 0
        const float raw = op * expf(-sigma);
        const float alpha = fminf(raw, kMaxAlpha);
        if (!(alpha >= kAlphaCutoff)) continue;     // K1 skipped it too
        const float before = logT[k] - log1pf(-alpha);
#if K2_VARIANT == 4
        logT[k] = before;
#else
        const int slot = k * kThreads + tid;
        const float w = alpha * __expf(before);
#if K2_VARIANT == 2
        const float dw = s_g[4][slot];
#else
        const float dw = s_g[0][slot] * f[6] + s_g[1][slot] * f[7]
                         + s_g[2][slot] * f[8] + s_g[3][slot] * f[9]
                         + s_g[4][slot];
#endif
        const float wdw = w * dw;
        const float dsig =
            raw < kMaxAlpha ? S[k] * __fdividef(alpha, 1.0f - alpha) - wdw
                            : 0.0f;
        const float u = dsig * dx;
        const float v = dsig * dy;
        q[0] += dsig;
        q[1] += u;
        q[2] += v;
        q[3] += u * dx;
        q[4] += u * dy;
        q[5] += v * dy;
#if K2_VARIANT != 2
        q[6] += w * s_g[0][slot];
        q[7] += w * s_g[1][slot];
        q[8] += w * s_g[2][slot];
        q[9] += w * s_g[3][slot];
#endif
        S[k] += wdw;
        logT[k] = before;
        any = true;
#endif  // K2_VARIANT == 4
      }
#if K2_VARIANT == 3
#pragma unroll
      for (int r = 0; r < kSums; ++r) keep += q[r];
#elif K2_VARIANT != 4
      const unsigned ballot = __ballot_sync(kFull, any);
      if (ballot == 0) continue;
      if (lane == 0) s_hit[j] = 1;
      if ((ballot & (ballot - 1)) == 0) {           // one contributing lane
        if (any) {
#pragma unroll
          for (int r = 0; r < kUsedSums; ++r)
            if (q[r] != 0.0f) atomicAdd(&s_sum[j][r], q[r]);
        }
      } else {
        reduce_scatter<kUsedSums, 16>(q, lane);
        const int field = lane_field<kUsedSums>(lane);
        if (field >= 0 && q[0] != 0.0f) atomicAdd(&s_sum[j][field], q[0]);
      }
#endif
    }
#if K2_VARIANT != 3 && K2_VARIANT != 4
    __syncthreads();                     // the chunk's sums are complete

    if (tid < m && s_hit[tid]) {
      const int j = tid;
      float s[kSums];
#pragma unroll
      for (int r = 0; r < kSums; ++r) {
        s[r] = r < kUsedSums ? s_sum[j][r] : 0.0f;
        if (r < kUsedSums) s_sum[j][r] = 0.0f;
      }
      const float* f = row(s_f[b], j);
      const float a = f[2], bq = f[3], c = f[4];
      const float op = f[5];
      float g[kFields];
      g[0] = -(a * s[1] + bq * s[2]);
      g[1] = -(bq * s[1] + c * s[2]);
      g[2] = 0.5f * s[3];
      g[3] = s[4];
      g[4] = 0.5f * s[5];
      g[5] = op > 0.0f ? -s[0] / fmaxf(op, 1e-12f) : 0.0f;
      g[6] = s[6];
      g[7] = s[7];
      g[8] = s[8];
      g[9] = s[9];
      float* out = grad_fields + static_cast<size_t>(s_id[b][j]) * kFields;
#if K2_VARIANT == 1
      float sum = 0.0f;
#pragma unroll
      for (int r = 0; r < kFields; ++r) sum += g[r];
      if (sum == sentinel) out[0] = sum;
#else
#pragma unroll
      for (int r = 0; r < kFields; ++r)
        if (g[r] != 0.0f) atomicAdd(out + r, g[r]);
#endif
    }
#endif  // K2_VARIANT != 3 && K2_VARIANT != 4
  }
#if K2_VARIANT == 4
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) keep += logT[k];
#endif
#if K2_VARIANT == 3 || K2_VARIANT == 4
  if (keep == sentinel) grad_fields[0] = keep;
#endif
}

}  // namespace

// Launches K2 on `stream` over n_tiles (> 0) blocks and returns
// cudaGetLastError() as an int (0 = launched). All pointers are device
// pointers: fields (N, 10) float32, 8-byte aligned, gauss_id (CAP,) int32,
// tile_starts (n_tiles + 1,) int32, d_acc (n_tiles, 5, 1024), d_logT and
// log_t (n_tiles, 1024) float32, n_contrib (n_tiles, 1024) int32, and
// grad_fields (N, 10) float32, zeroed by the caller and added into.
#if K2_VARIANT == 0
extern "C" int raster3d_bwd(const float* fields, const int* gauss_id,
                            const int* tile_starts, const float* d_acc,
                            const float* d_logT, const float* log_t,
                            const int* n_contrib, int n_tiles,
                            int n_tiles_x, float* grad_fields,
                            void* stream) {
  raster3d_bwd_kernel<<<n_tiles, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      fields, gauss_id, tile_starts, d_acc, d_logT, log_t, n_contrib,
      n_tiles_x, grad_fields);
  return static_cast<int>(cudaGetLastError());
}
#else
// The T2 variant K2_VARIANT: K2's arguments, then `sentinel` (see the
// header comment) and `pad`, the bytes of dynamic shared memory each block
// reserves and leaves unused (raster3d_bwd_occupancy), then the stream.
extern "C" int raster3d_bwd_variant(const float* fields, const int* gauss_id,
                                    const int* tile_starts,
                                    const float* d_acc, const float* d_logT,
                                    const float* log_t, const int* n_contrib,
                                    int n_tiles, int n_tiles_x,
                                    float* grad_fields, float sentinel,
                                    int pad, void* stream) {
  if (pad > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        raster3d_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        pad);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  raster3d_bwd_kernel<<<n_tiles, kThreads, pad,
                        static_cast<cudaStream_t>(stream)>>>(
      fields, gauss_id, tile_starts, d_acc, d_logT, log_t, n_contrib,
      n_tiles_x, grad_fields, sentinel);
  return static_cast<int>(cudaGetLastError());
}
#endif

// The blocks of this build's kernel (K2, or the T2 variant) resident per SM
// on the current device, written to *blocks, with *pad bytes of dynamic
// shared memory per block: the least pad that holds it to at most `target`
// blocks per SM, or 0 when target <= 0. Returns the first failing runtime
// call's error as an int (0 = success). Launches nothing.
extern "C" int raster3d_bwd_occupancy(int target, int* pad, int* blocks) {
  int device = 0, optin = 0;
  cudaFuncAttributes attr{};
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, raster3d_bwd_kernel);
  int lo = 0;
  int hi = target > 0 ? optin - static_cast<int>(attr.sharedSizeBytes) : 0;
  if (err == cudaSuccess && hi > 0)
    err = cudaFuncSetAttribute(
        raster3d_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, hi);
  // blocks per SM fall as the pad grows: the least pad with <= target
  while (err == cudaSuccess && lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, raster3d_bwd_kernel, kThreads, mid);
    if (n <= target) hi = mid; else lo = mid + 1;
  }
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, raster3d_bwd_kernel, kThreads, lo);
  *pad = lo;
  return static_cast<int>(err);
}
