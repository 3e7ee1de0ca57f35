// K1's walk of one tile, shared by K1 (raster3d_fwd.cu, one block per tile)
// and its persistent form T1 (raster3d_fwd_persistent.cu, a block walks
// many tiles), so both compute every tile bit for bit alike. The function
// and the design are described in raster3d_fwd.cu; the warp map, sigma and
// the skip tests are in raster3d_common.cuh.
#pragma once

#include <cuda_runtime.h>

#include "raster3d_common.cuh"

namespace raster3d {

// The shared memory of one block's walk: two staging buffers, and the
// skip threshold and warp mask of each gaussian of the current chunk.
struct FwdShared {
  Chunk chunk[2];
  float thr[kChunk];
  unsigned mask[kChunk];
};

// Composites tile t (the same for every thread of the block) with the
// block's kThreads threads, staging the segment through s, and writes the
// tile's acc, log T / i_fin and n_contrib. Every read of s is followed by
// a barrier, and every copy into s has landed, before the function
// returns, so the caller may stage into s again at once.
__device__ __forceinline__ void composite_tile(
    const float* __restrict__ fields, const int* __restrict__ gauss_id,
    const int* __restrict__ tile_starts, int n_tiles_x, int t,
    FwdShared& s, float* __restrict__ acc, float* __restrict__ log_t,
    int* __restrict__ n_contrib) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned wbit = 1u << warp;
  const int start = tile_starts[t];
  const int count = tile_starts[t + 1] - start;
  const int n_chunks = (count + kChunk - 1) / kChunk;
  const int* ids = gauss_id + start;
  const float x0 = static_cast<float>((t % n_tiles_x) * kTileW);
  const float y0 = static_cast<float>((t / n_tiles_x) * kTileH);

  if (n_chunks > 0) stage(s.chunk[0], fields, ids, min(kChunk, count), tid);

  // the lane's pixels share a column and lie kRowStep rows apart
  const int p0 = warp_pixel(warp, lane, 0);
  const float px = x0 + static_cast<float>(p0 % kTileW) + 0.5f;
  const float py0 = y0 + static_cast<float>(p0 / kTileW) + 0.5f;
  float logT[kPixPerThread];
  float cr[kPixPerThread], cg[kPixPerThread], cb[kPixPerThread];
  float cd[kPixPerThread], ca[kPixPerThread];
  // n_contrib is written to device memory at once (the segment's length)
  // and again where the pixel stops, not kept in registers: held in four
  // more registers it made ptxas serialise sigma's products, and K1 took
  // about a fifth longer on an H100
  int* n_t = n_contrib + static_cast<size_t>(t) * kPixels;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    logT[k] = 0.0f;
    cr[k] = cg[k] = cb[k] = cd[k] = ca[k] = 0.0f;
    n_t[p0 + kRowStep * k * kTileW] = count;
  }
  bool warp_alive = true;

  int i_fin = 0;
  for (int i = 0; i < n_chunks; ++i) {
    const int b = i & 1;
    const int base = i * kChunk;
    const int m = min(kChunk, count - base);
    // the next chunk's gather goes into the other buffer, whose last
    // readers passed the barrier that ended the previous chunk
    if (i + 1 < n_chunks)
      stage(s.chunk[b ^ 1], fields, ids + base + kChunk,
            min(kChunk, count - base - kChunk), tid);
    else
      cp_async_commit();
    cp_async_wait<1>();                  // this chunk's copies landed
    __syncthreads();                     // everyone's did
    if (tid < m) {
      const float* f = row(s.chunk[b], tid);
      const float thr = skip_threshold(f[5]);
      s.thr[tid] = thr;
      s.mask[tid] = warp_mask(support_box(f, thr), x0, y0);
    }
    __syncthreads();

    for (int j = 0; j < m && warp_alive; ++j) {
      if (!(s.mask[j] & wbit)) continue;            // culled for this warp
      const float* f = row(s.chunk[b], j);
      const float mx = f[0], my = f[1];
      const float ha = 0.5f * f[2], bq = f[3], hc = 0.5f * f[4];
      const float op = f[5];
      const float thr = s.thr[j];
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        if (logT[k] <= kLogTEps) continue;
        const float dx = px - mx;
        const float dy = py0 + static_cast<float>(kRowStep * k) - my;
        const float sigma = sigma_of(ha, bq, hc, dx, dy);
        if (sigma > thr) continue;                  // alpha = 0
        const float alpha = fminf(op * expf(-sigma), kMaxAlpha);
        if (!(alpha >= kAlphaCutoff)) continue;
        const float w = alpha * __expf(logT[k]);
        cr[k] += w * f[6];
        cg[k] += w * f[7];
        cb[k] += w * f[8];
        cd[k] += w * f[9];
        ca[k] += w;
        logT[k] += log1pf(-alpha);
        if (logT[k] <= kLogTEps)
          n_t[p0 + kRowStep * k * kTileW] = base + j + 1;
      }
      bool alive = false;
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) alive |= logT[k] > kLogTEps;
      warp_alive = __any_sync(0xffffffffu, alive);
    }

    i_fin = i + 1;
    int alive = 0;
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) alive |= (logT[k] > kLogTEps);
    // also the barrier before the next chunk's gather overwrites
    // s.chunk[b]; no pixel alive ends this tile's walk
    if (__syncthreads_count(alive) == 0) break;
  }
  cp_async_wait<0>();                    // no copy in flight at the end

  float* a_t = acc + static_cast<size_t>(t) * kAccRows * kPixels;
  float* l_t = log_t + static_cast<size_t>(t) * 2 * kPixels;
  const float fin = static_cast<float>(i_fin);
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = p0 + kRowStep * k * kTileW;
    a_t[0 * kPixels + p] = cr[k];
    a_t[1 * kPixels + p] = cg[k];
    a_t[2 * kPixels + p] = cb[k];
    a_t[3 * kPixels + p] = cd[k];
    a_t[4 * kPixels + p] = ca[k];
    l_t[p] = logT[k];
    l_t[kPixels + p] = fin;
  }
}

}  // namespace raster3d
