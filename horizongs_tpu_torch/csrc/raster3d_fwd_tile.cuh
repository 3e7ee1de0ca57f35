// K1's walk of one tile, shared by K1 (raster3d_fwd.cu, one block per tile)
// and its persistent form T1 (raster3d_fwd_persistent.cu, a block walks
// many tiles), so both compute every tile bit for bit alike. The function
// and the design are described in raster3d_fwd.cu.
#pragma once

#include <cuda_runtime.h>

namespace raster3d_tile {

constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kPixels = kTileW * kTileH;
constexpr int kChunk = 128;                       // G
constexpr int kThreads = 256;
constexpr int kPixPerThread = kPixels / kThreads;  // 4
constexpr int kFields = 10;
constexpr int kAccRows = 5;
constexpr float kAlphaCutoff = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.999f;
constexpr float kLogTEps = -9.210340371976184f;   // log(1e-4)

static_assert(kPixels % kThreads == 0, "pixels must split evenly");
static_assert(kChunk <= kThreads, "one thread stages one gaussian");

// Composites tile t (the same for every thread of the block) with the
// block's kThreads threads, staging the segment through s_f, and writes
// the tile's acc, log T / i_fin and n_contrib. Every read of s_f is
// followed by a barrier before the function returns, so the caller may
// stage into s_f again at once.
__device__ __forceinline__ void composite_tile(
    const float* __restrict__ fields, const int* __restrict__ gauss_id,
    const int* __restrict__ tile_starts, int n_tiles_x, int t,
    float (&s_f)[kFields][kChunk], float* __restrict__ acc,
    float* __restrict__ log_t, int* __restrict__ n_contrib) {
  const int tid = threadIdx.x;
  const int start = tile_starts[t];
  const int count = tile_starts[t + 1] - start;
  const int n_chunks = (count + kChunk - 1) / kChunk;
  const float x0 = static_cast<float>((t % n_tiles_x) * kTileW);
  const float y0 = static_cast<float>((t / n_tiles_x) * kTileH);

  // thread tid owns pixels tid + k*256: rows tid/32 + 8k, column tid%32,
  // so a warp's loads and stores are one contiguous row
  float px[kPixPerThread], py[kPixPerThread], logT[kPixPerThread];
  float cr[kPixPerThread], cg[kPixPerThread], cb[kPixPerThread];
  float cd[kPixPerThread], ca[kPixPerThread];
  // n_contrib is written to device memory at once (the segment's length)
  // and again where the pixel stops, not kept in registers: held in four
  // more registers it made ptxas serialise sigma's products, and K1 took
  // about a fifth longer on an H100
  int* n_t = n_contrib + static_cast<size_t>(t) * kPixels;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = tid + k * kThreads;
    px[k] = x0 + static_cast<float>(p % kTileW) + 0.5f;
    py[k] = y0 + static_cast<float>(p / kTileW) + 0.5f;
    logT[k] = 0.0f;
    cr[k] = cg[k] = cb[k] = cd[k] = ca[k] = 0.0f;
    n_t[p] = count;
  }

  int i_fin = 0;
  for (int i = 0; i < n_chunks; ++i) {
    const int base = i * kChunk;
    const int m = min(kChunk, count - base);
    if (tid < m) {
      const float* f =
          fields + static_cast<size_t>(gauss_id[start + base + tid]) * kFields;
#pragma unroll
      for (int r = 0; r < kFields; ++r) s_f[r][tid] = f[r];
    }
    __syncthreads();

    for (int j = 0; j < m; ++j) {
      const float mx = s_f[0][j], my = s_f[1][j];
      const float a = s_f[2][j], b = s_f[3][j], c = s_f[4][j];
      const float op = s_f[5][j];
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        if (logT[k] <= kLogTEps) continue;
        const float dx = px[k] - mx;
        const float dy = py[k] - my;
        // rounded products and sums, no FMA contraction: sigma and so the
        // alpha cutoff fall bit for bit as in the plain version
        const float sigma = __fadd_rn(
            __fadd_rn(__fmul_rn(__fmul_rn(0.5f * a, dx), dx),
                      __fmul_rn(__fmul_rn(b, dx), dy)),
            __fmul_rn(__fmul_rn(0.5f * c, dy), dy));
        const float alpha = fminf(op * expf(-sigma), kMaxAlpha);
        if (!(alpha >= kAlphaCutoff)) continue;
        const float w = alpha * expf(logT[k]);
        cr[k] += w * s_f[6][j];
        cg[k] += w * s_f[7][j];
        cb[k] += w * s_f[8][j];
        cd[k] += w * s_f[9][j];
        ca[k] += w;
        logT[k] += log1pf(-alpha);
        if (logT[k] <= kLogTEps) n_t[tid + k * kThreads] = base + j + 1;
      }
    }

    i_fin = i + 1;
    int alive = 0;
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) alive |= (logT[k] > kLogTEps);
    // also the barrier before the next chunk overwrites s_f; no pixel
    // alive ends this tile's walk
    if (__syncthreads_count(alive) == 0) break;
  }

  float* a_t = acc + static_cast<size_t>(t) * kAccRows * kPixels;
  float* l_t = log_t + static_cast<size_t>(t) * 2 * kPixels;
  const float fin = static_cast<float>(i_fin);
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = tid + k * kThreads;
    a_t[0 * kPixels + p] = cr[k];
    a_t[1 * kPixels + p] = cg[k];
    a_t[2 * kPixels + p] = cb[k];
    a_t[3 * kPixels + p] = cd[k];
    a_t[4 * kPixels + p] = ca[k];
    l_t[p] = logT[k];
    l_t[kPixels + p] = fin;
  }
}

}  // namespace raster3d_tile
