// K1 on Hopper: 3DGS front-to-back compositing of each tile's depth-sorted
// instance segment, forward only.
//
// Replaces the Pallas TPU kernel horizongs_tpu/ops/pallas/raster3d.py
// `_fwd_kernel` (launched by `rasterize_fwd`). It computes the same
// function: for pixel p of tile t and the gaussians of the segment
// [tile_starts[t], tile_starts[t+1]) in order,
//   sigma = 0.5*a*dx^2 + b*dx*dy + 0.5*c*dy^2,
//   alpha = min(op * exp(-sigma), 0.999), dropped below 1/255,
//   w     = alpha * T  while log T before the gaussian is > log(1e-4),
// accumulating w * (r, g, b, depth, 1) and log T += log1p(-alpha).
//
// Inputs are read where the binning left them: the (N, 10) per-gaussian
// field matrix [mx, my, a, b, c, op, r, g, b, depth] and the sorted gauss_id
// of every instance, so the TPU wrapper's transposed (16, CAP+2G) instance
// copy is never built. Outputs keep the TPU kernel's layout: acc
// (n_tiles, 5, 1024) holds its rows 6-10 (rgb, depth, alpha) and log_t
// (n_tiles, 2, 1024) holds row 0 the final log T and row 1 i_fin.
//
// i_fin: the number of G = 128 gaussian chunks (counted from the segment
// start) that this tile's walk reached before every pixel had stopped. The
// backward kernel's port reads it to start its reverse walk. (The TPU kernel
// counts chunks walked in pairs from a 128-aligned base, so the two are not
// compared bitwise.) A pixel stops once its log T is at or below log(1e-4);
// its final log T is then the sum up to and including the gaussian that
// stopped it, where the TPU kernel's keeps adding the rest of the chunk pair.
// Both transmittances are below 1e-4 there.
//
// What bounds it: each pixel-gaussian pair costs at least one exp on the
// special-function units (16 per SM per clock) and about 15 FP32
// operations on the CUDA cores (256 per SM per clock, an FMA counting two),
// so the SFU is the limit; bytes (about 40 B per instance read, 28 B per
// pixel written) are far below either. The design keeps the SFUs fed: one
// block of 256 threads per 32x32 tile, four pixels per thread, the segment
// staged 128 gaussians at a time in shared memory (one gaussian per thread
// gathered through gauss_id, broadcast reads in the loop), each pixel
// skipping work once it has stopped and the block leaving as soon as
// __syncthreads_count says no pixel is alive. It computes in plain FP32
// (accurate expf / log1pf): no TPU-style bf16 splitting is needed.

#include <cuda_runtime.h>

namespace {

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

__global__ void __launch_bounds__(kThreads)
raster3d_fwd_kernel(const float* __restrict__ fields,
                    const int* __restrict__ gauss_id,
                    const int* __restrict__ tile_starts,
                    int n_tiles_x,
                    float* __restrict__ acc,
                    float* __restrict__ log_t) {
  __shared__ float s_f[kFields][kChunk];

  const int t = blockIdx.x;
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
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = tid + k * kThreads;
    px[k] = x0 + static_cast<float>(p % kTileW) + 0.5f;
    py[k] = y0 + static_cast<float>(p / kTileW) + 0.5f;
    logT[k] = 0.0f;
    cr[k] = cg[k] = cb[k] = cd[k] = ca[k] = 0.0f;
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
      }
    }

    i_fin = i + 1;
    int alive = 0;
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) alive |= (logT[k] > kLogTEps);
    // also the barrier before the next chunk overwrites s_f
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

}  // namespace

// Launches K1 on `stream` over n_tiles (> 0) blocks and returns
// cudaGetLastError() as an int (0 = launched). All pointers are device
// pointers; fields is (N, 10) float32 row-major, gauss_id (CAP,) int32,
// tile_starts (n_tiles + 1,) int32, acc (n_tiles, 5, 1024) and log_t
// (n_tiles, 2, 1024) float32.
extern "C" int raster3d_fwd(const float* fields, const int* gauss_id,
                            const int* tile_starts, int n_tiles,
                            int n_tiles_x, float* acc, float* log_t,
                            void* stream) {
  raster3d_fwd_kernel<<<n_tiles, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      fields, gauss_id, tile_starts, n_tiles_x, acc, log_t);
  return static_cast<int>(cudaGetLastError());
}
