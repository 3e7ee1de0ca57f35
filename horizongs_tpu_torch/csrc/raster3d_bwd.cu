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
// zeroes it) and is written only for gaussians some pixel walked, so a
// gaussian no pixel walked keeps exactly zero gradient.
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
// sigma is rounded product by product (__fmul_rn / __fadd_rn) as in K1,
// so the 1/255 and 0.999 cuts fall where the forward's did.
//
// Design: one block of 256 threads per 32x32 tile, four pixels per thread
// (as K1). The tile's walked prefix (the block's max n_contrib) is staged
// 128 gaussians at a time in shared memory, last chunk first. For each
// gaussian every thread adds its pixels' ten partial sums; a warp that has
// any contributing pixel reduces them with shuffles and its lane 0 stores
// them in shared memory (a warp with none stores zeros and skips the
// shuffles). After the chunk, thread j sums gaussian j's eight warp
// partials, forms the ten field gradients and adds the non-zero ones to
// grad_fields with atomicAdd. Atomics sum in no fixed order, so results
// vary in the last bits from run to run.
//
// What bounds it: per walked pixel-gaussian pair one exp on the special-
// function units (alpha; 16 results per SM per clock) and about 14 FP32
// operations (sigma as K1); per pair that contributes (alpha >= 1/255) a
// log (log1p), an exp (T) and a reciprocal (alpha / (1 - alpha)) more on
// the SFU and about 40 FP32 operations more (dL/dw, w, dsigma, ten
// partial sums; an FMA counting two). So the SFU bounds it: 4 results per
// contributing pair. Bytes: 32 B read per pixel (d_acc 5 rows, dlogT,
// log T, n_contrib), 44 B per instance (fields row and gauss_id) and one
// 40 B gradient row per gaussian; the atomics add at most 40 B per
// instance. The ten-value warp reduction (50 shuffles per warp and
// gaussian) is the overhead this simple design pays above the bound.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kPixels = kTileW * kTileH;
constexpr int kChunk = 128;                       // G
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPixPerThread = kPixels / kThreads;  // 4
constexpr int kFields = 10;
constexpr int kAccRows = 5;
constexpr int kSums = 10;
constexpr float kAlphaCutoff = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.999f;

static_assert(kPixels % kThreads == 0, "pixels must split evenly");
static_assert(kChunk <= kThreads, "one thread stages one gaussian");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
raster3d_bwd_kernel(const float* __restrict__ fields,
                    const int* __restrict__ gauss_id,
                    const int* __restrict__ tile_starts,
                    const float* __restrict__ d_acc,
                    const float* __restrict__ d_logT,
                    const float* __restrict__ log_t,
                    const int* __restrict__ n_contrib,
                    int n_tiles_x,
                    float* __restrict__ grad_fields) {
  __shared__ float s_f[kFields][kChunk];
  __shared__ int s_id[kChunk];
  // partial sums per (sum, warp, gaussian of the chunk): 40 KB
  __shared__ float s_part[kSums][kWarps][kChunk];
  __shared__ int s_walk;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int start = tile_starts[t];
  const float x0 = static_cast<float>((t % n_tiles_x) * kTileW);
  const float y0 = static_cast<float>((t / n_tiles_x) * kTileH);

  if (tid == 0) s_walk = 0;

  // thread tid owns pixels tid + k*256, as in K1
  float px[kPixPerThread], py[kPixPerThread];
  float logT[kPixPerThread], S[kPixPerThread];
  float gr[kPixPerThread], gg[kPixPerThread], gb[kPixPerThread];
  float gd[kPixPerThread], ga[kPixPerThread];
  int nc[kPixPerThread];
  int my_walk = 0;
  const size_t pix0 = static_cast<size_t>(t) * kPixels;
  const float* g_t = d_acc + static_cast<size_t>(t) * kAccRows * kPixels;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = tid + k * kThreads;
    px[k] = x0 + static_cast<float>(p % kTileW) + 0.5f;
    py[k] = y0 + static_cast<float>(p / kTileW) + 0.5f;
    logT[k] = log_t[pix0 + p];
    S[k] = d_logT[pix0 + p];
    gr[k] = g_t[0 * kPixels + p];
    gg[k] = g_t[1 * kPixels + p];
    gb[k] = g_t[2 * kPixels + p];
    gd[k] = g_t[3 * kPixels + p];
    ga[k] = g_t[4 * kPixels + p];
    nc[k] = n_contrib[pix0 + p];
    my_walk = max(my_walk, nc[k]);
  }
  my_walk = __reduce_max_sync(0xffffffffu, my_walk);
  __syncthreads();                       // s_walk initialised
  if (lane == 0) atomicMax(&s_walk, my_walk);
  __syncthreads();
  const int n_walk = s_walk;             // the tile's walked prefix
  const int n_chunks = (n_walk + kChunk - 1) / kChunk;

  for (int i = n_chunks - 1; i >= 0; --i) {
    const int base = i * kChunk;
    const int m = min(kChunk, n_walk - base);
    __syncthreads();                     // last chunk's reduction is done
    if (tid < m) {
      const int id = gauss_id[start + base + tid];
      s_id[tid] = id;
      const float* f = fields + static_cast<size_t>(id) * kFields;
#pragma unroll
      for (int r = 0; r < kFields; ++r) s_f[r][tid] = f[r];
    }
    __syncthreads();

    for (int j = m - 1; j >= 0; --j) {
      const int jj = base + j;
      const float mx = s_f[0][j], my = s_f[1][j];
      const float a = s_f[2][j], b = s_f[3][j], c = s_f[4][j];
      const float op = s_f[5][j];
      const float cr = s_f[6][j], cg = s_f[7][j], cb = s_f[8][j];
      const float cd = s_f[9][j];
      // s0, sx, sy, sxx, sxy, syy, then w * d_acc rows r, g, b, depth
      float q[kSums];
#pragma unroll
      for (int r = 0; r < kSums; ++r) q[r] = 0.0f;
      bool any = false;
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        if (jj >= nc[k]) continue;
        const float dx = px[k] - mx;
        const float dy = py[k] - my;
        const float sigma = __fadd_rn(
            __fadd_rn(__fmul_rn(__fmul_rn(0.5f * a, dx), dx),
                      __fmul_rn(__fmul_rn(b, dx), dy)),
            __fmul_rn(__fmul_rn(0.5f * c, dy), dy));
        const float raw = op * expf(-sigma);
        const float alpha = fminf(raw, kMaxAlpha);
        if (!(alpha >= kAlphaCutoff)) continue;   // K1 skipped it too
        const float before = logT[k] - log1pf(-alpha);
        const float w = alpha * expf(before);
        const float dw = gr[k] * cr + gg[k] * cg + gb[k] * cb + gd[k] * cd
                         + ga[k];
        const float wdw = w * dw;
        const float dsig =
            raw < kMaxAlpha ? S[k] * (alpha / (1.0f - alpha)) - wdw : 0.0f;
        const float u = dsig * dx;
        const float v = dsig * dy;
        q[0] += dsig;
        q[1] += u;
        q[2] += v;
        q[3] += u * dx;
        q[4] += u * dy;
        q[5] += v * dy;
        q[6] += w * gr[k];
        q[7] += w * gg[k];
        q[8] += w * gb[k];
        q[9] += w * gd[k];
        S[k] += wdw;
        logT[k] = before;
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
      float s[kSums];
#pragma unroll
      for (int r = 0; r < kSums; ++r) {
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) acc += s_part[r][w][j];
        s[r] = acc;
      }
      const float a = s_f[2][j], b = s_f[3][j], c = s_f[4][j];
      const float op = s_f[5][j];
      float g[kFields];
      g[0] = -(a * s[1] + b * s[2]);
      g[1] = -(b * s[1] + c * s[2]);
      g[2] = 0.5f * s[3];
      g[3] = s[4];
      g[4] = 0.5f * s[5];
      g[5] = op > 0.0f ? -s[0] / fmaxf(op, 1e-12f) : 0.0f;
      g[6] = s[6];
      g[7] = s[7];
      g[8] = s[8];
      g[9] = s[9];
      float* out = grad_fields + static_cast<size_t>(s_id[j]) * kFields;
#pragma unroll
      for (int r = 0; r < kFields; ++r)
        if (g[r] != 0.0f) atomicAdd(out + r, g[r]);
    }
  }
}

}  // namespace

// Launches K2 on `stream` over n_tiles (> 0) blocks and returns
// cudaGetLastError() as an int (0 = launched). All pointers are device
// pointers: fields (N, 10) float32, gauss_id (CAP,) int32, tile_starts
// (n_tiles + 1,) int32, d_acc (n_tiles, 5, 1024), d_logT and log_t
// (n_tiles, 1024) float32, n_contrib (n_tiles, 1024) int32, and
// grad_fields (N, 10) float32, zeroed by the caller and added into.
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
