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
// (n_tiles, 2, 1024) holds row 0 the final log T and row 1 i_fin; besides,
// n_contrib (n_tiles, 1024) int32.
//
// A pixel stops once its log T is at or below log(1e-4); its final log T
// is then the sum up to and including the gaussian that stopped it, where
// the TPU kernel's keeps adding the rest of the chunk pair (both
// transmittances are below 1e-4 there). n_contrib is the number of
// gaussians of the segment the pixel walked: the index of the one that
// stopped it plus one, or the segment's length. The backward kernel
// (raster3d_bwd.cu) needs it: its reverse walk rebuilds log T before each
// gaussian by subtracting log1p(-alpha) from the final log T, which holds
// only the gaussians before the pixel's own stop. A tile-wide start such as
// i_fin would subtract gaussians this pixel never added.
//
// i_fin: the number of G = 128 gaussian chunks (counted from the segment
// start) that this tile's walk reached before every pixel had stopped,
// i.e. ceil(max n_contrib / 128). (The TPU kernel counts chunks walked in
// pairs from a 128-aligned base, so the two are not compared bitwise.)
//
// What bounds it: each pixel-gaussian pair costs at least one exp on the
// special-function units (16 per SM per clock) and about 15 FP32
// operations on the CUDA cores (256 per SM per clock, an FMA counting two),
// so the SFU is the limit; bytes (about 40 B per instance read, 32 B per
// pixel written) are far below either. The design keeps the SFUs fed: one
// block of 256 threads per 32x32 tile, four pixels per thread, the segment
// staged 128 gaussians at a time in shared memory (one gaussian per thread
// gathered through gauss_id, broadcast reads in the loop), each pixel
// skipping work once it has stopped and the block leaving as soon as
// __syncthreads_count says no pixel is alive. It computes in plain FP32
// (accurate expf / log1pf): no TPU-style bf16 splitting is needed.

// The walk of one tile is `composite_tile` in raster3d_fwd_tile.cuh, which
// the persistent form T1 (raster3d_fwd_persistent.cu) shares.

#include <cuda_runtime.h>

#include "raster3d_fwd_tile.cuh"

namespace {

using namespace raster3d_tile;

__global__ void __launch_bounds__(kThreads)
raster3d_fwd_kernel(const float* __restrict__ fields,
                    const int* __restrict__ gauss_id,
                    const int* __restrict__ tile_starts,
                    int n_tiles_x,
                    float* __restrict__ acc,
                    float* __restrict__ log_t,
                    int* __restrict__ n_contrib) {
  __shared__ float s_f[kFields][kChunk];
  composite_tile(fields, gauss_id, tile_starts, n_tiles_x, blockIdx.x, s_f,
                 acc, log_t, n_contrib);
}

}  // namespace

// Launches K1 on `stream` over n_tiles (> 0) blocks and returns
// cudaGetLastError() as an int (0 = launched). All pointers are device
// pointers; fields is (N, 10) float32 row-major, gauss_id (CAP,) int32,
// tile_starts (n_tiles + 1,) int32, acc (n_tiles, 5, 1024) and log_t
// (n_tiles, 2, 1024) float32, n_contrib (n_tiles, 1024) int32.
extern "C" int raster3d_fwd(const float* fields, const int* gauss_id,
                            const int* tile_starts, int n_tiles,
                            int n_tiles_x, float* acc, float* log_t,
                            int* n_contrib, void* stream) {
  raster3d_fwd_kernel<<<n_tiles, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      fields, gauss_id, tile_starts, n_tiles_x, acc, log_t, n_contrib);
  return static_cast<int>(cudaGetLastError());
}
