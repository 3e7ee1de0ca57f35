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
// field matrix [mx, my, a, b, c, op, r, g, b, depth] (8-byte aligned) and
// the sorted gauss_id of every instance, so the TPU wrapper's transposed
// (16, CAP+2G) instance copy is never built. Outputs keep the TPU kernel's
// layout: acc (n_tiles, 5, 1024) holds its rows 6-10 (rgb, depth, alpha)
// and log_t (n_tiles, 2, 1024) holds row 0 the final log T and row 1
// i_fin; besides, n_contrib (n_tiles, 1024) int32.
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
// What bounds it, given the skip tests (raster3d_common.cuh): a walked
// pixel-gaussian pair in a warp step that the support box culls costs
// nothing; any other walked pair costs sigma and the rejection test (about
// 12 FP32 operations); a pair the test does not reject, the exp of alpha
// on the special-function units (16 results per SM per clock) and a few
// FP32 operations; a pair that contributes (alpha >= 1/255), an exp (T)
// and a log1p more and about 14 FP32 operations (an FMA counting two).
// Bytes (about 40 B per instance read, 32 B per pixel written) are far
// below.
//
// Design: one block of 512 threads per 32x32 tile; warp w owns an 8x8
// pixel block, two pixels per lane (`warp_pixel`), so a warp's pixels lie
// close together on screen. Sixteen warps a tile rather than eight: the
// deepest tiles (pixels that never stop, hundreds of gaussians each) finish
// last, alone on their SMs, and more warps hide more of the latency of
// their chains of exps and logs; 8x8 blocks also cull finer than 16x8 (on
// an H100, a build with 256 threads and 16x8 blocks ran K1 slower). The
// segment is staged 128 gaussians at a time
// into one of two shared buffers with cp.async (8-byte copies of the
// 40-byte rows, gathered through gauss_id): the next chunk's gather is in
// flight while the current chunk is walked. Once a chunk has landed,
// thread j computes gaussian j's skip threshold and support box and the
// mask of the warps whose pixels the box reaches. A warp then
//  * skips a gaussian outside its mask outright,
//  * skips, per pair, the exp (and with it everything after) where the
//    rounded sigma exceeds the threshold, which proves alpha = 0, and runs
//    the unchanged exact arithmetic on every other pair, so every record
//    matches,
//  * stops walking once none of its pixels is alive (a vote per gaussian
//    it walks), while it keeps joining the block's barriers; the block
//    leaves once __syncthreads_count says no pixel of the tile is alive.
// FP32 throughout. The exp of alpha and the log1p of the walk are the
// accurate expf / log1pf, since they decide the records; the weight's
// T = exp(log T) is __expf (within 2 + 1.16 |log T| <= 13 ulp, 1.6e-6 of
// T, for log T > log 1e-4), which moves no record.
//
// The walk of one tile is `composite_tile` in raster3d_fwd_tile.cuh, which
// the persistent form T1 (raster3d_fwd_persistent.cu) shares.

#include <cuda_runtime.h>

#include "raster3d_fwd_tile.cuh"

namespace {

using namespace raster3d;

__global__ void __launch_bounds__(kThreads, kMinBlocks)
raster3d_fwd_kernel(const float* __restrict__ fields,
                    const int* __restrict__ gauss_id,
                    const int* __restrict__ tile_starts,
                    int n_tiles_x,
                    float* __restrict__ acc,
                    float* __restrict__ log_t,
                    int* __restrict__ n_contrib) {
  __shared__ FwdShared s;
  composite_tile(fields, gauss_id, tile_starts, n_tiles_x, blockIdx.x, s,
                 acc, log_t, n_contrib);
}

}  // namespace

// Launches K1 on `stream` over n_tiles (> 0) blocks and returns
// cudaGetLastError() as an int (0 = launched). All pointers are device
// pointers; fields is (N, 10) float32 row-major and 8-byte aligned,
// gauss_id (CAP,) int32, tile_starts (n_tiles + 1,) int32, acc (n_tiles,
// 5, 1024) and log_t (n_tiles, 2, 1024) float32, n_contrib (n_tiles, 1024)
// int32.
extern "C" int raster3d_fwd(const float* fields, const int* gauss_id,
                            const int* tile_starts, int n_tiles,
                            int n_tiles_x, float* acc, float* log_t,
                            int* n_contrib, void* stream) {
  raster3d_fwd_kernel<<<n_tiles, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      fields, gauss_id, tile_starts, n_tiles_x, acc, log_t, n_contrib);
  return static_cast<int>(cudaGetLastError());
}

// K1's blocks resident per SM on the current device, written to *blocks.
// Returns the runtime's error as an int (0 = success). Launches nothing.
extern "C" int raster3d_fwd_occupancy(int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, raster3d_fwd_kernel, kThreads, 0));
}
