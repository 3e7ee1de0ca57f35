// T1 on Hopper: K1's function with persistent blocks, a measurement tool.
//
// Replaces the Pallas TPU kernel tools/experiment_fused_fwd.py
// `_fused_fwd_kernel` (launched by `rasterize_fwd_fused`), which walks the
// whole tile grid inside one grid step to pay the TPU's per-grid-step cost
// once per frame. The Hopper counterpart of "one grid step walks every
// tile" is one persistent block per resident slot: the grid is as many
// blocks as fit on the card at once (occupancy x SM count, at most one per
// tile; the wrapper asks raster3d_fwd_persistent_slots and passes it in),
// and each block walks tiles until none are left, so the hardware
// block scheduler launches each block once instead of once per tile. Two
// schedules hand out the tiles:
//   static   (schedule 0): block b walks tiles b, b + gridDim.x, ...;
//   dynamic  (schedule 1): each block takes its next tile from a global
//            counter with atomicAdd, so a block that drew cheap tiles
//            takes more (the flagship's tiles differ in cost by orders of
//            magnitude).
// K1 itself (one block per tile) is the third schedule, the hardware's.
//
// Each tile's walk is K1's, `composite_tile` of raster3d_fwd_tile.cuh, so
// acc, log T, i_fin and n_contrib are bit for bit K1's. The tile index is
// uniform across the block: thread 0 fetches it into shared memory between
// two barriers (the first keeps it from overwriting the index some thread
// has not read yet), and `composite_tile` ends every read of the staging
// buffer with a barrier, so the next tile may stage at once. K1's
// __syncthreads_count exit ends one tile's walk, not the block.
//
// The counter is zeroed on the launch's stream (cudaMemsetAsync) before
// every dynamic launch: left at its last value it would hand the next
// launch no tiles.
//
// What bounds it: K1's work (the exp per walked pixel-gaussian pair on the
// special-function units); what it measures is what the hardware block
// scheduler costs K1 per tile, against a loop in software.

#include <cuda_runtime.h>

#include "raster3d_fwd_tile.cuh"

namespace {

using namespace raster3d_tile;

// kDynamic: the dynamic schedule (a compile-time choice, so neither
// schedule carries the other's state in registers)
template <bool kDynamic>
__global__ void __launch_bounds__(kThreads)
raster3d_fwd_persistent_kernel(const float* __restrict__ fields,
                               const int* __restrict__ gauss_id,
                               const int* __restrict__ tile_starts,
                               int n_tiles, int n_tiles_x,
                               float* __restrict__ acc,
                               float* __restrict__ log_t,
                               int* __restrict__ n_contrib,
                               int* __restrict__ counter) {
  __shared__ float s_f[kFields][kChunk];
  __shared__ int s_tile;

  int t = blockIdx.x;
  for (;;) {
    if (kDynamic) {
      __syncthreads();                 // every thread has read s_tile
      if (threadIdx.x == 0) s_tile = atomicAdd(counter, 1);
      __syncthreads();
      t = s_tile;
    }
    if (t >= n_tiles) break;
    composite_tile(fields, gauss_id, tile_starts, n_tiles_x, t, s_f, acc,
                   log_t, n_contrib);
    if (!kDynamic) t += gridDim.x;
  }
}

}  // namespace

namespace {

decltype(&raster3d_fwd_persistent_kernel<true>) kernel_of(int schedule) {
  return schedule == 1 ? raster3d_fwd_persistent_kernel<true>
                       : raster3d_fwd_persistent_kernel<false>;
}

}  // namespace

// The resident slots of T1's kernel for `schedule` (0 static, 1 dynamic)
// on the current device, blocks per SM x SMs, written to *slots. Returns
// the first failing runtime call's error as an int (0 = success).
// Launches nothing.
extern "C" int raster3d_fwd_persistent_slots(int schedule, int* slots) {
  int device = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel_of(schedule), kThreads, 0);
  *slots = per_sm * n_sm;
  return static_cast<int>(err);
}

// Launches T1 over `grid` (> 0) blocks on `stream` and returns
// cudaGetLastError() (or the counter reset's error) as an int (0 =
// launched). Arguments as K1's (raster3d_fwd.cu), plus counter, one int32
// on the device, and schedule: 0 static, 1 dynamic.
extern "C" int raster3d_fwd_persistent(const float* fields,
                                       const int* gauss_id,
                                       const int* tile_starts, int n_tiles,
                                       int n_tiles_x, float* acc,
                                       float* log_t, int* n_contrib,
                                       int* counter, int schedule, int grid,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (schedule == 1) {
    const cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel_of(schedule)<<<grid, kThreads, 0, s>>>(
      fields, gauss_id, tile_starts, n_tiles, n_tiles_x, acc, log_t,
      n_contrib, counter);
  return static_cast<int>(cudaGetLastError());
}
