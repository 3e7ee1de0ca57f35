// T3 on Hopper: the fixed cost of a block, a measurement tool.
//
// Replaces the Pallas TPU kernels tools/profile_grid_overhead.py
// `null_kernel` and `one_dma_kernel` (launched by `run`), which time a grid
// of steps that do (almost) nothing to find the TPU's fixed cost per grid
// step. Here each is one 256-thread block per tile, K1's block shape:
//   grid_overhead_empty     no body: the launch and block-scheduling floor;
//   grid_overhead_write     the null_kernel's function: block b zeroes its
//                           (16, 1024) float32 output block out[b];
//   grid_overhead_one_copy  the one_dma_kernel's: reads inst[:, 0:128] of
//                           the (16, inst_cols) float32 input into shared
//                           memory, then writes zeros plus inst[0, 0] to
//                           out[b].
// What bounds them: bytes, the 64 KB each writing block stores (16-byte
// stores, neighbouring threads on neighbouring addresses); the empty
// kernel moves none, so its time is all overhead. Timed per block against
// the grid, they give the per-block cost under K1's time (one block per
// 32x32 tile).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;
constexpr int kPixels = 1024;
constexpr int kCopyCols = 128;
constexpr int kVec = kRows * kPixels / 4 / kThreads;  // float4 per thread

__global__ void __launch_bounds__(kThreads) empty_kernel() {}

__device__ __forceinline__ void fill_block(float* __restrict__ out,
                                           float value) {
  float4* o = reinterpret_cast<float4*>(
      out + static_cast<size_t>(blockIdx.x) * kRows * kPixels);
  const float4 v = make_float4(value, value, value, value);
#pragma unroll
  for (int i = 0; i < kVec; ++i) o[threadIdx.x + i * kThreads] = v;
}

__global__ void __launch_bounds__(kThreads)
write_kernel(float* __restrict__ out) {
  fill_block(out, 0.0f);
}

__global__ void __launch_bounds__(kThreads)
one_copy_kernel(const float* __restrict__ inst, int inst_cols,
                float* __restrict__ out) {
  __shared__ float s_buf[kRows][kCopyCols];
  for (int i = threadIdx.x; i < kRows * kCopyCols; i += kThreads)
    s_buf[i / kCopyCols][i % kCopyCols] =
        inst[static_cast<size_t>(i / kCopyCols) * inst_cols + i % kCopyCols];
  __syncthreads();
  fill_block(out, 0.0f + s_buf[0][0]);
}

}  // namespace

// Each launches its kernel over n_blocks (> 0) blocks of 256 threads on
// `stream` and returns cudaGetLastError() as an int (0 = launched). out is
// (n_blocks, 16, 1024) float32 on the device (16-byte aligned); inst is
// (16, inst_cols) float32 with inst_cols >= 128.
extern "C" int grid_overhead_empty(int n_blocks, void* stream) {
  empty_kernel<<<n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int grid_overhead_write(int n_blocks, float* out, void* stream) {
  write_kernel<<<n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int grid_overhead_one_copy(int n_blocks, const float* inst,
                                      int inst_cols, float* out,
                                      void* stream) {
  one_copy_kernel<<<n_blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(inst, inst_cols,
                                                         out);
  return static_cast<int>(cudaGetLastError());
}
