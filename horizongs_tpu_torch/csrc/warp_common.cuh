// Warp-level pieces shared by the compositors: cp.async staging (K1, K2,
// K3) and the reduce-scatter of a lane's partial sums (K2, K4).
#pragma once

#include <cuda_runtime.h>

namespace warp_common {

constexpr unsigned kFull = 0xffffffffu;

// cp.async: an 8-byte copy from device to shared memory, a commit of the
// copies issued since the last commit as one group, and a wait until at
// most N groups are in flight.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The reduce-scatter from lane offset O down to 1: the first N of v are
// summed pairwise with lane ^ O's, each lane keeping the lower or upper
// (N + 1) / 2 of them (padded with a zero where N is odd) in
// v[0..(N + 1) / 2), and so on with O / 2. From O = 16, lane `lane_field`
// ends with one sum's warp total in v[0]: 10 sums take 5 + 3 + 2 + 1 + 1
// = 12 shuffles, 18 take 9 + 5 + 3 + 2 + 1 = 20.
template <int N, int O, int L>
__device__ __forceinline__ void reduce_scatter(float (&v)[L], int lane) {
  static_assert(N <= L, "the sums fit in v");
  if constexpr (O > 0) {
    constexpr int H = (N + 1) / 2;
    const bool hi = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float a = v[i];
      const float b = i + H < N ? v[i + H] : 0.0f;
      const float send = hi ? a : b;
      v[i] = (hi ? b : a) + __shfl_xor_sync(kFull, send, O);
    }
    reduce_scatter<H, O / 2>(v, lane);
  }
}

// The sum whose warp total reduce_scatter<N, 16> leaves in a lane's v[0],
// or -1 where that lane holds padding.
template <int N>
__device__ __forceinline__ int lane_field(int lane) {
  int field = 0, real = N, n = N;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int h = (n + 1) / 2;
    if (lane & o) {
      field += h;
      real = max(0, real - h);
    } else {
      real = min(real, h);
    }
    n = h;
  }
  return real > 0 ? field : -1;
}

}  // namespace warp_common
