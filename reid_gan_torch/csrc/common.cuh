// Helpers shared by the port's kernels. Every kernel file exposes a plain C
// entry point that launches on the caller's stream and returns
// cudaGetLastError(), so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>

namespace reid {

constexpr int kWarp = 32;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Max over the block; every thread gets it. Same contract as block_sum.
__device__ __forceinline__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int nwarps = (blockDim.x + kWarp - 1) / kWarp;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float m = scratch[0];
  for (int w = 1; w < nwarps; ++w) m = fmaxf(m, scratch[w]);
  return m;
}

// Sum over the block; every thread gets the total. `scratch` holds one value
// per warp. Must be reached by all threads of the block.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* scratch) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int nwarps = (blockDim.x + kWarp - 1) / kWarp;
  v = warp_sum(v);
  __syncthreads();  // scratch may still be read from a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T total = 0;
  for (int w = 0; w < nwarps; ++w) total += scratch[w];
  return total;
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace reid
