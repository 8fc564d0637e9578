// K9: the GAN branch's input transform, uint8 NHWC staging batch -> NCHW fp32
// in [-1, 1].
//
// Replaces: reid_gan_tpu/ops/transforms.py::gan_input_transform
// (ops/transforms.py:160-168: to_float -> resize, a no-op at the staged GAN
// size -> normalize with mean 0.5 and std 0.5), fused by XLA into the joint
// train step (engine/gan_trainers.py:162).
//
//   out[n, c, y, x] = (src[n, y, x, c] / 255 - 0.5) / 0.5
//
// in JAX's order of operations, with IEEE divisions (no reciprocal multiply;
// the division by 0.5 is exact).
//
// Bound: bytes. Per pixel it reads 3 bytes and writes 12; at batch 256 of
// 128x64 that is 6.3 MB read + 25.2 MB written, ~9.4 us at 3.35 TB/s. One
// thread per pixel over a grid-stride loop: neighbouring threads read
// neighbouring pixels and write neighbouring floats of each of the three
// channel planes, so every store is coalesced. The loads are 3-byte strided;
// they are a fifth of the traffic.
#include <stdint.h>

#include "common.cuh"

namespace {

__global__ void gan_input_kernel(const uint8_t* __restrict__ src,
                                 float* __restrict__ dst, long long pixels,
                                 long long plane) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < pixels; i += stride) {
    const uint8_t* px = src + i * 3;
    const long long n = i / plane;
    float* o = dst + n * 3 * plane + (i - n * plane);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      o[c * plane] = (static_cast<float>(px[c]) / 255.0f - 0.5f) / 0.5f;
  }
}

}  // namespace

// src: (N, H, W, 3) uint8 contiguous. dst: (N, 3, H, W) fp32 contiguous.
// pixels = N * H * W, plane = H * W.
extern "C" int reid_gan_input(const void* src, void* dst, long long pixels,
                              long long plane, void* stream) {
  const int threads = 256;
  long long blocks = (pixels + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  gan_input_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<float*>(dst), pixels, plane);
  return reid::launch_status();
}
