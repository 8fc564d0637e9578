// K1: fused eval transform, uint8 NHWC staging batch -> normalised NCHW batch
// in channels_last memory (physically NHWC), as fp32 or bf16.
//
// Replaces: reid_gan_tpu/ops/transforms.py::reid_augment(train=False)
// (ops/transforms.py:137-151: to_float -> resize no-op -> normalize), as fused
// into the extractor's jitted forward with the cast to the extractor dtype
// (engine/evaluators.py:44-47).
//
// Arithmetic follows the JAX order exactly: x/255, then -mean, then /std,
// with IEEE divisions (no reciprocal multiply), then round-to-nearest-even
// to bf16 when asked.
//
// Bound: bytes. Per element it reads 1 byte and writes 2 (bf16) or 4 (fp32)
// and does three flops; at batch 256 of 256x128 that is 25 MB read + 50 MB
// written, ~22 us at 3.35 TB/s. Channels_last output makes the map a pure
// elementwise pass over the input's own order (channel = flat index mod 3),
// so reads and writes are both contiguous: each thread loads 4 bytes and
// stores 4 outputs in one vector store, over a grid-stride loop.
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

struct Norm {
  float mean[3];
  float std[3];
};

__device__ __forceinline__ float norm_one(uint8_t v, int ch, const Norm& nm) {
  return (static_cast<float>(v) / 255.0f - nm.mean[ch]) / nm.std[ch];
}

__device__ __forceinline__ void store4(float* dst, const float o[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float o[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(o[2], o[3]);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void eval_transform_kernel(const uint8_t* __restrict__ src,
                                      T* __restrict__ dst, long long n,
                                      Norm nm) {
  const long long n4 = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < n4; i += stride) {
    const uchar4 v = reinterpret_cast<const uchar4*>(src)[i];
    const int c = static_cast<int>((i * 4) % 3);
    float o[4];
    o[0] = norm_one(v.x, c, nm);
    o[1] = norm_one(v.y, (c + 1) % 3, nm);
    o[2] = norm_one(v.z, (c + 2) % 3, nm);
    o[3] = norm_one(v.w, c, nm);
    store4(dst + i * 4, o);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (long long e = n4 * 4; e < n; ++e)
      store1(dst + e, norm_one(src[e], static_cast<int>(e % 3), nm));
  }
}

}  // namespace

// src: n uint8 values, (N, H, W, 3) contiguous, 4-byte aligned.
// dst: n values, 16-byte aligned; out_bf16 selects bf16 over fp32.
extern "C" int reid_eval_transform(const void* src, void* dst, long long n,
                                   int out_bf16, float m0, float m1, float m2,
                                   float s0, float s1, float s2,
                                   void* stream) {
  const Norm nm = {{m0, m1, m2}, {s0, s1, s2}};
  const int threads = 256;
  long long blocks = (n / 4 + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(src);
  if (out_bf16) {
    eval_transform_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        in, static_cast<__nv_bfloat16*>(dst), n, nm);
  } else {
    eval_transform_kernel<float><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        in, static_cast<float*>(dst), n, nm);
  }
  return reid::launch_status();
}
