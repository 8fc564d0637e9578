// K2: eval feature head, GeM pooling + scale-only feat_bn + L2 normalisation,
// from the layer4 map in one pass.
//
// Replaces: the eval head of reid_gan_tpu/models/resnet.py::ReIDResNet
// (resnet.py:183 upcast, :189 GeneralizedMeanPooling from
// models/pooling.py:18-25, :199-206 TorchBatchNorm eval without bias, :255-256
// _l2n), which XLA fused into the extractor program.
//
//   pooled[c] = (mean_s max(x[s, c], eps)^p)^(1/p)       p = learned gap.p
//   z[c]      = (pooled[c] - mu[c]) * (1 / sqrt(var[c] + bn_eps)) * gamma[c]
//   out[c]    = z[c] * (1 / (sqrt(sum_c z[c]^2) + 1e-12))  (epsilon outside)
//
// Bound: bytes. The map is read once (N x S x C fp32: 268 MB for 256 images
// of 16x8x2048, ~80 us at 3.35 TB/s); the pow per element is far below the
// fp32 rate. One block per image; the map is channels_last, so at each
// spatial position the block reads one contiguous row of C floats, each
// thread a float4 of four channels (coalesced 16-byte loads), and keeps the
// GeM sums of its channels in registers across the S positions (unrolled so
// several loads are in flight). z goes to shared memory while one block
// reduction forms the L2 norm; p is read on the device, so the wrapper never
// waits on the card.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gem_bn_l2n_kernel(const float* __restrict__ x, const float* __restrict__ p_ptr,
                  const float* __restrict__ gamma,
                  const float* __restrict__ mean,
                  const float* __restrict__ var, float* __restrict__ out,
                  int S, int C, float gem_eps, float bn_eps) {
  extern __shared__ float z[];  // C floats
  __shared__ float scratch[kThreads / reid::kWarp];
  const float p = *p_ptr;
  const float inv_p = 1.0f / p;
  const float* xi = x + static_cast<size_t>(blockIdx.x) * S * C;
  const int C4 = C / 4;
  float ss = 0.0f;
  for (int g = threadIdx.x; g < C4; g += blockDim.x) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 8
    for (int s = 0; s < S; ++s) {
      const float4 v = reinterpret_cast<const float4*>(xi + static_cast<size_t>(s) * C)[g];
      a0 += powf(fmaxf(v.x, gem_eps), p);
      a1 += powf(fmaxf(v.y, gem_eps), p);
      a2 += powf(fmaxf(v.z, gem_eps), p);
      a3 += powf(fmaxf(v.w, gem_eps), p);
    }
    const float acc[4] = {a0, a1, a2, a3};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 4 * g + k;
      const float pooled = powf(acc[k] / static_cast<float>(S), inv_p);
      const float zc = (pooled - mean[c]) * (1.0f / sqrtf(var[c] + bn_eps)) * gamma[c];
      z[c] = zc;
      ss += zc * zc;
    }
  }
  ss = reid::block_sum(ss, scratch);  // also orders the z writes before reads
  const float inv = 1.0f / (sqrtf(ss) + 1e-12f);
  float* oi = out + static_cast<size_t>(blockIdx.x) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) oi[c] = z[c] * inv;
}

}  // namespace

// x: (N, S, C) fp32 contiguous (the channels_last map), 16-byte aligned,
// C % 4 == 0. p: one fp32 on the device. gamma/mean/var: C fp32. out: (N, C).
extern "C" int reid_gem_bn_l2n(const void* x, const void* p, const void* gamma,
                               const void* mean, const void* var, void* out,
                               int n, int s, int c, float gem_eps,
                               float bn_eps, void* stream) {
  const size_t smem = static_cast<size_t>(c) * sizeof(float);
  gem_bn_l2n_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(p),
      static_cast<const float*>(gamma), static_cast<const float*>(mean),
      static_cast<const float*>(var), static_cast<float*>(out), s, c, gem_eps,
      bn_eps);
  return reid::launch_status();
}
