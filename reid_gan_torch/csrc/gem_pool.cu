// K5: GeM pooling in train mode, forward and backward, over the layer4 map.
//
// Replaces: the train forward of reid_gan_tpu/models/pooling.py::
// GeneralizedMeanPooling (pooling.py:18-25) inside ReIDResNet
// (resnet.py:189) and its reverse-mode derivative, which XLA fused into the
// jitted train step (the eval forward is K2, gem_bn_l2n.cu).
//
//   S[n,c]   = mean_s max(x[n,s,c], eps)^p          (saved for the backward)
//   out[n,c] = S[n,c]^(1/p)
// Backward, with g = dL/dout and xc = max(x, eps):
//   dx[n,s,c] = g * out * xc^(p-1) / (HW * S)       where x > eps, else 0
//   dp        = sum_{n,c} g * out * (mean_s(xc^p ln xc) / (p S) - ln S / p^2)
//
// Bound: bytes. The forward reads the map once (N x HW x C fp32: 268 MB for
// 256 images of 16x8x2048, ~80 us at 3.35 TB/s); the backward reads it and
// writes dx (537 MB, ~160 us). Two powf and one logf per element stay below
// the fp32 rate. The map is channels_last, so at each spatial position a
// row of C floats is contiguous: a block covers one image and 512 channels,
// each thread one float4 of four channels (coalesced 16-byte loads), and
// keeps its sums in registers across the HW positions. p is read on the
// device, so the wrapper never waits on the card.
//
// dp is a sum of N*C terms (524,288 at the main path's shape), each a
// difference of two numbers of the size of ln eps: every block reduces its
// terms in double into its own slot, and one more block adds the slots in
// order. No atomics, so dp is the same on every run.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // float4 groups per block: 512 channels

__device__ __forceinline__ float get(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

__device__ __forceinline__ void set(float4& v, int k, float f) {
  if (k == 0) v.x = f; else if (k == 1) v.y = f; else if (k == 2) v.z = f; else v.w = f;
}

__global__ void __launch_bounds__(kThreads)
gem_forward_kernel(const float* __restrict__ x, const float* __restrict__ p_ptr,
                   float* __restrict__ out, float* __restrict__ smean, int S,
                   int C, float eps) {
  const int g = blockIdx.y * blockDim.x + threadIdx.x;
  if (g >= C / 4) return;
  const float p = *p_ptr;
  const float* xi = x + static_cast<size_t>(blockIdx.x) * S * C;
  float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int s = 0; s < S; ++s) {
    const float4 v = reinterpret_cast<const float4*>(xi + static_cast<size_t>(s) * C)[g];
#pragma unroll
    for (int k = 0; k < 4; ++k) a[k] += powf(fmaxf(get(v, k), eps), p);
  }
  float4 m, o;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float mk = a[k] / static_cast<float>(S);
    set(m, k, mk);
    set(o, k, powf(mk, 1.0f / p));
  }
  const size_t at = static_cast<size_t>(blockIdx.x) * C / 4 + g;
  reinterpret_cast<float4*>(smean)[at] = m;
  reinterpret_cast<float4*>(out)[at] = o;
}

__global__ void __launch_bounds__(kThreads)
gem_backward_kernel(const float* __restrict__ x, const float* __restrict__ p_ptr,
                    const float* __restrict__ smean, const float* __restrict__ out,
                    const float* __restrict__ grad, float* __restrict__ dx,
                    double* __restrict__ partial, int S, int C, float eps) {
  __shared__ double scratch[kThreads / reid::kWarp];
  const int g = blockIdx.y * blockDim.x + threadIdx.x;
  const float p = *p_ptr;
  double term = 0.0;
  if (g < C / 4) {
    const size_t at = static_cast<size_t>(blockIdx.x) * C / 4 + g;
    const float4 m = reinterpret_cast<const float4*>(smean)[at];
    const float4 o = reinterpret_cast<const float4*>(out)[at];
    const float4 gr = reinterpret_cast<const float4*>(grad)[at];
    float coef[4], t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      coef[k] = get(gr, k) * get(o, k) / (static_cast<float>(S) * get(m, k));
    const size_t base = static_cast<size_t>(blockIdx.x) * S * C;
#pragma unroll 4
    for (int s = 0; s < S; ++s) {
      const size_t off = base + static_cast<size_t>(s) * C;
      const float4 v = reinterpret_cast<const float4*>(x + off)[g];
      float4 d;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float xv = get(v, k);
        const float xc = fmaxf(xv, eps);
        const float xpm1 = powf(xc, p - 1.0f);
        set(d, k, xv > eps ? coef[k] * xpm1 : 0.0f);
        t[k] += xpm1 * xc * logf(xc);
      }
      reinterpret_cast<float4*>(dx + off)[g] = d;
    }
    const double pd = p;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const double sk = get(m, k);
      const double tk = static_cast<double>(t[k]) / S;
      term += static_cast<double>(get(gr, k)) * get(o, k) *
              (tk / (pd * sk) - log(sk) / (pd * pd));
    }
  }
  term = reid::block_sum(term, scratch);
  if (threadIdx.x == 0) partial[blockIdx.x * gridDim.y + blockIdx.y] = term;
}

__global__ void sum_partials_kernel(const double* __restrict__ partial, int n,
                                    float* __restrict__ dp) {
  __shared__ double scratch[256 / reid::kWarp];
  double s = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s += partial[i];
  s = reid::block_sum(s, scratch);
  if (threadIdx.x == 0) *dp = static_cast<float>(s);
}

}  // namespace

// x: (N, S, C) fp32 contiguous (the channels_last map), 16-byte aligned,
// C % 4 == 0. p: one fp32 on the device. out, smean: (N, C) fp32.
extern "C" int reid_gem_pool_forward(const void* x, const void* p, void* out,
                                     void* smean, int n, int s, int c,
                                     float eps, void* stream) {
  const dim3 grid(n, (c / 4 + kThreads - 1) / kThreads);
  gem_forward_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(p),
      static_cast<float*>(out), static_cast<float*>(smean), s, c, eps);
  return reid::launch_status();
}

// The doubles of scratch that reid_gem_pool_backward needs: one per block.
extern "C" long long reid_gem_pool_backward_scratch(int n, int c) {
  return static_cast<long long>(n) * ((c / 4 + kThreads - 1) / kThreads);
}

// grad: (N, C) fp32 = dL/dout. dx: (N, S, C) fp32 like x. dp: one fp32.
// partial: reid_gem_pool_backward_scratch(n, c) doubles.
extern "C" int reid_gem_pool_backward(const void* x, const void* p,
                                      const void* smean, const void* out,
                                      const void* grad, void* dx, void* dp,
                                      void* partial, int n, int s, int c,
                                      float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n, (c / 4 + kThreads - 1) / kThreads);
  gem_backward_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(p),
      static_cast<const float*>(smean), static_cast<const float*>(out),
      static_cast<const float*>(grad), static_cast<float*>(dx),
      static_cast<double*>(partial), s, c, eps);
  const int rc = reid::launch_status();
  if (rc != 0) return rc;
  sum_partials_kernel<<<1, 256, 0, st>>>(static_cast<const double*>(partial),
                                         static_cast<int>(grid.x * grid.y),
                                         static_cast<float*>(dp));
  return reid::launch_status();
}
