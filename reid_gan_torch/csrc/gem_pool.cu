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
// writes dx (537 MB, ~160 us). The map is larger than L2, so it is read
// with streaming loads and dx written with streaming stores.
//
// Design. Each element costs one lg2 and one ex2 on the special-function
// unit and a few FMAs: the forward takes xc^p = 2^(p log2 xc); the backward
// takes xc^(p-1) = 2^((p-1) l) from the same l = log2 xc, then xc^p ln xc =
// xc^(p-1) * xc * l * ln 2. The unit gives 16 results a clock an SM, so the
// arithmetic stays under the byte rate. The map is channels_last, so at each spatial position a row
// of C floats is contiguous: a block covers one image and 128 channels, a
// lane one float4 of four channels (a warp reads 512 contiguous bytes a
// position), and the block's 8 warps take every 8th position each, four
// loads ahead: 64 warps an SM in the forward and 32 in the backward (its
// registers; 4 blocks measured faster than 5 or 6 with fewer loads ahead
// or spills) keep 64 KB or more of loads in flight. The warps' sums meet in
// shared memory and are added in warp order, so the result does not depend
// on scheduling. p is read on the device, so the wrapper never waits on the
// card.
//
// dp is a sum of N*C terms (524,288 at the main path's shape), each a
// difference of two numbers of the size of ln eps: every block forms its
// terms in double and writes their sum to its own slot, and one more block
// adds the slots in order. No atomics, so dp is the same on every run.
#include <stdint.h>

#include "common.cuh"
#include "sfu_math.cuh"

namespace {

using reid::ex2;
using reid::lg2;

constexpr int kGroups = 32;                  // float4 channel groups a block
constexpr int kSplit = 8;                    // warps, each every 8th position
constexpr int kThreads = kGroups * kSplit;   // 256
constexpr int kSumThreads = 1024;

__device__ __forceinline__ float get(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

__device__ __forceinline__ void set(float4& v, int k, float f) {
  if (k == 0) v.x = f; else if (k == 1) v.y = f; else if (k == 2) v.z = f; else v.w = f;
}

// Sums the kSplit warps' float4 of each lane in warp order; warp 0 gets it.
__device__ __forceinline__ float4 sum_over_warps(float4 v, float4 (&red)[kSplit][kGroups]) {
  const int lane = threadIdx.x % kGroups, w = threadIdx.x / kGroups;
  red[w][lane] = v;
  __syncthreads();
  float4 s = red[0][lane];
#pragma unroll
  for (int i = 1; i < kSplit; ++i) {
    const float4 r = red[i][lane];
    s.x += r.x; s.y += r.y; s.z += r.z; s.w += r.w;
  }
  return s;
}

// grid (N, ceil(C/4 / kGroups))
__global__ void __launch_bounds__(kThreads, 8)
gem_pool_forward_kernel(const float* __restrict__ x, const float* __restrict__ p_ptr,
                        float* __restrict__ out, float* __restrict__ smean, int S,
                        int C, float eps) {
  __shared__ float4 red[kSplit][kGroups];
  const int lane = threadIdx.x % kGroups, w = threadIdx.x / kGroups;
  const int g = blockIdx.y * kGroups + lane, c4 = C / 4;
  const float p = *p_ptr;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (g < c4) {
    const float4* xi = reinterpret_cast<const float4*>(x) +
                       static_cast<size_t>(blockIdx.x) * S * c4 + g;
#pragma unroll 4
    for (int s = w; s < S; s += kSplit) {
      const float4 v = __ldcs(xi + static_cast<size_t>(s) * c4);
      a.x += ex2(p * lg2(fmaxf(v.x, eps)));
      a.y += ex2(p * lg2(fmaxf(v.y, eps)));
      a.z += ex2(p * lg2(fmaxf(v.z, eps)));
      a.w += ex2(p * lg2(fmaxf(v.w, eps)));
    }
  }
  a = sum_over_warps(a, red);
  if (w != 0 || g >= c4) return;
  float4 m, o;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float mk = get(a, k) / static_cast<float>(S);
    set(m, k, mk);
    set(o, k, powf(mk, 1.0f / p));
  }
  const size_t at = static_cast<size_t>(blockIdx.x) * c4 + g;
  reinterpret_cast<float4*>(smean)[at] = m;
  reinterpret_cast<float4*>(out)[at] = o;
}

__global__ void __launch_bounds__(kThreads, 4)
gem_pool_backward_kernel(const float* __restrict__ x, const float* __restrict__ p_ptr,
                         const float* __restrict__ smean, const float* __restrict__ out,
                         const float* __restrict__ grad, float* __restrict__ dx,
                         double* __restrict__ partial, int S, int C, float eps) {
  __shared__ float4 red[kSplit][kGroups];
  const int lane = threadIdx.x % kGroups, w = threadIdx.x / kGroups;
  const int g = blockIdx.y * kGroups + lane, c4 = C / 4;
  const float p = *p_ptr, pm1 = p - 1.0f;
  const size_t at = static_cast<size_t>(blockIdx.x) * c4 + g;
  float4 m = make_float4(0.f, 0.f, 0.f, 0.f), o = m, gr = m;
  float4 t = make_float4(0.f, 0.f, 0.f, 0.f);  // sum_s xc^p log2 xc
  if (g < c4) {
    m = reinterpret_cast<const float4*>(smean)[at];
    o = reinterpret_cast<const float4*>(out)[at];
    gr = reinterpret_cast<const float4*>(grad)[at];
    float coef[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      coef[k] = get(gr, k) * get(o, k) / (static_cast<float>(S) * get(m, k));
    const size_t base = static_cast<size_t>(blockIdx.x) * S * c4 + g;
    const float4* xi = reinterpret_cast<const float4*>(x) + base;
    float4* di = reinterpret_cast<float4*>(dx) + base;
#pragma unroll 4
    for (int s = w; s < S; s += kSplit) {
      const float4 v = __ldcs(xi + static_cast<size_t>(s) * c4);
      float4 d;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float xv = get(v, k);
        const float xc = fmaxf(xv, eps);
        const float l = lg2(xc);
        const float xpm1 = ex2(pm1 * l);
        set(d, k, xv > eps ? coef[k] * xpm1 : 0.0f);
        set(t, k, fmaf(xpm1 * xc, l, get(t, k)));
      }
      __stcs(di + static_cast<size_t>(s) * c4, d);
    }
  }
  t = sum_over_warps(t, red);
  if (w != 0) return;
  double term = 0.0;
  if (g < c4) {
    const double pd = p, ln2 = 0.69314718055994530942;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const double sk = get(m, k);
      const double tk = static_cast<double>(get(t, k)) * ln2 / S;
      term += static_cast<double>(get(gr, k)) * get(o, k) *
              (tk / (pd * sk) - log(sk) / (pd * pd));
    }
  }
  term = reid::warp_sum(term);
  if (lane == 0) partial[blockIdx.x * gridDim.y + blockIdx.y] = term;
}

__global__ void __launch_bounds__(kSumThreads)
gem_pool_dp_kernel(const double* __restrict__ partial, int n, float* __restrict__ dp) {
  __shared__ double scratch[kSumThreads / reid::kWarp];
  double s = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s += partial[i];
  s = reid::block_sum(s, scratch);
  if (threadIdx.x == 0) *dp = static_cast<float>(s);
}

dim3 grid_of(int n, int c) { return dim3(n, (c / 4 + kGroups - 1) / kGroups); }

}  // namespace

// x: (N, S, C) fp32 contiguous (the channels_last map), 16-byte aligned,
// C % 4 == 0, S >= 1. p: one fp32 on the device. out, smean: (N, C) fp32.
extern "C" int reid_gem_pool_forward(const void* x, const void* p, void* out,
                                     void* smean, int n, int s, int c,
                                     float eps, void* stream) {
  gem_pool_forward_kernel<<<grid_of(n, c), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(p),
      static_cast<float*>(out), static_cast<float*>(smean), s, c, eps);
  return reid::launch_status();
}

// The doubles of scratch that reid_gem_pool_backward needs: one per block.
extern "C" long long reid_gem_pool_backward_scratch(int n, int c) {
  const dim3 grid = grid_of(n, c);
  return static_cast<long long>(grid.x) * grid.y;
}

// grad: (N, C) fp32 = dL/dout. dx: (N, S, C) fp32 like x. dp: one fp32.
// partial: reid_gem_pool_backward_scratch(n, c) doubles.
extern "C" int reid_gem_pool_backward(const void* x, const void* p,
                                      const void* smean, const void* out,
                                      const void* grad, void* dx, void* dp,
                                      void* partial, int n, int s, int c,
                                      float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(n, c);
  gem_pool_backward_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(p),
      static_cast<const float*>(smean), static_cast<const float*>(out),
      static_cast<const float*>(grad), static_cast<float*>(dx),
      static_cast<double*>(partial), s, c, eps);
  const int rc = reid::launch_status();
  if (rc != 0) return rc;
  gem_pool_dp_kernel<<<1, kSumThreads, 0, st>>>(static_cast<const double*>(partial),
                                                static_cast<int>(grid.x * grid.y),
                                                static_cast<float*>(dp));
  return reid::launch_status();
}
