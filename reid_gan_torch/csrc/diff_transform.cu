// K12: the re-encode transform of generated images, G's NCHW fp32 output in
// [-1, 1] -> ImageNet-normalised images at the re-ID size, NCHW in
// channels_last memory (the layout the encoder takes).
//
// Replaces: reid_gan_tpu/ops/transforms.py::diff_transform (:171-180), fused
// by XLA into the AE hard-mix train step (engine/gan_trainers.py:114):
//
//   x   = (g + 1) / 2
//   x   = jax.image.resize(x, (n, OH, OW, c), "bicubic")
//   out = (x - mean[c]) / std[c]
//
// The resize is scale_and_translate with the Keys cubic kernel (a = -0.5),
// not torch's bicubic (a = -0.75, clamped indices). For each output
// coordinate o along an axis of n inputs upsampled by s = OUT / n, the
// sample point is f = (o + 0.5) * (1 / s) - 0.5; the taps are the inputs
// i = floor(f) - 1 .. floor(f) + 2 with weight keys(|f - i|); the taps that
// fall outside [0, n) are dropped and the others divided by their sum
// (jax/_src/image/scale.py compute_weight_mat). At an exact 2x upsample the
// interior weights are (-3, 29, 111, -9) / 128 on inputs i-2 .. i+1 for
// output 2i, mirrored for 2i + 1, and the first and last three outputs are
// renormalised, e.g. output 0 takes (1.088235, -0.088235) on inputs 0, 1.
// The weights are formed here from the formula in JAX's order of
// operations, rounded (no contraction); each is exact at 2x except the
// renormalised ones, which are one IEEE division each. The halving of g + 1
// is a multiplication by 0.5, which gives the quotient exactly. The resize
// runs along H first, then W, as JAX's two contractions do; the
// normalisation is an IEEE division, as K1's.
//
// Bound: bytes. At 16 images of 128x64 -> 256x128 it reads 1.57 MB and
// writes 6.29 MB, 2.3 us at 3.35 TB/s; one launch per hard-mix step, so the
// launch itself dominates. One thread per output pixel computes its 4 row
// and 4 column weights and the 3 channels, reading the 4x4x3 taps through
// the cache, and stores 3 neighbouring floats of the channels_last output,
// so a warp's stores cover one contiguous run.
#include <math.h>

#include "common.cuh"

namespace {

// The Keys cubic kernel with a = -0.5 at distance x >= 0, as
// jax/_src/image/scale.py _fill_keys_cubic_kernel computes it.
__device__ __forceinline__ float keys_cubic(float x) {
  if (x >= 2.0f) return 0.0f;
  if (x >= 1.0f)
    return __fadd_rn(__fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(__fmul_rn(-0.5f, x), 2.5f), x),
                                         4.0f), x), 2.0f);
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(__fmul_rn(1.5f, x), 2.5f), x), x), 1.0f);
}

// The first tap and the 4 renormalised weights of output coordinate o along
// an axis of n inputs; a tap outside [0, n) gets weight 0 and index 0.
__device__ __forceinline__ void taps(int o, int n, float inv, int idx[4], float w[4]) {
  const float f = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(o), 0.5f), inv), 0.5f);
  const int base = static_cast<int>(floorf(f)) - 1;
  float total = 0.0f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int i = base + t;
    const bool in = i >= 0 && i < n;
    w[t] = in ? keys_cubic(fabsf(__fsub_rn(f, static_cast<float>(i)))) : 0.0f;
    idx[t] = in ? i : 0;
    total = __fadd_rn(total, w[t]);
  }
  const bool keep = fabsf(total) > 1000.0f * 1.1920928955078125e-7f &&
                    f >= -0.5f && f <= static_cast<float>(n) - 0.5f;
#pragma unroll
  for (int t = 0; t < 4; ++t) w[t] = keep ? __fdiv_rn(w[t], total) : 0.0f;
}

__global__ void diff_transform_kernel(const float* __restrict__ src,
                                      float* __restrict__ dst, int N, int H, int W,
                                      int OH, int OW, float inv_h, float inv_w,
                                      float m0, float m1, float m2, float s0,
                                      float s1, float s2) {
  const long long total = static_cast<long long>(N) * OH * OW;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const float mean[3] = {m0, m1, m2};
  const float stdv[3] = {s0, s1, s2};
  for (long long p = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       p < total; p += stride) {
    const int ox = static_cast<int>(p % OW);
    const int oy = static_cast<int>((p / OW) % OH);
    const long long n = p / (static_cast<long long>(OW) * OH);
    int ry[4], cx[4];
    float wy[4], wx[4];
    taps(oy, H, inv_h, ry, wy);
    taps(ox, W, inv_w, cx, wx);
    float* o = dst + p * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* plane = src + (n * 3 + c) * static_cast<long long>(H) * W;
      float v = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {     // along H first, then W
        float t = 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float g = plane[static_cast<long long>(ry[i]) * W + cx[j]];
          t = fmaf(wy[i], __fmul_rn(__fadd_rn(g, 1.0f), 0.5f), t);  // (g + 1) / 2, exact
        }
        v = fmaf(wx[j], t, v);
      }
      o[c] = __fdiv_rn(__fsub_rn(v, mean[c]), stdv[c]);
    }
  }
}

}  // namespace

// src: (N, 3, H, W) fp32 contiguous NCHW. dst: (N, 3, OH, OW) fp32 in
// channels_last memory, i.e. (N, OH, OW, 3) contiguous. OH >= H and
// OW >= W (an upsample: no antialias widening of the kernel); inv_h = H / OH
// and inv_w = W / OW as fp32. mean, std: the per-channel normalisation.
extern "C" int reid_diff_transform(const void* src, void* dst, int N, int H, int W,
                                   int OH, int OW, float inv_h, float inv_w,
                                   float m0, float m1, float m2, float s0, float s1,
                                   float s2, void* stream) {
  const int threads = 256;
  long long blocks = (static_cast<long long>(N) * OH * OW + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  diff_transform_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst), N, H, W, OH, OW,
      inv_h, inv_w, m0, m1, m2, s0, s1, s2);
  return reid::launch_status();
}
