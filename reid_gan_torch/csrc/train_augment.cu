// K4: fused train augmentation, uint8 NHWC staging batch -> flip -> linear
// crop-resize -> ImageNet normalize -> random erasing with the per-image
// channel mean, as fp32 NCHW in channels_last memory (physically NHWC).
//
// Replaces: reid_gan_tpu/ops/transforms.py::reid_augment(train=True)
// (ops/transforms.py:152-157: random_hflip :59-62, random_sized_rect_crop
// :86-104 through jax.image.scale_and_translate, normalize :36-37,
// random_erasing :108-134), which XLA fused into the jitted train step. The
// random draws are made apart from this kernel (ops/transforms.py::
// sample_augment_params) and come in as ten fp32 values per image:
//   [flip, crop_top, crop_left, crop_h, crop_w,
//    erase_do, erase_top, erase_left, erase_h, erase_w].
//
// The crop follows scale_and_translate's linear ("triangle") kernel
// (jax/_src/image/scale.py:54-85) in fp32 and in its order of operations:
//   scale = out / crop, translation = -top * scale, inv = 1 / scale,
//   sample_f = (o + 0.5) * inv - translation * inv - 0.5,
//   w_i = max(0, 1 - |sample_f - i|), renormalised to sum 1,
//   zero where sample_f is outside [-0.5, size - 0.5].
// The staged image is already at the output size and the crop is never
// larger (transforms.py:97-102), so the filter always upsamples
// (kernel_scale = 1) and each output pixel has at most two taps per axis:
// the dense weight-matrix einsum of the JAX version becomes four loads.
// Products and sums are written with __fmul_rn / __fadd_rn so nvcc does not
// contract them into FMAs that the JAX arithmetic does not have; the one FMA
// that XLA's compiled sample_f does have, (o + 0.5) * inv - translation * inv
// as fma(o + 0.5, inv, -(translation * inv)), is written out, so the weights
// equal the jitted reference's bit for bit.
//
// Bound: bytes. It reads each staged byte once and writes 4 bytes per value:
// 25.2 MB + 100.7 MB at batch 256 of 256x128, ~38 us at 3.35 TB/s; about
// twenty flops per output value are far below the fp32 rate. One block per
// band of kRows output rows of one image; each thread makes whole pixels
// (3 channels, up to 4 taps of 3 bytes) and adds its normalized values to
// per-channel sums. The block writes its sums to a scratch row (no atomics,
// so the fill is the same on every run); a second launch of one block per
// image sums those rows in order, divides by H*W and writes the fill mean
// into the erase rectangle.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kRows = 4;
constexpr int kThreads = 128;
constexpr int kParams = 10;

struct Norm {
  float mean[3];
  float std[3];
};

struct Taps {
  int i0;       // first source index (may be -1 or size-1; w0/w1 are 0 there)
  float w0, w1;
};

// The linear filter's weights for one output coordinate, as
// compute_weight_mat forms them (scale.py:66-85).
__device__ __forceinline__ Taps taps(int o, float inv, float trans, int size) {
  const float f = __fsub_rn(__fmaf_rn(__fadd_rn(static_cast<float>(o), 0.5f), inv,
                                      -__fmul_rn(trans, inv)),
                            0.5f);
  Taps t;
  t.i0 = static_cast<int>(floorf(f));
  float w0 = fmaxf(0.0f, 1.0f - fabsf(__fsub_rn(f, static_cast<float>(t.i0))));
  float w1 = fmaxf(0.0f, 1.0f - fabsf(__fsub_rn(f, static_cast<float>(t.i0 + 1))));
  if (t.i0 < 0 || t.i0 >= size) w0 = 0.0f;
  if (t.i0 + 1 < 0 || t.i0 + 1 >= size) w1 = 0.0f;
  const float total = __fadd_rn(w0, w1);
  if (fabsf(total) > 1000.0f * 1.1920929e-07f) {
    w0 = __fdiv_rn(w0, total);
    w1 = __fdiv_rn(w1, total);
  } else {
    w0 = w1 = 0.0f;
  }
  if (!(f >= -0.5f && f <= static_cast<float>(size) - 0.5f)) w0 = w1 = 0.0f;
  t.w0 = w0;
  t.w1 = w1;
  return t;
}

__device__ __forceinline__ float texel(const uint8_t* img, int W, bool flip, int y,
                                       int x, int c) {
  const int sx = flip ? W - 1 - x : x;
  return __fdiv_rn(static_cast<float>(img[(y * W + sx) * 3 + c]), 255.0f);
}

__global__ void __launch_bounds__(kThreads)
train_augment_kernel(const uint8_t* __restrict__ src,
                     const float* __restrict__ params,
                     float* __restrict__ dst, float* __restrict__ partial,
                     int H, int W, Norm nm) {
  __shared__ float scratch[kThreads / reid::kWarp];
  const int n = blockIdx.y;
  const float* pr = params + n * kParams;
  const bool flip = pr[0] != 0.0f;
  const float sy = __fdiv_rn(static_cast<float>(H), pr[3]);
  const float sx = __fdiv_rn(static_cast<float>(W), pr[4]);
  const float ty = __fmul_rn(-pr[1], sy), tx = __fmul_rn(-pr[2], sx);
  const float iy = __fdiv_rn(1.0f, sy), ix = __fdiv_rn(1.0f, sx);
  const uint8_t* img = src + static_cast<size_t>(n) * H * W * 3;
  float* out = dst + static_cast<size_t>(n) * H * W * 3;
  const int y0 = blockIdx.x * kRows;
  const int rows = min(kRows, H - y0);
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int p = threadIdx.x; p < rows * W; p += blockDim.x) {
    const int oy = y0 + p / W, ox = p % W;
    const Taps ty_ = taps(oy, iy, ty, H);
    const Taps tx_ = taps(ox, ix, tx, W);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float row0 = 0.0f, row1 = 0.0f;
      if (ty_.w0 != 0.0f) {
        const float a = tx_.w0 != 0.0f ? __fmul_rn(tx_.w0, texel(img, W, flip, ty_.i0, tx_.i0, c)) : 0.0f;
        const float b = tx_.w1 != 0.0f ? __fmul_rn(tx_.w1, texel(img, W, flip, ty_.i0, tx_.i0 + 1, c)) : 0.0f;
        row0 = __fadd_rn(a, b);
      }
      if (ty_.w1 != 0.0f) {
        const float a = tx_.w0 != 0.0f ? __fmul_rn(tx_.w0, texel(img, W, flip, ty_.i0 + 1, tx_.i0, c)) : 0.0f;
        const float b = tx_.w1 != 0.0f ? __fmul_rn(tx_.w1, texel(img, W, flip, ty_.i0 + 1, tx_.i0 + 1, c)) : 0.0f;
        row1 = __fadd_rn(a, b);
      }
      const float v = __fadd_rn(__fmul_rn(ty_.w0, row0), __fmul_rn(ty_.w1, row1));
      const float z = __fdiv_rn(__fsub_rn(v, nm.mean[c]), nm.std[c]);
      out[(oy * W + ox) * 3 + c] = z;
      acc[c] += z;
    }
  }
  float* part = partial + (static_cast<size_t>(n) * gridDim.x + blockIdx.x) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float s = reid::block_sum(acc[c], scratch);
    if (threadIdx.x == 0) part[c] = s;
  }
}

__global__ void erase_fill_kernel(const float* __restrict__ params,
                                  const float* __restrict__ partial,
                                  float* __restrict__ dst, int H, int W,
                                  int nblk) {
  __shared__ float fill[3];
  const int n = blockIdx.x;
  const float* pr = params + n * kParams;
  if (pr[5] == 0.0f) return;  // the whole block leaves together
  if (threadIdx.x < 3) {
    const float* part = partial + static_cast<size_t>(n) * nblk * 3;
    float s = 0.0f;
    for (int b = 0; b < nblk; ++b) s += part[b * 3 + threadIdx.x];
    fill[threadIdx.x] = s / static_cast<float>(H * W);
  }
  __syncthreads();
  const int top = max(0, static_cast<int>(pr[6])), left = max(0, static_cast<int>(pr[7]));
  const int bottom = min(H, static_cast<int>(pr[6] + pr[8]));
  const int right = min(W, static_cast<int>(pr[7] + pr[9]));
  const int eh = bottom - top, ew = right - left;
  if (eh <= 0 || ew <= 0) return;
  float* out = dst + static_cast<size_t>(n) * H * W * 3;
  for (int p = threadIdx.x; p < eh * ew * 3; p += blockDim.x) {
    const int c = p % 3, px = p / 3;
    const int y = top + px / ew, x = left + px % ew;
    out[(y * W + x) * 3 + c] = fill[c];
  }
}

}  // namespace

// The fp32 scratch that reid_train_augment needs: three channel sums per
// band of kRows rows.
extern "C" long long reid_train_augment_scratch(int n, int h) {
  return static_cast<long long>(n) * ((h + kRows - 1) / kRows) * 3;
}

// src: (N, H, W, 3) uint8 contiguous. params: (N, 10) fp32 on the device.
// dst: (N, H, W, 3) fp32 (the channels_last NCHW output). partial:
// reid_train_augment_scratch(n, h) fp32. The output size equals the staged
// size.
extern "C" int reid_train_augment(const void* src, const void* params, void* dst,
                                  void* partial, int n, int h, int w,
                                  float m0, float m1, float m2, float s0,
                                  float s1, float s2, void* stream) {
  const Norm nm = {{m0, m1, m2}, {s0, s1, s2}};
  const int nblk = (h + kRows - 1) / kRows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  train_augment_kernel<<<dim3(nblk, n), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(src), static_cast<const float*>(params),
      static_cast<float*>(dst), static_cast<float*>(partial), h, w, nm);
  const int rc = reid::launch_status();
  if (rc != 0) return rc;
  erase_fill_kernel<<<n, 256, 0, s>>>(static_cast<const float*>(params),
                                      static_cast<const float*>(partial),
                                      static_cast<float*>(dst), h, w, nblk);
  return reid::launch_status();
}
