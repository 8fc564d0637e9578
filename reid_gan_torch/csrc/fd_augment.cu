// K14: FD-GAN's train transform of a uint8 batch, with given draws: random
// erasing on [0, 1] values with a drawn RGB fill, then the horizontal flip,
// then the ImageNet normalisation; no crop.
//
// Replaces: reid_gan_tpu/engine/fdgan.py::fd_train_augment (:37-45), the
// stage-I Siamese train transform, and its twin origin_aug inside
// FDGANModel._preprocess (models/fdgan/model.py:216-225); with erasing off it
// is also the stage-II/III target transform (normalize, then the flip shared
// with the pose maps, model.py:227-228,246-250). For image n with draws
// (erase, top, left, eh, ew, flip, fill r, g, b):
//
//   sx = flip ? W - 1 - x : x
//   v  = erase && top <= y < top + eh && left <= sx < left + ew
//        ? fill[c] : img[n, y, sx, c] / 255
//   out[n, c, y, x] = (v - mean[c]) / std[c]
//
// with JAX's IEEE divisions (as K1 and K9). The erase rectangle is tested in
// the unflipped frame, since JAX erases before it flips. The output is
// logical NCHW fp32 in channels_last memory, which feeds cuDNN's
// channels_last convolutions without a copy; one launch serves a whole
// (2B)-image batch of a GAN step.
//
// Bound: bytes. 512 x 256 x 128 x 3 is 50.3 MB read and 201.3 MB written,
// 0.075 ms at 3.35 TB/s. One thread a pixel: its 3 bytes in, its 3 floats
// out, so a warp reads 96 contiguous bytes and writes 384 contiguous bytes;
// the grid is (pixel blocks, images), so the image's 9 draws are a
// broadcast load and no index needs a division by the image size.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kParams = 9;  // erase, top, left, eh, ew, flip, fill r, g, b

struct Norm {
  float mean[3], std[3];
};

__global__ void __launch_bounds__(kThreads)
fd_augment_kernel(const unsigned char* __restrict__ img, const float* __restrict__ params,
                  float* __restrict__ out, int h, int w, Norm nm) {
  const int n = blockIdx.y;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= h * w) return;
  const float* p = params + n * kParams;
  const bool erase = p[0] != 0.0f, flip = p[5] != 0.0f;
  const int y = pix / w, x = pix - y * w;
  const int sx = flip ? w - 1 - x : x;
  const float fy = static_cast<float>(y), fx = static_cast<float>(sx);
  const bool inside = erase && fy >= p[1] && fy < p[1] + p[3] && fx >= p[2] &&
                      fx < p[2] + p[4];
  const size_t img_base = static_cast<size_t>(n) * h * w;
  const unsigned char* src = img + (img_base + static_cast<size_t>(y) * w + sx) * 3;
  float* dst = out + (img_base + pix) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v = inside ? p[6 + c] : __fdiv_rn(static_cast<float>(src[c]), 255.0f);
    dst[c] = __fdiv_rn(__fsub_rn(v, nm.mean[c]), nm.std[c]);
  }
}

}  // namespace

// img: (N, H, W, 3) uint8 contiguous. params: (N, 9) fp32 contiguous.
// out: (N, 3, H, W) fp32 in channels_last memory, i.e. (N, H, W, 3).
// N <= 65535 (the grid's y).
extern "C" int reid_fd_augment(const void* img, const void* params, void* out, int n,
                               int h, int w, float m0, float m1, float m2, float s0,
                               float s1, float s2, void* stream) {
  if (n < 1 || h < 1 || w < 1 || n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Norm nm = {{m0, m1, m2}, {s0, s1, s2}};
  const dim3 grid((h * w + kThreads - 1) / kThreads, n);
  fd_augment_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(img), static_cast<const float*>(params),
      static_cast<float*>(out), h, w, nm);
  return reid::launch_status();
}
