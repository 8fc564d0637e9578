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
// 0.075 ms at 3.35 TB/s. The design streams at close to that rate:
// - The value depends only on (channel, byte) outside the rectangle and on
//   (image, channel) inside it. Each block builds the 768-entry table of
//   (b / 255 - mean[c]) / std[c] in shared memory, in the same IEEE order,
//   and each image's three erased values; no division is left per element.
// - When W % 4 == 0 a thread takes a group of four pixels: three aligned
//   32-bit words in, three float4s out. Under a flip it loads the mirrored
//   group and reverses its pixels in registers (__byte_perm), so a flip costs
//   no extra load. A warp's 32 groups are consecutive in the image, so it
//   stages its 96 float4s in shared memory and writes them back as three
//   512-byte runs, streaming (st.global.cs: 201 MB does not stay in L2).
//   Other widths (or a misaligned batch) take one pixel a thread.
// - Blocks walk chunks of 1,024 groups (or pixels) of one image, grid-
//   stride over the batch; a thread keeps its row and column by adding, so
//   the only divisions by a runtime size are one per chunk.
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;                   // groups (or pixels) a thread takes from a chunk
constexpr int kChunk = kThreads * kPerThread;
constexpr int kParams = 9;                      // erase, top, left, eh, ew, flip, fill r, g, b

struct Norm {
  float mean[3], std[3];
};

__device__ __forceinline__ float normalise(float v, float m, float s) {
  return __fdiv_rn(__fsub_rn(v, m), s);
}

// One image's draws as the kernel tests them: the rectangle's ends in fp32 as
// the reference adds them, and its three normalised fill values.
struct Draws {
  bool erase, flip;
  float top, bottom, left, right;
  float fill0, fill1, fill2;
};

__device__ __forceinline__ float fill(const Draws& d, int c) {
  return c == 0 ? d.fill0 : (c == 1 ? d.fill1 : d.fill2);
}

__device__ __forceinline__ Draws load_draws(const float* p, const Norm& nm) {
  Draws d;
  d.erase = p[0] != 0.0f;
  d.flip = p[5] != 0.0f;
  d.top = p[1];
  d.bottom = __fadd_rn(p[1], p[3]);
  d.left = p[2];
  d.right = __fadd_rn(p[2], p[4]);
  d.fill0 = d.erase ? normalise(p[6], nm.mean[0], nm.std[0]) : 0.0f;
  d.fill1 = d.erase ? normalise(p[7], nm.mean[1], nm.std[1]) : 0.0f;
  d.fill2 = d.erase ? normalise(p[8], nm.mean[2], nm.std[2]) : 0.0f;
  return d;
}

// A group of four pixels under a flip: the mirrored group's three words
// (source bytes 0-11: pixel p, channel c at 3p + c) with the pixels in
// reverse order and each pixel's channels in order.
__device__ __forceinline__ void reverse_pixels(uint32_t* w) {
  const uint32_t o0 = __byte_perm(w[1], w[2], 0x2765);                        // 9 10 11 6
  const uint32_t o1 = __byte_perm(__byte_perm(w[1], w[2], 0x0043), w[0], 0x2710);  // 7 8 3 4
  const uint32_t o2 = __byte_perm(w[0], w[1], 0x2105);                        // 5 0 1 2
  w[0] = o0;
  w[1] = o1;
  w[2] = o2;
}

__global__ void __launch_bounds__(kThreads)
fd_augment_kernel(const uint8_t* __restrict__ img, const float* __restrict__ params,
                  float* __restrict__ out, int h, int w, int vec, int chunks, int units,
                  Norm nm) {
  __shared__ float table[3 * 256];
  __shared__ float4 stage[kThreads / reid::kWarp][3 * reid::kWarp];
  for (int i = threadIdx.x; i < 3 * 256; i += kThreads) {
    const int c = i >> 8;
    table[i] = normalise(__fdiv_rn(static_cast<float>(i & 255), 255.0f), nm.mean[c], nm.std[c]);
  }
  __syncthreads();
  const int q = vec ? w / 4 : w;                // items a row: groups of four pixels, or pixels
  const int dy = kThreads / q, dx = kThreads - dy * q;
  const size_t image = static_cast<size_t>(h) * w * 3;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int n = u / chunks;
    const int first = (u - n * chunks) * kChunk + threadIdx.x;
    const Draws d = load_draws(params + n * kParams, nm);
    const uint8_t* im = img + n * image;
    float* o = out + n * image;
    int y = first / q, x = first - y * q;
    if (vec) {
      // the loads of all of a thread's groups first, then the values
      uint32_t wd[kPerThread][3];
      int ys[kPerThread], gs[kPerThread];
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        ys[k] = y;
        gs[k] = x;
        const bool ok = y < h;
        const unsigned int* src = reinterpret_cast<const unsigned int*>(
                                      im + static_cast<size_t>(ok ? y : 0) * 3 * w) +
                                  3 * (d.flip ? q - 1 - x : x);
#pragma unroll
        for (int i = 0; i < 3; ++i) wd[k][i] = ok ? __ldg(src + i) : 0u;
        x += dx;
        y += dy;
        if (x >= q) {
          x -= q;
          ++y;
        }
      }
      // a warp's groups are consecutive, so its 96 float4s are one run of
      // the image: staged through shared memory, each store instruction
      // writes 512 contiguous bytes
      const int lane = threadIdx.x % reid::kWarp;
      float4* run = stage[threadIdx.x / reid::kWarp];
      const long long end = 3LL * h * q;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        if (d.flip) reverse_pixels(wd[k]);
        const float fy = static_cast<float>(ys[k]);
        const bool row_in = d.erase && fy >= d.top && fy < d.bottom;
        float v[12];
#pragma unroll
        for (int e = 0; e < 12; ++e) {
          v[e] = table[(e % 3) * 256 + ((wd[k][e / 4] >> (8 * (e % 4))) & 255)];
          if (row_in) {
            const int px = 4 * gs[k] + e / 3;
            const float fx = static_cast<float>(d.flip ? w - 1 - px : px);
            if (fx >= d.left && fx < d.right) v[e] = fill(d, e % 3);
          }
        }
#pragma unroll
        for (int i = 0; i < 3; ++i)
          run[3 * lane + i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
        __syncwarp();
        const long long first4 = 3LL * (first + k * kThreads - lane);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const long long f4 = first4 + lane + reid::kWarp * i;
          if (f4 < end) __stcs(reinterpret_cast<float4*>(o) + f4, run[lane + reid::kWarp * i]);
        }
        __syncwarp();
      }
    } else {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        if (y < h) {
          const int sx = d.flip ? w - 1 - x : x;
          const float fy = static_cast<float>(y), fx = static_cast<float>(sx);
          const bool inside = d.erase && fy >= d.top && fy < d.bottom && fx >= d.left &&
                              fx < d.right;
          const uint8_t* src = im + (static_cast<size_t>(y) * w + sx) * 3;
          float* dst = o + (static_cast<size_t>(y) * w + x) * 3;
#pragma unroll
          for (int c = 0; c < 3; ++c)
            __stcs(dst + c, inside ? fill(d, c) : table[c * 256 + src[c]]);
        }
        x += dx;
        y += dy;
        if (x >= q) {
          x -= q;
          ++y;
        }
      }
    }
  }
}

}  // namespace

// img: (N, H, W, 3) uint8 contiguous. params: (N, 9) fp32 contiguous.
// out: (N, 3, H, W) fp32 in channels_last memory, i.e. (N, H, W, 3).
// Refuses (cudaErrorInvalidValue) an empty batch and an image or a chunk
// count past 2^31.
extern "C" int reid_fd_augment(const void* img, const void* params, void* out, int n,
                               int h, int w, float m0, float m1, float m2, float s0,
                               float s1, float s2, void* stream) {
  const long long image = 3LL * h * w;
  if (n < 1 || h < 1 || w < 1 || image > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(img) % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long per_image = vec ? image / 12 : image / 3;
  const long long chunks = (per_image + kChunk - 1) / kChunk;
  if (chunks * n > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int units = static_cast<int>(chunks * n);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fd_augment_kernel, kThreads, 0);
  const int grid =
      static_cast<int>(std::min<long long>(units, std::max(1LL, static_cast<long long>(sms) * per_sm)));
  const Norm nm = {{m0, m1, m2}, {s0, s1, s2}};
  fd_augment_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<const float*>(params),
      static_cast<float*>(out), h, w, vec, static_cast<int>(chunks), units, nm);
  return reid::launch_status();
}
