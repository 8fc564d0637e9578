// K13: FD-GAN's 18-channel pose maps, rendered from landmarks, with the
// per-sample sigma, erased channel and horizontal flip of a batch.
//
// Replaces: reid_gan_tpu/ops/pose.py::render_pose_peaks (ops/pose.py:62-86),
// vmapped over the batch inside FDGANModel._preprocess (models/fdgan/
// model.py:229-250) and flipped there jointly with the target. For sample n,
// joint j with landmark (ly, lx) (already scaled to the frame; -1 missing):
//
//   sx = flip[n] ? W - 1 - x : x                 (the flip of model.py:248-250)
//   dy = y - ly, dx = sx - lx                     (fp32)
//   v  = exp(-(dy^2 + dx^2) / (2 sigma^2))         2 sigma^2 formed first
//   v  = 0 unless |dy| <= r and |dx| <= r,         r = floor(4 sigma + 0.5)
//   v  = 0 where joint j is missing or j == erase[n]
//
// in JAX's order: each product and sum rounded (no FMA contraction), one IEEE
// division; exp is expf, within an ulp or two of XLA's. The output is NCHW,
// (N, 18, H, W) fp32 contiguous: the layout of the port's CustomPoseGenerator
// input and of Dp's posemap channels.
//
// Bound: bytes. The maps are written once: at the recipe's (512, 18, 256, 128)
// that is 1.208 GB, 0.361 ms at 3.35 TB/s; the landmarks are 74 KB. Design,
// after K10 (which sits at a quarter of its bound on 64-bit index division
// and an IEEE division per output): the grid is (pixel groups, maps), so the
// map index comes from blockIdx.y with no division; a thread renders 4
// neighbouring pixels of one row with 32-bit indices and stores them as one
// float4; the map's landmark, sigma, radius, drop and flip are loaded once a
// thread (the same address across the block, a broadcast). Pixels outside the
// truncation box skip the division and the exp: at sigma 5 the box is 41 x
// 41 of a 256 x 128 map, so most stores are zeros.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct MapParams {
  float ly, lx, two_sig2, rad;
  bool drop, flip;
};

__device__ __forceinline__ MapParams map_params(const float* __restrict__ lm,
                                                const float* __restrict__ sigma,
                                                const int* __restrict__ erase,
                                                const int* __restrict__ flip, int map, int k) {
  const int n = map / k, j = map - n * k;
  MapParams p;
  p.ly = lm[2 * map];
  p.lx = lm[2 * map + 1];
  const float s = sigma[n];
  p.two_sig2 = __fmul_rn(2.0f, __fmul_rn(s, s));
  p.rad = floorf(__fadd_rn(__fmul_rn(4.0f, s), 0.5f));
  p.drop = p.ly == -1.0f || p.lx == -1.0f || j == erase[n];
  p.flip = flip[n] != 0;
  return p;
}

__device__ __forceinline__ float peak(const MapParams& p, float dy, int x, int w) {
  const float sx = static_cast<float>(p.flip ? w - 1 - x : x);
  const float dx = __fsub_rn(sx, p.lx);
  if (p.drop || !(fabsf(dy) <= p.rad && fabsf(dx) <= p.rad)) return 0.0f;
  const float d2 = __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx));
  return expf(__fdiv_rn(-d2, p.two_sig2));
}

// grid (ceil(H * W / (4 * kThreads)), N * K); W % 4 == 0.
__global__ void __launch_bounds__(kThreads)
pose_peaks_vec_kernel(const float* __restrict__ lm, const float* __restrict__ sigma,
                      const int* __restrict__ erase, const int* __restrict__ flip,
                      float* __restrict__ out, int k, int h, int w) {
  const int map = blockIdx.y;
  const int plane = h * w;
  const int pix = (blockIdx.x * kThreads + threadIdx.x) * 4;
  if (pix >= plane) return;
  const MapParams p = map_params(lm, sigma, erase, flip, map, k);
  const int y = pix / w, x = pix - y * w;
  const float dy = __fsub_rn(static_cast<float>(y), p.ly);
  float4 v;
  v.x = peak(p, dy, x, w);
  v.y = peak(p, dy, x + 1, w);
  v.z = peak(p, dy, x + 2, w);
  v.w = peak(p, dy, x + 3, w);
  *reinterpret_cast<float4*>(out + static_cast<size_t>(map) * plane + pix) = v;
}

// Any W: one pixel a thread, grid (ceil(H * W / kThreads), N * K).
__global__ void __launch_bounds__(kThreads)
pose_peaks_kernel(const float* __restrict__ lm, const float* __restrict__ sigma,
                  const int* __restrict__ erase, const int* __restrict__ flip,
                  float* __restrict__ out, int k, int h, int w) {
  const int map = blockIdx.y;
  const int plane = h * w;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= plane) return;
  const MapParams p = map_params(lm, sigma, erase, flip, map, k);
  const int y = pix / w, x = pix - y * w;
  out[static_cast<size_t>(map) * plane + pix] =
      peak(p, __fsub_rn(static_cast<float>(y), p.ly), x, w);
}

}  // namespace

// lm: (N, K, 2) fp32 (y, x) in the output frame, -1 = missing. sigma: (N,)
// fp32. erase: (N,) int32 channel to zero, -1 for none. flip: (N,) int32,
// nonzero mirrors the columns. out: (N, K, H, W) fp32 contiguous, 16-byte
// aligned. N * K <= 65535 (the grid's y).
extern "C" int reid_pose_peaks(const void* lm, const void* sigma, const void* erase,
                               const void* flip, void* out, int n, int k, int h, int w,
                               void* stream) {
  if (n < 1 || k < 1 || h < 1 || w < 1 || n * k > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int plane = h * w;
  const float* l = static_cast<const float*>(lm);
  const float* s = static_cast<const float*>(sigma);
  const int* e = static_cast<const int*>(erase);
  const int* f = static_cast<const int*>(flip);
  float* o = static_cast<float*>(out);
  if (w % 4 == 0) {
    const dim3 grid((plane / 4 + kThreads - 1) / kThreads, n * k);
    pose_peaks_vec_kernel<<<grid, kThreads, 0, st>>>(l, s, e, f, o, k, h, w);
  } else {
    const dim3 grid((plane + kThreads - 1) / kThreads, n * k);
    pose_peaks_kernel<<<grid, kThreads, 0, st>>>(l, s, e, f, o, k, h, w);
  }
  return reid::launch_status();
}
