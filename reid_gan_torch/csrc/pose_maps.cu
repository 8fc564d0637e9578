// K10: pose keypoints -> Gaussian heatmaps for the pose generator, NCHW.
//
// Replaces: reid_gan_tpu/ops/pose.py::cords_to_map under
// batch_cords_to_map (ops/pose.py:41-59,89), rendered by XLA inside the joint
// train step (engine/gan_trainers.py:163-169) and transposed there to NHWC.
//
//   y0 = floor(y / old_h * H),  x0 = floor(x / old_w * W)      (fp32)
//   out[n, j, r, c] = exp(-((r - y0)^2 + (c - x0)^2) / (2 sigma^2))
//   out[n, j] = 0 where y or x of joint j is -1 (missing)
//
// in JAX's order of operations: the division, then the product, each
// rounded (no FMA contraction), the floor, and an IEEE division of the
// negated squared distance. The squared distances are sums of squares of
// integers, exact in fp32.
//
// Bound: bytes. The maps are written once: 256 x 18 x 128 x 64 fp32 is 151
// MB, ~45 us at 3.35 TB/s; the keypoints are 37 KB. Design, after K13: a
// block renders one map (blockIdx.x = n * K + j, so no index division). One
// thread computes the map's y0, x0 and missing flag in JAX's order and
// broadcasts them through shared memory. The block walks the map a row band
// at a time: a thread keeps one column group for all its rows, so its
// column distances are formed once and each row costs one product for dy^2.
// Where W % 4 == 0 a thread writes 4 neighbouring pixels of a row as one
// float4 (at W 64 a row is 16 float4s); otherwise one pixel a store. A
// missing joint's map is a pure zero store. Per pixel there remain one
// IEEE division and one expf, the same expression as before, so every value
// keeps its bits. The output is NCHW, the layout the port's generator reads,
// so no transpose follows.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// kVec pixels of one row a thread: 4 (a float4, W % 4 == 0) or 1.
template <int kVec>
__global__ void __launch_bounds__(kThreads)
pose_maps_kernel(const float* __restrict__ cords, const float* __restrict__ old_size,
                 float* __restrict__ out, int k, int h, int w, float two_sigma2) {
  __shared__ float s_y0, s_x0;
  __shared__ int s_missing;
  const int map = blockIdx.x;   // n * k + j
  if (threadIdx.x == 0) {
    const int n = map / k;
    const float y = cords[2 * map], x = cords[2 * map + 1];
    s_missing = y == -1.0f || x == -1.0f;
    s_y0 = floorf(__fmul_rn(__fdiv_rn(y, old_size[2 * n]), static_cast<float>(h)));
    s_x0 = floorf(__fmul_rn(__fdiv_rn(x, old_size[2 * n + 1]), static_cast<float>(w)));
  }
  __syncthreads();
  const bool missing = s_missing;
  const float y0 = s_y0, x0 = s_x0;
  // groups of kVec pixels a row; a pass covers rows_per_pass rows, or one
  // row in steps of kThreads groups when a row has more groups than threads
  const int groups = w / kVec;
  const int rows_per_pass = groups >= kThreads ? 1 : kThreads / groups;
  const int ry = groups >= kThreads ? 0 : threadIdx.x / groups;
  const int g0 = groups >= kThreads ? threadIdx.x : threadIdx.x - ry * groups;
  if (ry >= rows_per_pass) return;   // the threads past the last whole row
  float* plane = out + static_cast<size_t>(map) * h * w;
  for (int g = g0; g < groups; g += kThreads) {
    float dx2[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const float dx = static_cast<float>(g * kVec + v) - x0;
      dx2[v] = __fmul_rn(dx, dx);
    }
    for (int row = ry; row < h; row += rows_per_pass) {
      float px[kVec];
      if (missing) {
#pragma unroll
        for (int v = 0; v < kVec; ++v) px[v] = 0.0f;
      } else {
        const float dy = static_cast<float>(row) - y0;
        const float dy2 = __fmul_rn(dy, dy);
#pragma unroll
        for (int v = 0; v < kVec; ++v)
          px[v] = expf(__fdiv_rn(-__fadd_rn(dy2, dx2[v]), two_sigma2));
      }
      float* dst = plane + static_cast<size_t>(row) * w + g * kVec;
      if constexpr (kVec == 4)
        *reinterpret_cast<float4*>(dst) = make_float4(px[0], px[1], px[2], px[3]);
      else
        *dst = px[0];
    }
  }
}

}  // namespace

// cords: (N, K, 2) fp32 (y, x) in the original frame, -1 = missing.
// old_size: (N, 2) fp32 (height, width) of the original frame.
// out: (N, K, H, W) fp32 contiguous, 16-byte aligned.
extern "C" int reid_pose_maps(const void* cords, const void* old_size, void* out,
                              int n, int k, int h, int w, float two_sigma2,
                              void* stream) {
  if (n < 0 || k < 0 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long maps = static_cast<long long>(n) * k;
  if (maps == 0) return 0;
  if (maps > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cords);
  const float* o = static_cast<const float*>(old_size);
  float* dst = static_cast<float*>(out);
  const unsigned grid = static_cast<unsigned>(maps);
  if (w % 4 == 0)
    pose_maps_kernel<4><<<grid, kThreads, 0, st>>>(c, o, dst, k, h, w, two_sigma2);
  else
    pose_maps_kernel<1><<<grid, kThreads, 0, st>>>(c, o, dst, k, h, w, two_sigma2);
  return reid::launch_status();
}
