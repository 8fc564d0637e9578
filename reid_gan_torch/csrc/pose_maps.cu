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
// MB, ~45 us at 3.35 TB/s; the keypoints are 37 KB. One thread per output
// pixel over a grid-stride loop, so the stores are coalesced along each row;
// a thread's joint and its scale come from the L1 cache, shared by the
// thousands of threads of that map. The output is NCHW, the layout the
// port's generator reads, so no transpose follows.
#include "common.cuh"

namespace {

__global__ void pose_maps_kernel(const float* __restrict__ cords,
                                 const float* __restrict__ old_size,
                                 float* __restrict__ out, long long total,
                                 int k, int h, int w, float two_sigma2) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long plane = static_cast<long long>(h) * w;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += stride) {
    const long long map = i / plane;            // n * k + j
    const int pix = static_cast<int>(i - map * plane);
    const int row = pix / w, col = pix - row * w;
    const long long n = map / k;
    const float y = cords[2 * map], x = cords[2 * map + 1];
    float v = 0.0f;
    if (y != -1.0f && x != -1.0f) {
      const float y0 = floorf(__fmul_rn(__fdiv_rn(y, old_size[2 * n]),
                                        static_cast<float>(h)));
      const float x0 = floorf(__fmul_rn(__fdiv_rn(x, old_size[2 * n + 1]),
                                        static_cast<float>(w)));
      const float dy = static_cast<float>(row) - y0;
      const float dx = static_cast<float>(col) - x0;
      const float d2 = __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx));
      v = expf(__fdiv_rn(-d2, two_sigma2));
    }
    out[i] = v;
  }
}

}  // namespace

// cords: (N, K, 2) fp32 (y, x) in the original frame, -1 = missing.
// old_size: (N, 2) fp32 (height, width) of the original frame.
// out: (N, K, H, W) fp32 contiguous.
extern "C" int reid_pose_maps(const void* cords, const void* old_size, void* out,
                              int n, int k, int h, int w, float two_sigma2,
                              void* stream) {
  const long long total = static_cast<long long>(n) * k * h * w;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  pose_maps_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cords), static_cast<const float*>(old_size),
      static_cast<float*>(out), total, k, h, w, two_sigma2);
  return reid::launch_status();
}
