// K11: the GAN branch's conditioning map, a per-position channel L2
// normalisation of the layer4 map.
//
// Replaces: the gan_x map of reid_gan_tpu/models/resnet.py::ReIDResNet
// (resnet.py:186-187), fused by XLA into the encoder's train forward and read
// by the joint step (engine/gan_trainers.py:175-181).
//
//   out[n, :, y, x] = x[n, :, y, x] * (1 / (sqrt(sum_c x[n, c, y, x]^2) + 1e-12))
//
// with JAX's placement of the epsilon (outside the root). Forward only: on
// every mode of the JAX trainer the map's gradient is zero (train_all
// detaches it before the generator and pulls back zeros, gan_trainers.py:181,
// 233; the other modes discard it), so the port returns it detached.
//
// Bound: bytes. The map is read once and written once: 256 x 2048 x 16 x 8
// fp32 each way is 537 MB, ~160 us at 3.35 TB/s. The map is channels_last
// (the layout K5 takes), so each position's C channels are contiguous: one
// warp per position reads its row in float4s (512 B per warp instruction),
// reduces the squares with shuffles, and reads the row again from the cache
// to write the scaled values. A channel count off the vector width takes a
// scalar loop.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / reid::kWarp;

__global__ void __launch_bounds__(kThreads)
gan_feat_l2n_kernel(const float* __restrict__ x, float* __restrict__ out,
                    long long rows, int C, int vec) {
  const int lane = threadIdx.x % reid::kWarp;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock +
                        threadIdx.x / reid::kWarp;
  if (row >= rows) return;  // the whole warp leaves together
  const float* xr = x + row * C;
  float* orow = out + row * C;
  float ss = 0.0f;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int g = lane; g < C / 4; g += reid::kWarp) {
      const float4 v = x4[g];
      ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    }
  } else {
    for (int c = lane; c < C; c += reid::kWarp) ss += xr[c] * xr[c];
  }
  ss = reid::warp_sum(ss);
  const float r = 1.0f / (sqrtf(ss) + 1e-12f);
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    float4* o4 = reinterpret_cast<float4*>(orow);
    for (int g = lane; g < C / 4; g += reid::kWarp) {
      const float4 v = x4[g];
      o4[g] = make_float4(v.x * r, v.y * r, v.z * r, v.w * r);
    }
  } else {
    for (int c = lane; c < C; c += reid::kWarp) orow[c] = xr[c] * r;
  }
}

}  // namespace

// x, out: (rows, C) fp32 contiguous, rows = N * H * W positions of a
// channels_last map. vec: 1 when C % 4 == 0 and both are 16-byte aligned.
extern "C" int reid_gan_feat_l2n(const void* x, void* out, long long rows, int c,
                                 int vec, void* stream) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0) {
    gan_feat_l2n_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(out), rows, c, vec);
  }
  return reid::launch_status();
}
