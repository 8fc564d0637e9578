// K2: eval feature head, GeM pooling + scale-only feat_bn + L2 normalisation,
// from the layer4 map in one pass.
//
// Replaces: the eval head of reid_gan_tpu/models/resnet.py::ReIDResNet
// (resnet.py:183 upcast, :189 GeneralizedMeanPooling from
// models/pooling.py:18-25, :199-206 TorchBatchNorm eval without bias, :255-256
// _l2n), which XLA fused into the extractor program.
//
//   pooled[c] = (mean_s max(x[s, c], eps)^p)^(1/p)       p = learned gap.p
//   z[c]      = (pooled[c] - mu[c]) * (1 / sqrt(var[c] + bn_eps)) * gamma[c]
//   out[c]    = z[c] * (1 / (sqrt(sum_c z[c]^2) + 1e-12))  (epsilon outside)
//
// Bound: bytes. The map is read once (N x S x C fp32: 268 MB for 256 images
// of 16x8x2048, ~80 us at 3.35 TB/s; 16.8 MB, ~5 us, for the hard-mix
// step's re-encode of 16 images). On an NVIDIA H100 80GB HBM3 at 700 W
// (`chip_smoke.py --kernels K2 .`) it takes 0.0955 ms at N 256 and 0.0147
// ms at N 16 with the map in L2.
//
// Design. The pass over the map is K5's forward (gem_pool.cu): a block
// covers one image and a chunk of 128 channels, a lane one float4 of four
// channels (a warp reads 512 contiguous bytes a position of the
// channels_last map), and the block's 8 warps take every 8th position each,
// four streaming loads ahead; each element costs one lg2 and one ex2
// (sfu_math.cuh) and the warps' sums meet in shared memory in warp order.
// So the card is full at both shapes: 2,048 blocks at N 256, 256 at N 16.
// The L2 norm needs the image's whole row of C channels, so an image's
// chunks form one thread block cluster (16 blocks at C 2048, or 8 of two
// chunks each once the grid outnumbers the blocks the card holds at once;
// a block takes chunks rank, rank + cluster, ..): each block leaves its
// partial sum of z^2 in shared memory, and after a cluster barrier each
// block reads the partials through distributed shared memory (a lane a
// block, all at once) and adds them in rank order, scales its z and stores
// it. No atomics: every block adds the same partials in the same order, so
// the output is the same bits on every run. The per-channel tail (powf for
// the 1/p root, the BatchNorm scale with IEEE division) runs 2,048 times an
// image, a channel a thread over 128 threads, and keeps the original
// expressions; its BatchNorm values are loaded before the stream. p is read
// on the device, so the wrapper never waits on the card.
#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"
#include "sfu_math.cuh"

namespace {

using reid::ex2;
using reid::lg2;

constexpr int kGroups = 32;                   // float4 channel groups a chunk
constexpr int kSplit = 8;                     // warps, each every 8th position
constexpr int kThreads = kGroups * kSplit;    // 256
constexpr int kBlocksPerSm = 6;               // the launch bound (40 registers)
constexpr int kMaxCluster = 16;               // a non-portable cluster size
constexpr int kBusyCluster = 8;               // once the grid outnumbers the card
constexpr int kChunk = 4 * kGroups;           // channels a chunk
constexpr int kMaxChunks = 6;                 // a block's chunks: C <= 12,288

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// grid (N * cluster), cluster (cluster): block rank r of image n takes the
// chunks r, r + cluster, .. of ceil(C / 4 / kGroups).
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
gem_bn_l2n_kernel(const float* __restrict__ x, const float* __restrict__ p_ptr,
                  const float* __restrict__ gamma,
                  const float* __restrict__ mean,
                  const float* __restrict__ var, float* __restrict__ out,
                  int S, int C, float gem_eps, float bn_eps) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ float4 red[kSplit][kGroups];
  __shared__ float zs[kMaxChunks][kChunk];   // this block's z, chunk by chunk
  __shared__ float wsum[kChunk / reid::kWarp];
  __shared__ float partial;                  // this block's sum of z^2
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = blockIdx.x / csize;
  const int lane = threadIdx.x % kGroups, w = threadIdx.x / kGroups;
  const int c4 = C / 4, chunks = (c4 + kGroups - 1) / kGroups;
  const float p = *p_ptr, inv_p = 1.0f / p;
  const float4* xi = reinterpret_cast<const float4*>(x) + static_cast<size_t>(n) * S * c4;
  const float* redf = reinterpret_cast<const float*>(red);
  float ss = 0.0f;   // threads < kChunk: their channel's z^2, chunk after chunk
  int mine = 0;
  for (int ch = rank; ch < chunks; ch += csize, ++mine) {
    const int g = ch * kGroups + lane, c = ch * kChunk + threadIdx.x;
    float mu = 0.0f, va = 0.0f, ga = 0.0f;   // the tail's channel, loaded ahead
    if (threadIdx.x < kChunk && c < C) {
      mu = mean[c];
      va = var[c];
      ga = gamma[c];
    }
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g < c4) {
#pragma unroll 4
      for (int s = w; s < S; s += kSplit) {
        const float4 v = __ldcs(xi + static_cast<size_t>(s) * c4 + g);
        a.x += ex2(p * lg2(fmaxf(v.x, gem_eps)));
        a.y += ex2(p * lg2(fmaxf(v.y, gem_eps)));
        a.z += ex2(p * lg2(fmaxf(v.z, gem_eps)));
        a.w += ex2(p * lg2(fmaxf(v.w, gem_eps)));
      }
    }
    red[w][lane] = a;
    __syncthreads();
    if (threadIdx.x < kChunk) {   // a channel a thread: its warps' sums in warp order
      float sum = redf[threadIdx.x];
#pragma unroll
      for (int i = 1; i < kSplit; ++i) sum += redf[i * kChunk + threadIdx.x];
      float zc = 0.0f;
      if (c < C) {
        const float pooled = powf(sum / static_cast<float>(S), inv_p);
        zc = (pooled - mu) * (1.0f / sqrtf(va + bn_eps)) * ga;
      }
      zs[mine][threadIdx.x] = zc;
      ss += zc * zc;
    }
    __syncthreads();   // red is taken again by the next chunk
  }
  if (threadIdx.x < kChunk) {
    ss = reid::warp_sum(ss);
    if (lane == 0) wsum[w] = ss;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = wsum[0];
#pragma unroll
    for (int i = 1; i < kChunk / reid::kWarp; ++i) t += wsum[i];
    partial = t;
  }
  cluster.sync();   // every block's partial is in its shared memory
  float inv = 0.0f;
  if (threadIdx.x < kChunk) {   // each storing warp reads the partials, in rank order
    const float mine_r = lane < csize ? *cluster.map_shared_rank(&partial, lane) : 0.0f;
    float total = 0.0f;
    for (int r = 0; r < csize; ++r) total += __shfl_sync(0xffffffffu, mine_r, r);
    inv = 1.0f / (sqrtf(total) + 1e-12f);
  }
  cluster_arrive();   // this block has read the others' partials
  if (threadIdx.x < kChunk) {
    float* oi = out + static_cast<size_t>(n) * C;
    for (int i = 0; i < mine; ++i) {
      const int c = (rank + i * csize) * kChunk + threadIdx.x;
      if (c < C) oi[c] = zs[i][threadIdx.x] * inv;
    }
  }
  cluster_wait();   // no block leaves while another may still read its partial
}

}  // namespace

// x: (N, S, C) fp32 contiguous (the channels_last map), 16-byte aligned,
// C % 4 == 0, C <= 12,288, S >= 1. p: one fp32 on the device.
// gamma/mean/var: C fp32. out: (N, C), 16-byte aligned.
extern "C" int reid_gem_bn_l2n(const void* x, const void* p, const void* gamma,
                               const void* mean, const void* var, void* out,
                               int n, int s, int c, float gem_eps,
                               float bn_eps, void* stream) {
  if (c <= 0 || c % 4 || s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  int dev = 0, sms = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc == 0)
    rc = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (rc != 0) return rc;
  // Clusters of 16 fill the card when images are few; when the blocks of
  // one chunk each outnumber what the card holds at once, clusters of 8
  // (a block two chunks) halve the barriers for the same stream.
  const int chunks = (c / 4 + kGroups - 1) / kGroups;
  const int most = static_cast<long long>(n) * chunks > static_cast<long long>(kBlocksPerSm) * sms
                       ? kBusyCluster : kMaxCluster;
  const int csize = chunks < most ? chunks : most;
  if ((chunks + csize - 1) / csize > kMaxChunks) return static_cast<int>(cudaErrorInvalidValue);
  rc = static_cast<int>(cudaFuncSetAttribute(
      gem_bn_l2n_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n) * csize);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = static_cast<int>(cudaLaunchKernelEx(
      &cfg, gem_bn_l2n_kernel, static_cast<const float*>(x),
      static_cast<const float*>(p), static_cast<const float*>(gamma),
      static_cast<const float*>(mean), static_cast<const float*>(var),
      static_cast<float*>(out), s, c, gem_eps, bn_eps));
  return rc != 0 ? rc : reid::launch_status();
}
