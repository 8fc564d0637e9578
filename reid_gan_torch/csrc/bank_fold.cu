// K7: momentum fold of a batch into the cluster memory bank, in place.
//
// Replaces: reid_gan_tpu/ops/cluster_memory.py::update_memory (:103-204):
// the plain fold in exact batch order (_sequential_fold :149-158, and
// _occurrence_fold :161-179, which gives the same bank), the hard variant
// (_update_hard :182-203) and the GAN bank's fold (:126-129), applied after
// the optimizer step of the jitted train step.
//
// Plain: for every batch slot i in order, with y = targets[i],
//   M[y] <- u / sqrt(|u|^2 + 1e-24),   u = a * M[y] + b * xh[i]
// Hard: per label, the slot whose xh has the least dot product with the
// PRE-update M[y] (the first such slot on an exact tie) updates M[y] once.
// xh[i] = x[i] / sqrt(|x[i]|^2 + 1e-12) when normalize_x is set (the feature
// bank), x[i] as it is otherwise (the GAN bank). a = momentum, b = 1 - a,
// both passed in as the caller rounds them.
//
// Bound: bytes. It reads the batch once and reads and writes the touched bank
// rows once (B x D + 2 x labels x D fp32: 2.1 MB + 0.26 MB at B 256, D 2048,
// 16 labels; under 1 us at 3.35 TB/s). What it has to respect is the order:
// one block per label walks that label's slots in batch order, so each
// update sees the previous one, exactly as the sequential fold. A block
// finds whether its slot is the label's first occurrence by comparing with
// the earlier slots (O(B^2) compares at B 256, no sort), and only first
// occurrences do any work; blocks touch distinct rows, so there is no race.
// Each thread keeps D / 256 elements of the row in registers.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPer = 16;  // D <= kThreads * kMaxPer = 4096

__device__ __forceinline__ void load_row(const float* __restrict__ src, int D,
                                         bool normalize, float* scratch,
                                         float (&v)[kMaxPer]) {
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j) {
    const int d = threadIdx.x + j * kThreads;
    v[j] = d < D ? src[d] : 0.0f;
    ss += v[j] * v[j];
  }
  if (normalize) {
    ss = reid::block_sum(ss, scratch);
    const float r = 1.0f / sqrtf(ss + 1e-12f);
#pragma unroll
    for (int j = 0; j < kMaxPer; ++j) v[j] *= r;
  }
}

__device__ __forceinline__ void fold(float (&row)[kMaxPer], const float (&x)[kMaxPer],
                                     float a, float b, float* scratch) {
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j) {
    row[j] = __fadd_rn(__fmul_rn(a, row[j]), __fmul_rn(b, x[j]));
    ss += row[j] * row[j];
  }
  ss = reid::block_sum(ss, scratch);
  const float r = 1.0f / sqrtf(ss + 1e-24f);
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j) row[j] *= r;
}

__global__ void __launch_bounds__(kThreads)
bank_fold_kernel(float* __restrict__ bank, const float* __restrict__ x,
                 const int* __restrict__ targets, int B, int K, int D, float a,
                 float b, int use_hard, int normalize_x) {
  __shared__ float scratch[kThreads / reid::kWarp];
  const int i = blockIdx.x;
  const int y = targets[i];
  if (y < 0 || y >= K) return;  // the whole block leaves together
  bool earlier = false;
  for (int j = threadIdx.x; j < i; j += blockDim.x) earlier |= targets[j] == y;
  if (__syncthreads_or(earlier)) return;

  float* my = bank + static_cast<size_t>(y) * D;
  float row[kMaxPer], xv[kMaxPer];
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j) {
    const int d = threadIdx.x + j * kThreads;
    row[j] = d < D ? my[d] : 0.0f;
  }
  if (!use_hard) {
    for (int s = i; s < B; ++s) {
      if (targets[s] != y) continue;  // same branch for the whole block
      load_row(x + static_cast<size_t>(s) * D, D, normalize_x != 0, scratch, xv);
      fold(row, xv, a, b, scratch);
    }
  } else {
    float best = INFINITY;
    int best_s = i;
    for (int s = i; s < B; ++s) {
      if (targets[s] != y) continue;
      load_row(x + static_cast<size_t>(s) * D, D, normalize_x != 0, scratch, xv);
      float dot = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxPer; ++j) dot += xv[j] * row[j];
      dot = reid::block_sum(dot, scratch);
      if (dot < best) {  // strict: the first slot keeps an exact tie
        best = dot;
        best_s = s;
      }
    }
    load_row(x + static_cast<size_t>(best_s) * D, D, normalize_x != 0, scratch, xv);
    fold(row, xv, a, b, scratch);
  }
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j) {
    const int d = threadIdx.x + j * kThreads;
    if (d < D) my[d] = row[j];
  }
}

}  // namespace

// bank: (K, D) fp32, updated in place. x: (B, D) fp32. targets: (B,) int32;
// slots with a label outside [0, K) are skipped. D <= 4096.
extern "C" int reid_bank_fold(void* bank, const void* x, const void* targets,
                              int B, int K, int D, float a, float b,
                              int use_hard, int normalize_x, void* stream) {
  if (D > kThreads * kMaxPer) return static_cast<int>(cudaErrorInvalidValue);
  bank_fold_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(bank), static_cast<const float*>(x),
      static_cast<const int*>(targets), B, K, D, a, b, use_hard, normalize_x);
  return reid::launch_status();
}
