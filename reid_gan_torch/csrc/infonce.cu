// K6: InfoNCE against the cluster memory bank, forward and backward.
//
// Replaces: reid_gan_tpu/ops/cluster_memory.py::memory_loss (:58-100, the
// plain-XLA successor of the retired Pallas kernel
// ops/pallas/infonce.py::fused_infonce, e1b076a:...infonce.py:120 forward and
// :165 backward) and its gradient to x, inside the jitted train step.
//
// Forward, for a batch x (B, D) and a bank M (K, D) of which the first
// num_valid rows are live, and T extra negatives ex (T, D) (memory_loss's
// ex_f, cluster_memory.py:86-95; T = 0 without them):
//   r[b]          = 1 / sqrt(sum_d x[b,d]^2 + 1e-12)   (epsilon inside the root)
//   xh[b]         = x[b] * r[b];  exh[t] = ex[t] / sqrt(sum_d ex[t,d]^2 + 1e-12)
//   logits[b,k]   = (xh[b] . M[k]) / temp, or -inf for k >= num_valid
//   logits[b,K+t] = (xh[b] . exh[t] + (b / group == t ? -10000 : 0)) / temp
//   lse[b]        = log sum_k exp(logits[b,k]);  loss[b] = lse[b] - logits[b,y_b]
// with the row LSE merged over the bank's column tiles first, then the
// extra columns' tiles, in order. The logits are (B, K + T). Backward, for
// g = dL/dloss (B,), to x only (ex is a constant):
//   dl[b,k] = (exp(logits[b,k] - lse[b]) - [k == y_b]) * g[b] / temp
//   dxh     = dl[:, :K] . M + dl[:, K:] . exh            (B, D)
//   dx[b]   = r[b] * (dxh[b] - xh[b] * (xh[b] . dxh[b]))
// The extra columns ride in the same launches as the bank's: ex's row norms
// beside x's, their column tile after the bank's tiles in the logits grid,
// their rows after the bank's in the backward's k loop. Without extra
// columns every kernel does the arithmetic it did before they were added,
// in the same order.
//
// Bound: operations. Each product is 2*B*nv*D flops (nv = num_valid): at
// B 256, D 2048 and nv 700 that is 734 MFLOP, ~11 us at 67 TFLOP/s fp32,
// against ~9 MB of traffic (~3 us). Both products are plain tiled fp32 FMA
// loops in shared memory (a 32x64 output tile per 128-thread block, 4x4 per
// thread, depth 16 per stage); tensor cores are later work. Column tiles at
// or past num_valid (read on the device, no host sync) skip the product.
// The forward's online softmax is split by column tile: each block writes
// the max and the sum of exp of its 64 columns per row, and one block per
// row merges the tiles in order, so the result does not depend on which
// block ran first. The backward forms dl on the fly from the saved logits
// and lse as it stages each tile, and chains through the normalisation in a
// last pass with one block per row.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTM = 32;       // rows of x per tile
constexpr int kTN = 64;       // columns (bank rows, or D in the backward)
constexpr int kTD = 16;       // reduction depth per stage
constexpr int kThreads = 128;
constexpr int kRowThreads = 256;

// Row L2 normalisation of x's B rows (block b < B, which also stores 1/|x|)
// and of ex's rows after them (block B + t).
__global__ void __launch_bounds__(kRowThreads)
l2n_rows_kernel(const float* __restrict__ x, float* __restrict__ xh,
                float* __restrict__ rnorm, int B, const float* __restrict__ ex,
                float* __restrict__ exh, int D) {
  __shared__ float scratch[kRowThreads / reid::kWarp];
  const bool is_x = static_cast<int>(blockIdx.x) < B;
  const size_t row = is_x ? blockIdx.x : blockIdx.x - B;
  const float* xr = (is_x ? x : ex) + row * D;
  float ss = 0.0f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) ss += xr[d] * xr[d];
  ss = reid::block_sum(ss, scratch);
  const float r = 1.0f / sqrtf(ss + 1e-12f);
  float* o = (is_x ? xh : exh) + row * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) o[d] = xr[d] * r;
  if (threadIdx.x == 0 && is_x) rnorm[row] = r;
}

// logits tile (kTM rows of xh) x (kTN columns) and its per-row softmax
// partials. Column tiles below ceil(K / kTN) take the bank's rows, of which
// the first num_valid are live; the tiles after them take the T extra rows
// exh, all live, with the additive self-mask (row b / group == column t gets
// -10000), stored from column K of logits rows of K + T floats. xh and the
// rows are row-major with D contiguous (D % 4 == 0).
__global__ void __launch_bounds__(kThreads)
logits_kernel(const float* __restrict__ xh, const float* __restrict__ bank,
              const int* __restrict__ num_valid, int K, const float* __restrict__ exh,
              int T, int group, int B, int D, float temp, float* __restrict__ logits,
              float* __restrict__ part_m, float* __restrict__ part_s) {
  __shared__ float As[kTD][kTM];
  __shared__ __align__(16) float Bs[kTD][kTN];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int tiles = (K + kTN - 1) / kTN, ld = K + T;
  const bool is_ex = static_cast<int>(blockIdx.x) >= tiles;
  const float* __restrict__ rows = is_ex ? exh : bank;
  const int ncols = is_ex ? T : K, col0 = is_ex ? K : 0;
  const int b0 = blockIdx.y * kTM, k0 = (is_ex ? blockIdx.x - tiles : blockIdx.x) * kTN;
  const int nv = is_ex ? T : min(*num_valid, K);
  float acc[4][4] = {};
  if (k0 < nv) {
    for (int d0 = 0; d0 < D; d0 += kTD) {
      {  // A: kTM x kTD, one float4 per thread
        const int row = tid / 4, dq = (tid % 4) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (b0 + row < B && d0 + dq < D)
          v = *reinterpret_cast<const float4*>(xh + static_cast<size_t>(b0 + row) * D + d0 + dq);
        As[dq][row] = v.x; As[dq + 1][row] = v.y; As[dq + 2][row] = v.z; As[dq + 3][row] = v.w;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // B: kTN x kTD, two float4 per thread
        const int col = tid / 4 + h * 32, dq = (tid % 4) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + col < nv && d0 + dq < D)
          v = *reinterpret_cast<const float4*>(rows + static_cast<size_t>(k0 + col) * D + d0 + dq);
        Bs[dq][col] = v.x; Bs[dq + 1][col] = v.y; Bs[dq + 2][col] = v.z; Bs[dq + 3][col] = v.w;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTD; ++kk) {
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = As[kk][ty * 4 + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, bb[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + ty * 4 + i;
    float l[4];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx * 4 + j;
      const float a = is_ex ? acc[i][j] + (b / group == k ? -10000.0f : 0.0f)
                            : acc[i][j];
      l[j] = k < nv ? a / temp : -INFINITY;
      if (b < B && k < ncols) logits[static_cast<size_t>(b) * ld + col0 + k] = l[j];
      m = fmaxf(m, l[j]);
    }
    // the 16 threads of a row are one half-warp (lanes tx = 0..15)
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float s = 0.0f;
    if (m != -INFINITY) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s += expf(l[j] - m);  // exp(-inf) = 0
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (tx == 0 && b < B) {
      part_m[static_cast<size_t>(blockIdx.x) * B + b] = m;
      part_s[static_cast<size_t>(blockIdx.x) * B + b] = s;
    }
  }
}

__global__ void __launch_bounds__(kRowThreads)
lse_loss_kernel(const float* __restrict__ part_m, const float* __restrict__ part_s,
                const float* __restrict__ logits, const int* __restrict__ targets,
                int B, int K, int ld, int splits, float* __restrict__ lse,
                float* __restrict__ loss) {
  __shared__ float scratch[kRowThreads / reid::kWarp];
  const int b = blockIdx.x;
  float m = -INFINITY;
  for (int t = threadIdx.x; t < splits; t += blockDim.x)
    m = fmaxf(m, part_m[static_cast<size_t>(t) * B + b]);
  m = reid::block_max(m, scratch);
  float s = 0.0f;
  if (m != -INFINITY) {
    for (int t = threadIdx.x; t < splits; t += blockDim.x) {
      const float mt = part_m[static_cast<size_t>(t) * B + b];
      if (mt != -INFINITY) s += part_s[static_cast<size_t>(t) * B + b] * expf(mt - m);
    }
  }
  s = reid::block_sum(s, scratch);
  if (threadIdx.x == 0) {
    const float z = m + logf(s);
    const int y = targets[b];
    lse[b] = z;
    loss[b] = (y >= 0 && y < K) ? z - logits[static_cast<size_t>(b) * ld + y]
                                  : __int_as_float(0x7fc00000);  // NaN
  }
}

// Adds dl[:, col0 : col0 + n] . rows[0 : n] to a thread's 4x4 of the dxh
// tile: logits rows of ld floats; `targets` null for columns that are never
// a target (the extra negatives).
__device__ __forceinline__ void dl_rows_product(
    float (&acc)[4][4], float (&As)[kTD][kTM], float (&Bs)[kTD][kTN],
    const float* __restrict__ rows, int n, int col0, const int* __restrict__ targets,
    const float* __restrict__ logits, const float* __restrict__ lse,
    const float* __restrict__ grad, int B, int ld, int D, float temp, int b0, int d0) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  for (int k0 = 0; k0 < n; k0 += kTD) {
#pragma unroll
    for (int h = 0; h < (kTM * kTD) / kThreads; ++h) {  // A: dl, kTM x kTD
      const int e = tid + h * kThreads, row = e / kTD, kk = e % kTD;
      const int b = b0 + row, k = k0 + kk;
      float v = 0.0f;
      if (b < B && k < n) {
        const float p = expf(logits[static_cast<size_t>(b) * ld + col0 + k] - lse[b]);
        const bool hit = targets != nullptr && k == targets[b];
        v = (p - (hit ? 1.0f : 0.0f)) * grad[b] / temp;
      }
      As[kk][row] = v;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // B: kTD rows x kTN of D
      const int e = tid + h * kThreads, kk = e / 16, dq = (e % 16) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + kk < n && d0 + dq < D)
        v = *reinterpret_cast<const float4*>(rows + static_cast<size_t>(k0 + kk) * D + d0 + dq);
      *reinterpret_cast<float4*>(&Bs[kk][dq]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTD; ++kk) {
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = As[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, bb[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
}

// dxh tile (kTM rows) x (kTN of D) = dl . M over the live bank rows, then
// + dl . exh over the T extra negatives.
__global__ void __launch_bounds__(kThreads)
dxh_kernel(const float* __restrict__ bank, const int* __restrict__ num_valid,
           const int* __restrict__ targets, const float* __restrict__ logits,
           const float* __restrict__ lse, const float* __restrict__ grad,
           const float* __restrict__ exh, int T, int B, int K, int D, float temp,
           float* __restrict__ dxh) {
  __shared__ float As[kTD][kTM];
  __shared__ __align__(16) float Bs[kTD][kTN];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int b0 = blockIdx.y * kTM, d0 = blockIdx.x * kTN;
  const int nv = min(*num_valid, K), ld = K + T;
  float acc[4][4] = {};
  dl_rows_product(acc, As, Bs, bank, nv, 0, targets, logits, lse, grad, B, ld, D,
                  temp, b0, d0);
  if (T > 0)
    dl_rows_product(acc, As, Bs, exh, T, K, nullptr, logits, lse, grad, B, ld, D,
                    temp, b0, d0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + ty * 4 + i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + tx * 4 + j;
      if (d < D) dxh[static_cast<size_t>(b) * D + d] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kRowThreads)
l2n_backward_kernel(const float* __restrict__ xh, const float* __restrict__ rnorm,
                    const float* __restrict__ dxh, int D, float* __restrict__ dx) {
  __shared__ float scratch[kRowThreads / reid::kWarp];
  const size_t row = static_cast<size_t>(blockIdx.x) * D;
  float dot = 0.0f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) dot += xh[row + d] * dxh[row + d];
  dot = reid::block_sum(dot, scratch);
  const float r = rnorm[blockIdx.x];
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    dx[row + d] = r * (dxh[row + d] - xh[row + d] * dot);
}

}  // namespace

// The fp32 scratch of each of part_m and part_s of reid_infonce_forward for
// K columns: a running max and sum per row and column tile of kTN columns.
// With T extra columns the forward takes scratch(B, K) + scratch(B, T).
extern "C" long long reid_infonce_forward_scratch(int B, int K) {
  return static_cast<long long>((K + kTN - 1) / kTN) * B;
}

// x: (B, D) fp32; bank: (K, D) fp32; ex: (T, D) fp32 or null with T = 0;
// all contiguous, 16-byte aligned, D % 4 == 0. num_valid: one int32 on the
// device; targets: (B,) int32 in [0, K); group: the extra columns' self-mask
// group (> 0 when T > 0).
// Outputs: xh (B, D), rnorm (B,), exh (T, D), logits (B, K + T), lse (B,),
// loss (B,); a target outside [0, K) gives a NaN loss.
// part_m, part_s: reid_infonce_forward_scratch(B, K) + ..._scratch(B, T)
// fp32 each.
extern "C" int reid_infonce_forward(const void* x, const void* bank,
                                    const void* num_valid, const void* targets,
                                    int B, int K, int D, float temp, const void* ex,
                                    int T, int group, void* xh, void* rnorm,
                                    void* exh, void* logits, void* part_m,
                                    void* part_s, void* lse, void* loss,
                                    void* stream) {
  const int tiles = (K + kTN - 1) / kTN + (T + kTN - 1) / kTN;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  l2n_rows_kernel<<<B + T, kRowThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<float*>(xh), static_cast<float*>(rnorm),
      B, static_cast<const float*>(ex), static_cast<float*>(exh), D);
  int rc = reid::launch_status();
  if (rc != 0) return rc;
  logits_kernel<<<dim3(tiles, (B + kTM - 1) / kTM), kThreads, 0, st>>>(
      static_cast<const float*>(xh), static_cast<const float*>(bank),
      static_cast<const int*>(num_valid), K, static_cast<const float*>(exh), T, group, B,
      D, temp, static_cast<float*>(logits), static_cast<float*>(part_m),
      static_cast<float*>(part_s));
  rc = reid::launch_status();
  if (rc != 0) return rc;
  lse_loss_kernel<<<B, kRowThreads, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_s),
      static_cast<const float*>(logits), static_cast<const int*>(targets), B, K, K + T,
      tiles, static_cast<float*>(lse), static_cast<float*>(loss));
  return reid::launch_status();
}

// grad: (B,) fp32 = dL/dloss. exh: the forward's (T, D), or null with T = 0.
// dxh: scratch (B, D) fp32. dx: (B, D) fp32.
extern "C" int reid_infonce_backward(const void* xh, const void* rnorm,
                                     const void* bank, const void* num_valid,
                                     const void* targets, const void* logits,
                                     const void* lse, const void* grad, int B,
                                     int K, int D, float temp, const void* exh,
                                     int T, void* dxh, void* dx, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dxh_kernel<<<dim3((D + kTN - 1) / kTN, (B + kTM - 1) / kTM), kThreads, 0, st>>>(
      static_cast<const float*>(bank), static_cast<const int*>(num_valid),
      static_cast<const int*>(targets), static_cast<const float*>(logits),
      static_cast<const float*>(lse), static_cast<const float*>(grad),
      static_cast<const float*>(exh), T, B, K, D, temp, static_cast<float*>(dxh));
  const int rc = reid::launch_status();
  if (rc != 0) return rc;
  l2n_backward_kernel<<<B, kRowThreads, 0, st>>>(
      static_cast<const float*>(xh), static_cast<const float*>(rnorm),
      static_cast<const float*>(dxh), D, static_cast<float*>(dx));
  return reid::launch_status();
}
