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
// 16 labels; under 1 us at 3.35 TB/s). What limits it is the order: each
// label's slots fold in batch order, each update on the row the previous one
// left, a chain of c steps (16 at the recipe's P x K batch, B at one label).
// On an NVIDIA H100 80GB HBM3 at 700 W (`chip_smoke.py --kernels K7 .`)
// the P x K fold takes 0.0161 ms, both banks together as long, and a
// 256-deep chain 0.164 ms: about 1,050 cycles a chain step
// (`scripts/torch_fold_pool_probe.py --phases`).
//
// Design. One block a (bank, label): the block of the label's first slot
// (it compares its label with the earlier slots' and the others leave), so
// blocks touch distinct rows and need no atomics. Both banks fold in one
// launch: block 2i + 1 folds the GAN bank for slot i when there is one, next
// to the feature bank's block 2i. The block collects the label's slots in
// batch order and stages their rows of x into shared memory, each row a
// bulk copy that completes on its own mbarrier, so the chain starts as soon
// as the first row lands; a label with more slots than the staging holds
// streams them in two alternating halves, the next half's copies in flight
// during this one's chain. The chain is then, a step, one pass from shared
// memory over the row the block holds in registers (128 threads, D / 128
// elements each: with few warps the step's shuffles and its reads of the
// warps' partials stay short) and one block reduction with one barrier
// (the partials go to one of two alternating slots of scratch): the folded
// row's norm, with the squares of the next staged row of x riding in the
// same reduction, so that row's normalisation costs the chain nothing; the
// next row is loaded into registers a step ahead. The per-element
// arithmetic is the original's (__fmul_rn / __fadd_rn of a * row + b * xh,
// then 1 / sqrtf(ss + 1e-24)). The hard variant has no chain: a warp a
// staged row forms its norm and its dot with the pre-update row, all rows
// in parallel, then the least dot with a strict < in batch order folds
// once.
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / reid::kWarp;
constexpr int kMaxD = 4096;
constexpr int kMaxStage = 64;                  // staged rows at most (small D)
constexpr int kSmemBytes = 216 * 1024;         // the pre-update row, then the stage
constexpr int kLoad = INT_MIN;                 // collect(): no preloaded window

struct Bank {
  float* rows;        // (K, D), updated in place
  const float* x;     // (B, D)
  int K, D;
  bool normalize;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Waits until the row on this barrier has landed (the barrier's phase of
// parity `phase` completed).
__device__ __forceinline__ void wait_row(uint64_t* bar, int phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(phase) : "memory");
  }
}

// t[0] <- the sum of t[0 .. 2H), as a tree (unrolled: t stays in registers).
template <int H>
__device__ __forceinline__ void tree_sum(float2 (&t)[kWarps]) {
  if constexpr (H > 0) {
#pragma unroll
    for (int w = 0; w < H; ++w) {
      t[w].x += t[w + H].x;
      t[w].y += t[w + H].y;
    }
    tree_sum<H / 2>(t);
  }
}

// Two sums over the block with one barrier; every thread gets both. The
// warps' partials go to scratch[parity] and are added as a tree in a fixed
// order, and the parity flips: the slot a call writes was last read two
// calls ago, before the barrier of the call in between.
__device__ __forceinline__ float2 chain_sum(float2 v, float2 (&scratch)[2][kWarps], int& parity) {
#pragma unroll
  for (int o = reid::kWarp / 2; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  if (threadIdx.x % reid::kWarp == 0) scratch[parity][threadIdx.x / reid::kWarp] = v;
  __syncthreads();
  float2 t[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t[w] = scratch[parity][w];
  tree_sum<kWarps / 2>(t);
  parity ^= 1;
  return t[0];
}

// Thread t's elements t, t + kThreads, .. of a row (0 past D), and the sum
// of their squares.
template <int kPer>
__device__ __forceinline__ float load_row(float (&v)[kPer], const float* src, int D) {
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int d = threadIdx.x + j * kThreads;
    v[j] = d < D ? src[d] : 0.0f;
    ss += v[j] * v[j];
  }
  return ss;
}

// One fold of xh = x * r into the row, then its normalisation, in the
// original's arithmetic; `next` (thread partials of a second sum) rides in
// the same block reduction, whose total is returned.
template <int kPer>
__device__ __forceinline__ float fold(float (&row)[kPer], const float (&x)[kPer], float r,
                                      float a, float b, float next,
                                      float2 (&scratch)[2][kWarps], int& parity) {
  float ss[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // four chains, added in a fixed order
#pragma unroll
  for (int j = 0; j < kPer; ++j) {   // past D, row and x are 0 and stay 0
    row[j] = __fadd_rn(__fmul_rn(a, row[j]), __fmul_rn(b, x[j] * r));
    ss[j % 4] += row[j] * row[j];
  }
  const float2 tot = chain_sum(make_float2((ss[0] + ss[1]) + (ss[2] + ss[3]), next), scratch,
                               parity);
  const float inv = 1.0f / sqrtf(tot.x + 1e-24f);
#pragma unroll
  for (int j = 0; j < kPer; ++j) row[j] *= inv;
  return tot.y;
}

// Folds the m staged rows into the row, in order, each as soon as its copy
// has landed. Each step loads the next staged row ahead into registers, and
// its squares ride in the step's reduction, so the chain holds one block
// reduction a step.
template <int kPer>
__device__ __forceinline__ void chain(float (&row)[kPer], const float* rows_s, uint64_t* bars,
                                      int phase, int m, int D, bool normalize, float a, float b,
                                      float2 (&scratch)[2][kWarps], int& parity) {
  float xc[kPer], xn[kPer] = {};
  wait_row(bars, phase);
  float sx = load_row(xc, rows_s, D);
  if (normalize) sx = chain_sum(make_float2(sx, 0.0f), scratch, parity).x;
  for (int k = 0; k < m; ++k) {
    const float r = normalize ? 1.0f / sqrtf(sx + 1e-12f) : 1.0f;
    float sn = 0.0f;
    if (k + 1 < m) {
      wait_row(bars + k + 1, phase);
      sn = load_row(xn, rows_s + static_cast<size_t>(k + 1) * D, D);
    }
    sx = fold(row, xc, r, a, b, sn, scratch, parity);
#pragma unroll
    for (int j = 0; j < kPer; ++j) xc[j] = xn[j];
  }
}

// Appends to list[] the slots s >= pos with targets[s] == y, in batch order,
// up to `want` of them; pos moves past the last slot taken (to B when the
// batch is done). Returns the count. Uniform over the block. `pre`: this
// thread's entry of the first window, targets[pos + threadIdx.x] (-1 past
// B), when the caller has loaded it, else kLoad.
__device__ int collect(const int* __restrict__ targets, int B, int y, int& pos, int want,
                       int* list, int (&wcount)[kWarps], int& next, int pre = kLoad) {
  const int lane = threadIdx.x % reid::kWarp, warp = threadIdx.x / reid::kWarp;
  int count = 0;
  while (count < want && pos < B) {
    const int s = pos + threadIdx.x;
    const bool hit = (pre != kLoad ? pre : (s < B ? targets[s] : -1)) == y;
    pre = kLoad;
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) wcount[warp] = __popc(m);
    __syncthreads();
    int before = count, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? wcount[w] : 0;
      total += wcount[w];
    }
    const int rank = before + __popc(m & ((1u << lane) - 1u));
    if (hit && rank < want) list[rank] = s;
    if (hit && rank == want - 1) next = s + 1;
    __syncthreads();
    if (count + total >= want) {
      pos = next;
      count = want;
    } else {
      pos += kThreads;
      count += total;
    }
    __syncthreads();   // wcount and next are written again by the next window
  }
  return count;
}

// Thread 0: copies the n rows of x listed in slots[] into stage (D floats a
// row), each a bulk copy that completes on its own barrier in bars[].
__device__ __forceinline__ void stage_rows(float* stage, const float* __restrict__ x,
                                           const int* slots, int n, int D, uint64_t* bars) {
  if (threadIdx.x != 0) return;
  reid::fence_proxy_async();   // the block's reads of a refilled buffer come first
  const uint32_t bytes = static_cast<uint32_t>(D) * 4u;
  for (int k = 0; k < n; ++k) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bars + k)), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];\n"
                 :: "r"(smem_u32(stage + static_cast<size_t>(k) * D)),
                    "l"(x + static_cast<size_t>(slots[k]) * D), "r"(bytes),
                    "r"(smem_u32(bars + k)) : "memory");
  }
}

// kPer: elements of a row a thread, D <= kThreads * kPer.
template <int kPer>
__global__ void __launch_bounds__(kThreads, 1)
bank_fold_kernel(Bank feat, Bank gan, const int* __restrict__ targets, int B, int banks,
                 float a, float b, int use_hard) {
  extern __shared__ float4 smem4[];
  __shared__ float2 scratch[2][kWarps];
  __shared__ uint64_t bars[kMaxStage];   // a staged row's copy completes on its barrier
  __shared__ int slots[kMaxStage], wcount[kWarps];
  __shared__ float rnorm[kMaxStage], dots[kMaxStage];
  __shared__ int next, best_slot;
  __shared__ float best_r;
  const bool second = banks == 2 && blockIdx.x % 2 == 1;
  const int i = blockIdx.x / banks;
  float* const rows = second ? gan.rows : feat.rows;
  const float* const x = second ? gan.x : feat.x;
  const int K = second ? gan.K : feat.K, D = second ? gan.D : feat.D;
  const bool normalize = second ? gan.normalize : feat.normalize;
  const int y = targets[i];
  if (y < 0 || y >= K) return;  // the whole block leaves together
  // the label's first window, loaded beside the earlier slots
  const int s0 = i + static_cast<int>(threadIdx.x);
  const int pre = s0 < B ? targets[s0] : -1;
  bool earlier = false;
  for (int j = threadIdx.x; j < i; j += kThreads) earlier |= targets[j] == y;
  if (__syncthreads_or(earlier)) return;

  const int lane = threadIdx.x % reid::kWarp, warp = threadIdx.x / reid::kWarp;
  float* const old_row = reinterpret_cast<float*>(smem4);   // D floats (hard variant)
  float* const stage = old_row + D;
  int cap = (kSmemBytes / 4 - D) / D;
  cap = (cap < kMaxStage ? cap : kMaxStage) & ~1;
  const int half = cap / 2;

  if (threadIdx.x == 0) {   // published by collect()'s barriers
    for (int k = 0; k < cap; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(bars + k))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float* my = rows + static_cast<size_t>(y) * D;
  float row[kPer];
  load_row(row, my, D);

  // The first window: every slot of the label when they fit (one buffer),
  // else two halves, each streamed into its own buffer.
  int pos = i;
  const int n = collect(targets, B, y, pos, cap, slots, wcount, next, pre);
  const bool ring = n == cap && pos < B;
  int size[2] = {n, 0}, phase[2] = {0, 0};
  if (ring) {
    size[0] = half;
    size[1] = half;
    stage_rows(stage, x, slots, half, D, bars);
    stage_rows(stage + static_cast<size_t>(half) * D, x, slots + half, half, D, bars + half);
  } else {
    stage_rows(stage, x, slots, n, D, bars);
  }
  if (use_hard) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int d = threadIdx.x + j * kThreads;
      if (d < D) old_row[d] = row[j];
    }
  }
  int parity = 0;
  float best = INFINITY;
  for (int t = 0;; ++t) {
    const int buf = ring ? t % 2 : 0;
    const int m = size[buf];
    if (m == 0) break;
    float* const rows_s = stage + static_cast<size_t>(buf) * half * D;
    int* const list = slots + buf * half;
    uint64_t* const bars_s = bars + buf * half;
    if (!use_hard) {
      chain(row, rows_s, bars_s, phase[buf], m, D, normalize, a, b, scratch, parity);
    } else {
      __syncthreads();   // old_row is written
      // a warp a row: its norm and its dot with the pre-update row
      for (int k = warp; k < m; k += kWarps) {
        wait_row(bars_s + k, phase[buf]);
        const float4* xr = reinterpret_cast<const float4*>(rows_s + static_cast<size_t>(k) * D);
        const float4* o = reinterpret_cast<const float4*>(old_row);
        float ss = 0.0f;
        for (int j = lane; j < D / 4; j += reid::kWarp) {
          const float4 v = xr[j];
          ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
        }
        const float r = 1.0f / sqrtf(reid::warp_sum(ss) + 1e-12f);
        float dot = 0.0f;
        for (int j = lane; j < D / 4; j += reid::kWarp) {
          const float4 v = xr[j], w = o[j];
          dot += v.x * r * w.x + v.y * r * w.y + v.z * r * w.z + v.w * r * w.w;
        }
        dot = reid::warp_sum(dot);
        if (lane == 0) {
          dots[k] = dot;
          rnorm[k] = r;
        }
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        for (int k = 0; k < m; ++k) {   // strict: the first slot keeps an exact tie
          if ((t == 0 && k == 0) || dots[k] < best) {
            best = dots[k];
            best_slot = list[k];
            best_r = rnorm[k];
          }
        }
      }
    }
    // this buffer is read: refill it with the label's next slots
    size[buf] = 0;
    if (ring && pos < B) {
      __syncthreads();   // every thread is past its reads of the buffer and list
      size[buf] = collect(targets, B, y, pos, half, list, wcount, next);
      phase[buf] ^= 1;
      stage_rows(rows_s, x, list, size[buf], D, bars_s);
    }
    if (!ring) break;
  }
  if (use_hard) {   // one fold, by the least similar slot (L2-resident x)
    __syncthreads();
    float xv[kPer];
    load_row(xv, x + static_cast<size_t>(best_slot) * D, D);
    fold(row, xv, best_r, a, b, 0.0f, scratch, parity);
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int d = threadIdx.x + j * kThreads;
    if (d < D) my[d] = row[j];
  }
}

template <int kPer>
int launch(const Bank& feat, const Bank& gan, const int* targets, int B, int banks, float a,
           float b, int use_hard, cudaStream_t stream) {
  const int rc = static_cast<int>(cudaFuncSetAttribute(
      bank_fold_kernel<kPer>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes));
  if (rc != 0) return rc;
  bank_fold_kernel<kPer><<<B * banks, kThreads, kSmemBytes, stream>>>(feat, gan, targets, B,
                                                                      banks, a, b, use_hard);
  return reid::launch_status();
}

}  // namespace

// bank: (K, D) fp32, updated in place; x: (B, D) fp32, its rows L2-normalised
// before the fold. gan_bank: (K_gan, D_gan) fp32 or null; gan_x: (B, D_gan)
// fp32, folded as it is, in the same launch (not with use_hard, whose fold
// takes the feature bank only). targets: (B,) int32; slots with a label
// outside a bank's rows are skipped. Rows 16-byte aligned, D % 4 == 0,
// D <= 4096.
extern "C" int reid_bank_fold(void* bank, const void* x, void* gan_bank, const void* gan_x,
                              const void* targets, int B, int K, int D, int K_gan,
                              int D_gan, float a, float b, int use_hard, void* stream) {
  const int banks = gan_bank != nullptr && K_gan > 0 && !use_hard ? 2 : 1;
  const int dg = banks == 2 ? D_gan : D;
  if (D <= 0 || D % 4 || D > kMaxD || dg <= 0 || dg % 4 || dg > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const Bank feat{static_cast<float*>(bank), static_cast<const float*>(x), K, D, true};
  const Bank gan{static_cast<float*>(gan_bank), static_cast<const float*>(gan_x), K_gan, dg,
                 false};
  const int* t = static_cast<const int*>(targets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dmax = D > dg ? D : dg;
  if (dmax <= 4 * kThreads) return launch<4>(feat, gan, t, B, banks, a, b, use_hard, st);
  if (dmax <= 8 * kThreads) return launch<8>(feat, gan, t, B, banks, a, b, use_hard, st);
  if (dmax <= 16 * kThreads) return launch<16>(feat, gan, t, B, banks, a, b, use_hard, st);
  return launch<kMaxD / kThreads>(feat, gan, t, B, banks, a, b, use_hard, st);
}
