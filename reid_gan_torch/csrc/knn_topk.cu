// K8: the k nearest neighbours of every row of a feature set, searched
// against the set itself, by squared L2 distance or by inner product.
//
// Replaces: reid_gan_tpu/ops/distance.py::knn_block (:118-129, L2) and
// ::knn_ip_block (:132-140, inner product), the jitted blocks of knn_search
// (:160-190): an fp32 Precision.HIGHEST product of a row block against the
// whole set, then lax.top_k. The Jaccard step of every USL epoch takes its
// k-reciprocal ranks from the L2 search (k = min(k1, N), self first); the
// Infomap backend takes its graph from the inner-product search.
//
// For x (N, D) fp32 rows:
//   L2: key[q, g] = max(|x_q|^2 + |x_g|^2 - 2 x_q . x_g, 0), ascending
//   IP: key[q, g] = -(x_q . x_g), ascending (so the largest product first)
// The output is each row's k smallest keys in (key, index) order: the lower
// index wins an exact tie, as lax.top_k orders ties. vals are the distances
// (L2) or products (IP), idx the gallery rows as int32.
//
// Bound: operations. The keys are symmetric, so all N lists need only the
// N (N + 1) / 2 products of the upper triangle: N (N + 1) D flops, against
// N D + 2 N k words of traffic. At fp32 accuracy on the tensor cores
// (3xTF32, below) that is 3 N (N + 1) D flops at 495 TFLOP/s: 2.08 ms at N
// 12,936, D 2048 (5.12 ms as fp32 FMA at 67 TFLOP/s).
//
// Products. The rows are cut into tiles of 128. A block computes the keys of
// one tile pair (I, J), 128 x 128, on wgmma (m64n128k8, two warpgroups of 64
// rows) at fp32 accuracy by the 3xTF32 split (wgmma_tf32.cuh; plain TF32
// keeps ~3 digits and would reorder neighbours). It walks D in stages of 32
// through a 3-slot cp.async ring (two stages in flight); per stage the
// block splits B's hi and lo parts into shared memory and each warp splits
// its rows of A in registers, then the tensor cores run the stage. The
// error of the tensor cores' fp32 sums grows with the depth of one
// accumulator (K6 keeps its D slices within 512): a product is summed in
// chunks of 128 of D, each chunk added to a running total in ordinary fp32
// (the largest key error against the plain fp32 version at N 12,936, D 2048:
// 2.9e-06 in chunks of 128, 5.4e-06 of 256, 4.3e-05 with no chunks). Designs that keep a stage's products
// running while the threads split the next (double-buffered parts, A in
// registers or in shared memory, rings of 3 to 5 stages) all measured
// slower on the H100 than this serial one (PERF.md, PR 9).
//
// Upper triangle, both sides. Each tile pair is computed once: its keys
// serve row q of I (candidate g of J) and row g of J (candidate q of I).
// The pairs are walked as a circulant schedule in steps d = 0 .. T / 2 (T
// tiles): at step d, block I computes the pair (I, (I + d) mod T). Every
// pair {I, J} comes up exactly once (at T even, the pairs T / 2 apart come up
// at the last step from both ends; both blocks take the direct side and
// nothing is emitted). Within a step, each tile's rows belong to exactly one
// block, which owns their lists for the step, so no list is ever shared.
// The transposed side of step d's pair goes to the tile that receives it as
// a 128 x 128 key tile in a mailbox in scratch (64 KB, L2 resident); the
// owner of that tile takes it at the start of step d + 1, as candidates from
// the sender's tile. The steps are launches of the same kernel (about T / 2
// of them), so the stream orders each mailbox write before its read: no
// flags, no atomics, and any N works, whatever fits on the card at once.
// The other choices and why not: per-(row, split) partial lists make the
// transposed side's lists shared between blocks or multiply the scratch by
// the number of splits; filtered emissions into per-row buffers need a
// threshold that is only known at the end, and their size is data-bound.
//
// Lists. Each row's list is its k smallest (key, index) pairs so far, kept
// in scratch between steps (N x k of each). A warp takes a row's list into
// registers (slot lane + 32 j) while it filters the tile's 128 candidates
// against the row's k-th pair (a ballot; after the first steps almost every
// candidate fails) and inserts the few survivors. With k <= 64 a block
// copies its 128 rows' lists to shared memory for the step. With k <= 128
// they stay in scratch, the rows' k-th pairs are cached in shared memory,
// and a warp loads a row's list only when a candidate passes. Above 128 the
// warp inserts in scratch (L2 resident): the position is a ballot count over
// the list's 32-entry chunks, and the entries behind it shift one place up,
// chunk by chunk from the end. Candidates no longer arrive in ascending
// index order (the mailbox brings lower tiles late), so the filter and the
// insert position compare (key, index) pairs: the list is the exact top k of
// the candidates seen, in any order, and the result the same bits on every
// run. A last pass writes vals and idx.
//
// Scratch (reid_knn_topk_scratch elements of each of the two buffers): the
// lists, N k, then one of the two mailbox buffers, T x 128 x 128; at N
// 32,621, k 300: 9.79 M + 4.18 M elements, 56 MB a buffer, 112 MB in all.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma_tf32.cuh"

namespace {

using reid::kCoreBytes;

constexpr int kTile = 128;                    // rows of a tile, both sides
constexpr int kBK = 32;                       // D per stage
constexpr int kStages = 3;                    // cp.async ring: two stages in flight
constexpr int kThreads = 256;                 // two warpgroups of 64 rows
constexpr int kWarps = kThreads / reid::kWarp;
constexpr int kRowsPerWarp = kTile / kWarps;  // 16
constexpr int kPadK = kBK + 4;                // a raw tile row: 36 floats
constexpr int kSteps = kBK / 8;               // wgmma k = 8 steps a stage
constexpr int kCoresK = kBK / 4;              // core matrices along k a row group
constexpr int kChunkStages = 4;               // 128 of D a tensor-core accumulator
constexpr int kKeyStride = kTile + 1;         // a key tile row: 129 floats
constexpr int kMailFloats = kTile * kTile;    // one mailbox tile
constexpr int kNormThreads = 256;
constexpr int kOutThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Where the rows' lists live during a step (see the header): in shared
// memory (k <= 64), in scratch and a warp's registers while it takes a row
// (k <= 128), or in scratch alone (above).
constexpr int kShared = 0, kRows = 1, kScratch = 2;
constexpr int kSharedK = 2 * reid::kWarp, kRowsK = 4 * reid::kWarp;

// shared memory: the ring of raw A and B tiles (the key tile reuses it), B's
// hi and lo parts, the lists (kShared), the rows' k-th pairs, the norms
constexpr int kSlotFloats = kTile * kPadK;
constexpr int kRingFloats = kStages * 2 * kSlotFloats;
constexpr int kPartFloats = kTile * kBK;
constexpr int kListFloats = kTile * kSharedK;
static_assert(kTile * kKeyStride <= kRingFloats, "the key tile fits the ring");
constexpr int kSmemBytes =
    (kRingFloats + 2 * kPartFloats + 2 * kListFloats + 2 * kTile + 2 * kTile) * 4;

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// (a, ai) before (b, bi) in (key, index) order.
__device__ __forceinline__ bool before(float a, int ai, float b, int bi) {
  return a < b || (a == b && ai < bi);
}

// |x_q|^2, one warp a row, summed as x*x in FMA.
__global__ void __launch_bounds__(kNormThreads)
row_norms_kernel(const float* __restrict__ x, int n, int d, float* __restrict__ norms) {
  const int row = blockIdx.x * (kNormThreads / reid::kWarp) + threadIdx.x / reid::kWarp;
  const int lane = threadIdx.x % reid::kWarp;
  if (row >= n) return;  // the whole warp leaves together
  const float* xr = x + static_cast<size_t>(row) * d;
  float s = 0.0f;
  for (int j = lane; j < d; j += reid::kWarp) s = fmaf(xr[j], xr[j], s);
  s = reid::warp_sum(s);
  if (lane == 0) norms[row] = s;
}

// One row's sorted list in a warp's registers: slot lane + 32 j in (key[j],
// idx[j]); slots at or past k hold (+inf, INT32_MAX).
template <int kSlots>
struct RowList {
  float key[kSlots];
  int idx[kSlots];
};

// The list's k-th pair, in every lane.
template <int kSlots>
__device__ __forceinline__ void kth(const RowList<kSlots>& l, int k, float& tk, int& ti) {
  float v = l.key[0];
  int iv = l.idx[0];
#pragma unroll
  for (int j = 1; j < kSlots; ++j)
    if ((k - 1) / reid::kWarp == j) {
      v = l.key[j];
      iv = l.idx[j];
    }
  tk = __shfl_sync(kFull, v, (k - 1) % reid::kWarp);
  ti = __shfl_sync(kFull, iv, (k - 1) % reid::kWarp);
}

// Insert (v, gi), known to come before the k-th pair, after every pair
// before it in (key, index) order: the slots behind it move up one place.
template <int kSlots>
__device__ __forceinline__ void insert(RowList<kSlots>& l, float v, int gi, int k, int lane) {
  int pos = 0;
  float up[kSlots], last[kSlots];
  int iup[kSlots], ilast[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    pos += __popc(__ballot_sync(kFull, before(l.key[j], l.idx[j], v, gi)));
    up[j] = __shfl_up_sync(kFull, l.key[j], 1);
    iup[j] = __shfl_up_sync(kFull, l.idx[j], 1);
    last[j] = __shfl_sync(kFull, l.key[j], reid::kWarp - 1);
    ilast[j] = __shfl_sync(kFull, l.idx[j], reid::kWarp - 1);
  }
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    if (lane == 0 && j > 0) {
      up[j] = last[j - 1];
      iup[j] = ilast[j - 1];
    }
    const int s = lane + j * reid::kWarp;
    if (s > pos) {
      l.key[j] = up[j];
      l.idx[j] = iup[j];
    } else if (s == pos) {
      l.key[j] = v;
      l.idx[j] = gi;
    }
    if (s >= k) {
      l.key[j] = INFINITY;
      l.idx[j] = INT32_MAX;
    }
  }
}

// The list of k entries in scratch (lk, li), sorted in (key, index) order:
// insert (v, gi), known to come before lk[k - 1], after every pair before
// it. Every lane of the warp calls it with the same arguments.
__device__ __forceinline__ void insert_global(float* lk, int* li, float v, int gi, int k,
                                              int lane) {
  int pos = 0;
  for (int c = 0; c < k; c += reid::kWarp) {
    const int i = c + lane;
    pos += __popc(__ballot_sync(kFull, i < k && before(lk[i], li[i], v, gi)));
  }
  // entries pos .. k - 2 move one place up, the highest chunk first, so a
  // chunk's writes land on entries that were already read
  for (int c = ((k - 2) / reid::kWarp) * reid::kWarp; c >= 0 && c + reid::kWarp > pos;
       c -= reid::kWarp) {
    const int i = c + lane;
    const bool mv = i >= pos && i < k - 1;
    float kv = 0.0f;
    int iv = 0;
    if (mv) {
      kv = lk[i];
      iv = li[i];
    }
    __syncwarp();
    if (mv) {
      lk[i + 1] = kv;
      li[i + 1] = iv;
    }
    __syncwarp();
  }
  if (lane == 0) {
    lk[pos] = v;
    li[pos] = gi;
  }
  __syncwarp();
}

// Splits one stage's raw B tile (row n at Bs + n * kPadK) into its hi and lo
// parts in wgmma's no-swizzle K-major layout: core (n / 8, k / 4) at ((n /
// 8) * 8 + k / 4) * 128 bytes; eight neighbouring threads fill one core
// matrix (128 contiguous bytes).
__device__ __forceinline__ void split_b(const float* Bs, float* hi, float* lo) {
#pragma unroll
  for (int i = 0; i < (kTile * kBK / 4) / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads, n = e % kTile, kq = e / kTile;
    const float4 v = *reinterpret_cast<const float4*>(Bs + n * kPadK + kq * 4);
    uint4 h, l;
    reid::split_tf32(v.x, h.x, l.x);
    reid::split_tf32(v.y, h.y, l.y);
    reid::split_tf32(v.z, h.z, l.z);
    reid::split_tf32(v.w, h.w, l.w);
    const int at = ((n / 8) * kCoresK + kq) * (kCoreBytes / 4) + (n % 8) * 4;
    *reinterpret_cast<uint4*>(hi + at) = h;
    *reinterpret_cast<uint4*>(lo + at) = l;
  }
}

// Stage j of the product into a ring slot: rows a0.. of A and b0.. of B, D
// columns j * kBK onwards, zeros past n rows and past dim.
__device__ __forceinline__ void load_stage(float* As, float* Bs, const float* __restrict__ x,
                                           int n, int dim, int a0, int b0, int j) {
  const int d0 = j * kBK;
#pragma unroll
  for (int i = 0; i < (kTile * kBK / 4) / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads, row = e / (kBK / 4), cq = (e % (kBK / 4)) * 4;
    const bool dv = d0 + cq < dim;
    const bool va = dv && a0 + row < n, vb = dv && b0 + row < n;
    reid::cp_async16(As + row * kPadK + cq,
                     va ? x + static_cast<size_t>(a0 + row) * dim + d0 + cq : x, va);
    reid::cp_async16(Bs + row * kPadK + cq,
                     vb ? x + static_cast<size_t>(b0 + row) * dim + d0 + cq : x, vb);
  }
}

// tot (this warpgroup's 64 x 128 share of the tile) = A . B^T over all of
// dim, A the 128 rows from a0, B those from b0, in fp32 at 3xTF32 accuracy.
// The raw tiles arrive through a ring of kStages slots, so two stages' copies
// are in flight while the tensor cores work on this one. Per stage the block
// splits B into hi and lo parts in shared memory, each warp splits its 16
// rows of A in registers, and per k = 8 step three wgmma add lo.hi, hi.lo,
// hi.hi (the small terms first). Each chunk of kChunkStages stages starts
// its accumulator afresh and ends by adding it to tot.
__device__ __forceinline__ void tile_product(float (&tot)[64], float* smem,
                                             const float* __restrict__ x, int n, int dim,
                                             int a0, int b0) {
  float* ring = smem;
  float* hi = ring + kRingFloats;
  float* lo = hi + kPartFloats;
  const int warp = threadIdx.x / reid::kWarp, lane = threadIdx.x % reid::kWarp;
  const int g = lane / 4, t = lane % 4;
  const int m = warp * 16 + g;   // this thread's first A row (warp w: rows 16w..)
  const int stages = ceil_div(dim, kBK);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0.0f;
    tot[i] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < stages) {
      float* slot = ring + j * 2 * kSlotFloats;
      load_stage(slot, slot + kSlotFloats, x, n, dim, a0, b0, j);
    }
    reid::cp_async_commit();
  }
  for (int j = 0; j < stages; ++j) {
    reid::cp_async_wait<kStages - 2>();
    __syncthreads();   // stage j has landed for all; slot (j - 1) % kStages is free
    const int next = j + kStages - 1;
    if (next < stages) {
      float* slot = ring + (next % kStages) * 2 * kSlotFloats;
      load_stage(slot, slot + kSlotFloats, x, n, dim, a0, b0, next);
    }
    reid::cp_async_commit();
    const float* As = ring + (j % kStages) * 2 * kSlotFloats;
    split_b(As + kSlotFloats, hi, lo);
    reid::fence_proxy_async();
    __syncthreads();   // B's parts written and visible to the tensor cores
    uint32_t ah[kSteps][4], al[kSteps][4];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const float* a = As + m * kPadK + 8 * s + t;
      const float v[4] = {a[0], a[8 * kPadK], a[4], a[8 * kPadK + 4]};
#pragma unroll
      for (int i = 0; i < 4; ++i) reid::split_tf32(v[i], ah[s][i], al[s][i]);
    }
    reid::pin(acc);
    reid::wgmma_fence();
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      // k = 8s .. 8s + 7 are the core matrices 2s and 2s + 1 of each n group
      const uint64_t bh = reid::smem_desc(hi + s * 2 * (kCoreBytes / 4), kCoreBytes,
                                          kCoresK * kCoreBytes);
      const uint64_t bl = reid::smem_desc(lo + s * 2 * (kCoreBytes / 4), kCoreBytes,
                                          kCoresK * kCoreBytes);
      reid::wgmma_tf32(acc, al[s], bh);
      reid::wgmma_tf32(acc, ah[s], bl);
      reid::wgmma_tf32(acc, ah[s], bh);
    }
    reid::wgmma_commit();
    reid::wgmma_wait<0>();
    reid::pin(acc);
    reid::pin(ah);
    reid::pin(al);
    if ((j + 1) % kChunkStages == 0 || j + 1 == stages) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        tot[i] += acc[i];
        acc[i] = 0.0f;
      }
    }
  }
  __syncthreads();   // every warp is done with the ring: the key tile may reuse it
}

// Filters the key tile's 128 candidates of each of the block's rows (keys
// row r, candidate c: keys[r * kKeyStride + c], global index c0 + c, valid
// below n) against the row's k-th pair and inserts the survivors. The
// block's rows start at q0; warp w takes rows 16w .. 16w + 15. kShared: the
// lists in lkey / lidx (kSharedK slots a row); else in part_key / part_idx
// (k a row) with the rows' k-th pairs in thr_key / thr_idx.
template <int kMode>
__device__ __forceinline__ void select_tile(const float* keys, int c0, int q0, int n, int k,
                                            float* lkey, int* lidx, float* thr_key,
                                            int* thr_idx, float* part_key, int* part_idx) {
  constexpr int kSlots = kMode == kShared ? 2 : 4;
  const int lane = threadIdx.x % reid::kWarp, warp = threadIdx.x / reid::kWarp;
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    if (q0 + r >= n) break;   // the whole warp: rows past n
    const float* kr = keys + r * kKeyStride;
    float* gk = part_key + static_cast<size_t>(q0 + r) * k;
    int* gi = part_idx + static_cast<size_t>(q0 + r) * k;
    RowList<kSlots> l;
    float tk;
    int ti;
    if constexpr (kMode == kShared) {
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        l.key[j] = lkey[r * kSharedK + lane + j * reid::kWarp];
        l.idx[j] = lidx[r * kSharedK + lane + j * reid::kWarp];
      }
      kth(l, k, tk, ti);
    } else {
      tk = thr_key[r];
      ti = thr_idx[r];
    }
    unsigned mask[kTile / reid::kWarp];
    unsigned any = 0;
#pragma unroll
    for (int h = 0; h < kTile / reid::kWarp; ++h) {
      const int c = lane + h * reid::kWarp;
      mask[h] = __ballot_sync(kFull, c0 + c < n && before(kr[c], c0 + c, tk, ti));
      any |= mask[h];
    }
    if (!any) continue;   // the row's list stays as it is
    if constexpr (kMode == kRows) {
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int s = lane + j * reid::kWarp;
        l.key[j] = s < k ? gk[s] : INFINITY;
        l.idx[j] = s < k ? gi[s] : INT32_MAX;
      }
    }
#pragma unroll
    for (int h = 0; h < kTile / reid::kWarp; ++h) {
      while (mask[h]) {   // the same mask in every lane: the loop is uniform
        const int c = h * reid::kWarp + __ffs(mask[h]) - 1;
        mask[h] &= mask[h] - 1;
        const float v = kr[c];
        if (!before(v, c0 + c, tk, ti)) continue;
        if constexpr (kMode == kScratch) {
          insert_global(gk, gi, v, c0 + c, k, lane);
          tk = gk[k - 1];
          ti = gi[k - 1];
        } else {
          insert(l, v, c0 + c, k, lane);
          kth(l, k, tk, ti);
        }
      }
    }
    if constexpr (kMode == kShared) {
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        lkey[r * kSharedK + lane + j * reid::kWarp] = l.key[j];
        lidx[r * kSharedK + lane + j * reid::kWarp] = l.idx[j];
      }
    } else {
      if constexpr (kMode == kRows) {
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          const int s = lane + j * reid::kWarp;
          if (s < k) {
            gk[s] = l.key[j];
            gi[s] = l.idx[j];
          }
        }
      }
      if (lane == 0) {
        thr_key[r] = tk;
        thr_idx[r] = ti;
      }
    }
  }
}

// One step of the circulant schedule for row tile I = blockIdx.x of T:
//   src_dist >= 0: first take the mailbox tile that the previous step sent
//         to I (mail_in + I * kMailFloats: rows of I x candidates of tile
//         (I - src_dist) mod T);
//   dist >= 0: then compute the pair (I, J = (I + dist) mod T), take its
//         direct side (rows of I) and, with emit, send its transposed side
//         to tile J's mailbox (mail_out + J * kMailFloats).
// first: the step that starts the lists. Between steps the lists live in
// part_key / part_idx (n x k, row-major).
template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
knn_step_kernel(const float* __restrict__ x, const float* __restrict__ norms, int n,
                int dim, int k, int l2, int T, int first, int dist, int src_dist, int emit,
                const float* __restrict__ mail_in, float* __restrict__ mail_out,
                float* part_key, int* part_idx) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* keys = smem;   // the key tile reuses the ring
  float* lkey = smem + kRingFloats + 2 * kPartFloats;
  int* lidx = reinterpret_cast<int*>(lkey + kListFloats);
  float* thr_key = reinterpret_cast<float*>(lidx + kListFloats);
  int* thr_idx = reinterpret_cast<int*>(thr_key + kTile);
  float* qn = reinterpret_cast<float*>(thr_idx + kTile);
  float* gn = qn + kTile;
  const int tid = threadIdx.x;
  const int I = blockIdx.x, q0 = I * kTile;
  const int rows = min(kTile, n - q0);

  // the block's lists: started at step 0, else read back from scratch
  if constexpr (kMode == kShared) {
    for (int e = tid; e < kTile * kSharedK; e += kThreads) {
      const int r = e / kSharedK, s = e % kSharedK;
      float kv = INFINITY;
      int iv = INT32_MAX;
      if (!first && r < rows && s < k) {
        kv = part_key[static_cast<size_t>(q0 + r) * k + s];
        iv = part_idx[static_cast<size_t>(q0 + r) * k + s];
      }
      lkey[e] = kv;
      lidx[e] = iv;
    }
  } else if (first) {
    for (int e = tid; e < rows * k; e += kThreads) {
      part_key[static_cast<size_t>(q0) * k + e] = INFINITY;
      part_idx[static_cast<size_t>(q0) * k + e] = INT32_MAX;
    }
    for (int r = tid; r < kTile; r += kThreads) {
      thr_key[r] = INFINITY;
      thr_idx[r] = INT32_MAX;
    }
  } else {
    for (int r = tid; r < rows; r += kThreads) {
      thr_key[r] = part_key[static_cast<size_t>(q0 + r) * k + k - 1];
      thr_idx[r] = part_idx[static_cast<size_t>(q0 + r) * k + k - 1];
    }
  }
  __syncthreads();   // lists (and the scratch rows) in place

  if (src_dist >= 0) {   // keys[r][c] = mail_in[I][r * 128 + c], candidate c of tile src
    const float4* mb = reinterpret_cast<const float4*>(mail_in + static_cast<size_t>(I) *
                                                                     kMailFloats);
#pragma unroll 4
    for (int e = tid; e < kMailFloats / 4; e += kThreads) {
      const float4 v = mb[e];
      const int r = (e * 4) / kTile, c = (e * 4) % kTile;
      float* kr = keys + r * kKeyStride + c;
      kr[0] = v.x;
      kr[1] = v.y;
      kr[2] = v.z;
      kr[3] = v.w;
    }
    __syncthreads();
    const int src = (I - src_dist + T) % T;
    select_tile<kMode>(keys, src * kTile, q0, n, k, lkey, lidx, thr_key, thr_idx, part_key,
                       part_idx);
    __syncthreads();   // the key tile is free for the ring
  }

  if (dist >= 0) {
    const int J = (I + dist) % T, g0 = J * kTile;
    if (tid < kTile) {
      qn[tid] = (l2 && q0 + tid < n) ? norms[q0 + tid] : 0.0f;
      gn[tid] = (l2 && g0 + tid < n) ? norms[g0 + tid] : 0.0f;
    }
    float tot[64];
    tile_product(tot, smem, x, n, dim, q0, g0);   // its barriers publish qn, gn
    // the keys: accumulator element i of this thread is row 16 * warp + lane
    // / 4 (+ 8 for i % 4 >= 2) of the tile (warpgroup wg holds rows 64 wg ..),
    // column 8 * (i / 4) + 2 * (lane % 4) + i % 2
    const int warp = tid / reid::kWarp, lane = tid % reid::kWarp;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = warp * 16 + lane / 4 + ((i % 4) >= 2 ? 8 : 0);
      const int c = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
      float v;
      if (q0 + r >= n || g0 + c >= n)
        v = INFINITY;
      else if (l2)
        v = fmaxf((qn[r] + gn[c]) - 2.0f * tot[i], 0.0f);
      else
        v = -tot[i];
      keys[r * kKeyStride + c] = v;
    }
    __syncthreads();
    select_tile<kMode>(keys, g0, q0, n, k, lkey, lidx, thr_key, thr_idx, part_key, part_idx);
    if (emit) {   // rows of J x candidates of I: mail_out[J][c * 128 + r] = keys[r][c]
      float4* mb = reinterpret_cast<float4*>(mail_out + static_cast<size_t>(J) * kMailFloats);
#pragma unroll 4
      for (int e = tid; e < kMailFloats / 4; e += kThreads) {
        const int c = (e * 4) / kTile, r = (e * 4) % kTile;
        const float* kc = keys + r * kKeyStride + c;
        mb[e] = make_float4(kc[0], kc[kKeyStride], kc[2 * kKeyStride], kc[3 * kKeyStride]);
      }
    }
  }

  if constexpr (kMode == kShared) {   // the lists back to scratch
    __syncthreads();
    for (int e = tid; e < rows * k; e += kThreads) {
      const int r = e / k, s = e % k;
      part_key[static_cast<size_t>(q0) * k + e] = lkey[r * kSharedK + s];
      part_idx[static_cast<size_t>(q0) * k + e] = lidx[r * kSharedK + s];
    }
  }
}

// vals and idx from the finished lists (IP: the products, the keys negated).
__global__ void __launch_bounds__(kOutThreads)
knn_out_kernel(const float* __restrict__ part_key, const int* __restrict__ part_idx,
               long long total, int l2, float* __restrict__ vals, int* __restrict__ idx) {
  for (long long e = blockIdx.x * static_cast<long long>(kOutThreads) + threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * kOutThreads) {
    const float v = part_key[e];
    vals[e] = l2 ? v : -v;
    idx[e] = part_idx[e];
  }
}

int tiles_of(int n) { return ceil_div(n, kTile); }

// The lists' elements in a scratch buffer, rounded up so that the mailbox
// behind them is 16-byte aligned.
long long list_elems(int n, int k) { return (static_cast<long long>(n) * k + 3) / 4 * 4; }

// Whether step d of the schedule sends its transposed side: not the
// diagonal (d = 0), and at T even not the last step, whose pairs both ends
// compute.
bool emits(int d, int T) { return d >= 1 && !(T % 2 == 0 && d == T / 2); }

}  // namespace

// Elements of each of the two scratch buffers (keys fp32, indices int32):
// the lists, n x k (rounded up to 4), then one mailbox buffer, T x 128 x 128.
extern "C" long long reid_knn_topk_scratch(int n, int k) {
  return list_elems(n, k) + static_cast<long long>(tiles_of(n)) * kMailFloats;
}

// x: (n, d) fp32 row-major, d % 4 == 0, 16-byte aligned. norms: (n,) fp32
// scratch (written when l2). part_key / part_idx: reid_knn_topk_scratch(n,
// k) elements each, 16-byte aligned. vals (n, k) fp32 and idx (n, k) int32
// out. 1 <= k <= n. l2: 1 for squared L2 distance, 0 for inner product.
extern "C" int reid_knn_topk(const void* x, int n, int d, int k, int l2, void* norms,
                             void* part_key, void* part_idx, void* vals, void* idx,
                             void* stream) {
  if (n < 1 || k < 1 || k > n || d < 1 || d % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* nf = static_cast<float*>(norms);
  float* pk = static_cast<float*>(part_key);
  int* pi = static_cast<int*>(part_idx);
  constexpr int rows_per_block = kNormThreads / reid::kWarp;
  if (l2) row_norms_kernel<<<ceil_div(n, rows_per_block), kNormThreads, 0, st>>>(xf, n, d, nf);
  auto kernel = k <= kSharedK ? knn_step_kernel<kShared>
                : k <= kRowsK  ? knn_step_kernel<kRows>
                               : knn_step_kernel<kScratch>;
  int rc = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes));
  if (rc != 0) return rc;
  const int T = tiles_of(n), last = T / 2;
  // the mailbox's two buffers, behind the lists in the two scratch buffers:
  // step s writes buffer s % 2, step s + 1 reads it
  const long long lists = list_elems(n, k);
  float* mail[2] = {pk + lists, reinterpret_cast<float*>(pi + lists)};
  for (int step = 0; step <= last + 1; ++step) {
    const int dist = step <= last ? step : -1;
    const int src_dist = step >= 1 && emits(step - 1, T) ? step - 1 : -1;
    if (dist < 0 && src_dist < 0) break;
    kernel<<<T, kThreads, kSmemBytes, st>>>(xf, nf, n, d, k, l2, T, step == 0, dist,
                                            src_dist, dist >= 0 && emits(dist, T),
                                            mail[(step + 1) % 2], mail[step % 2], pk, pi);
    rc = reid::launch_status();
    if (rc != 0) return rc;
  }
  const long long total = static_cast<long long>(n) * k;
  long long blocks = (total + kOutThreads - 1) / kOutThreads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;   // grid-stride beyond this
  knn_out_kernel<<<static_cast<unsigned>(blocks), kOutThreads, 0, st>>>(
      pk, pi, total, l2, static_cast<float*>(vals), static_cast<int*>(idx));
  return reid::launch_status();
}
