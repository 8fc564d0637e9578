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
// The logits are (B, K + T). Backward, for g = dL/dloss (B,), to x only (ex
// is a constant):
//   dl[b,k] = (exp(logits[b,k] - lse[b]) - [k == y_b]) * g[b] / temp
//   dxh     = dl[:, :K] . M + dl[:, K:] . exh            (B, D)
//   dx[b]   = r[b] * (dxh[b] - xh[b] * (xh[b] . dxh[b]))
//
// Bound: operations. Each product is 2*B*nv*D flops (nv = num_valid): at
// B 256, D 2048 and nv 700 that is 734 MFLOP. At fp32 accuracy the fastest
// route of the H100 is three TF32 products on the tensor cores (below):
// ~4.5 us at 495 TFLOP/s, against ~9 MB of traffic (~3 us).
//
// Design. Both products run on the tensor cores with Hopper's wgmma
// (m64n64k8, tf32) at fp32 accuracy by the 3xTF32 split (wgmma_tf32.cuh,
// shared with K8): each operand a = hi + lo with hi rounded to tf32, and
// a.b = lo.hi + hi.lo + hi.hi summed in fp32 (the lo.lo term and lo's
// truncation are ~2^-21 of the product).
// One tf32 pass would keep ~1e-3, which temp = 0.05 turns into logit errors
// far above the 1e-4 that holds the kernel. A block is one warpgroup and
// computes a 64x64 output tile. It walks the reduction in stages of 32
// through a 2-stage cp.async ring of raw tiles, so the next stage's copies
// are in flight while the tensor cores work on this one. Per stage the block
// splits B into hi and lo parts in shared memory, in wgmma's no-swizzle
// K-major core-matrix layout, and each warp splits its 16 rows of A in
// registers (wgmma reads A from registers, B from shared memory). wgmma
// takes a tf32 B K-major only, and the backward's bank, summed over its
// rows, is M-major: the backward computes dxh^T = M^T . dl^T, with dl as
// B (K-major as it lies) and the bank as A, whose fragments are read by
// hand. The same design on mma.sync.m16n8k8.tf32, which reads both
// operands' fragments in any layout and needs neither the core-matrix
// layout nor the transposed backward, ran 19% slower at the main path's
// shape and 29% slower at 30,720 bank rows on the H100.
//
// At B 256 and 768 bank rows the forward has only 48 output tiles for 132
// SMs, so it splits D into slices (8 of 256 at D 2048; the split depends on
// B, K and D, never on T, so the bank's logits are the same bits with and
// without extra columns). The slices of one tile run as one thread block
// cluster: each block leaves its partial tile in its shared memory, and
// after a cluster barrier each block adds its share of the tile's rows
// over the cluster's blocks in rank order, through distributed shared
// memory, so no partial goes to device memory. That block scales, masks
// and writes its rows of the logits and, per row, the max and sum of exp
// over the tile's 64 columns; the LSE pass merges those partials over the
// column tiles in order. The products run on x and ex as they are: the
// blocks sum the squares of the rows they stream, the cluster adds them
// up, and r[b] and rex[t] scale the finished logits, so the normalisation
// is no pass of its own and x-hat is never written (the backward forms it
// from x and r). Column tiles at or past num_valid (read on the device, no
// host sync) skip their product and only write their -inf. The
// backward forms dl once (B x (K + T) floats), then the dxh product splits
// its K + T reduction rows into slices (3 at the main shape), a cluster a
// tile, reduced the same way. Stages that hold only bank rows at or past
// num_valid are skipped. No atomics anywhere: the results are the same
// bits on every run.
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include <cooperative_groups.h>

#include "common.cuh"
#include "wgmma_tf32.cuh"

namespace {

using reid::cp_async16;
using reid::cp_async_commit;
using reid::kCoreBytes;
using reid::pin;
using reid::smem_desc;
using reid::split_tf32;
using reid::wgmma_tf32;

constexpr int kTile = 64;                  // output tile rows and columns
constexpr int kBK = 32;                    // reduction depth of a stage
constexpr int kStages = 2;                 // cp.async ring
constexpr int kThreads = 128;              // one warpgroup: 4 warps of 16 rows
constexpr int kPadK = kBK + 4;             // a K-major tile row: 36 floats
constexpr int kPadN = kTile + 8;           // an M-major tile row: 72 floats
constexpr int kBlocksPerSm = 4;            // resident: 53 KB of shared memory, <= 128 registers
constexpr int kTargetBlocks = 3 * 132;     // the splits aim at 3 blocks an SM of the H100
constexpr int kMaxSplits = 8;              // a portable cluster
// the most of D one forward accumulator takes inside the tensor cores: the
// logits' error grew with that depth (on the H100 at temp 0.05: 1.7e-5 at
// 256, 1.5e-4 at 2048, against the 1e-4 that holds the kernel)
constexpr int kMaxDepth = 512;
constexpr int kRedStride = kTile + 8;      // a partial tile row: 72 floats
constexpr int kRowThreads = 256;
// a raw tile takes the same room K-major (64 x 36) or M-major (32 x 72)
static_assert(kTile * kPadK == kBK * kPadN, "the two tiles take the same room");

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// How the products are cut for these sizes; the scratch query and the
// launches share it. A split is a cluster of blocks, at most kMaxSplits.
struct Plan {
  int fsplits, fslice;   // forward: D slices of fslice (a multiple of kBK)
  int bsplits, bstages;  // backward: K + T rows in slices of bstages stages
  int ldl;               // dl's row stride: K + T rounded up to 4
};

Plan make_plan(int B, int K, int T, int D) {
  Plan pl;
  const int row_tiles = cdiv(B, kTile);
  const int bank_tiles = row_tiles * cdiv(K, kTile);
  // as many slices as keep the bank's tiles within kTargetBlocks, whatever
  // T is (the extra columns' tiles come on top, within kBlocksPerSm), and
  // at least as many as keep a slice within kMaxDepth
  const int fill = std::max(1, std::min(kTargetBlocks / std::max(bank_tiles, 1), D / 256));
  const int fs = std::min(kMaxSplits, std::max(fill, cdiv(D, kMaxDepth)));
  pl.fslice = cdiv(cdiv(D, fs), kBK) * kBK;
  pl.fsplits = cdiv(D, pl.fslice);
  const int stages = cdiv(K + T, kBK);
  const int out_tiles = std::max(1, row_tiles * cdiv(D, kTile));
  const int bs = std::max(1, std::min(kTargetBlocks / out_tiles,
                                      std::min(stages / 2, kMaxSplits)));
  pl.bstages = std::max(1, cdiv(stages, bs));   // B, D or K + T of 0: an empty grid
  pl.bsplits = cdiv(stages, pl.bstages);
  pl.ldl = cdiv(K + T, 4) * 4;
  return pl;
}

// B's hi and lo parts of one stage in wgmma's no-swizzle K-major layout
// (wgmma_tf32.cuh): core (n / 8, k / 4) at ((n / 8) * 8 + k / 4) * 128 bytes.
constexpr int kSplitFloats = kTile * kBK;                         // one part
// ring of raw A and B tiles, then B's hi and lo parts
constexpr int kSmemBytes = (kStages * 2 * kTile * kPadK + 2 * kSplitFloats) * 4;

// Splits one stage's raw B tile (K-major, n at Bs + n * kPadK) into its hi
// and lo parts in the core-matrix layout. Eight neighbouring threads fill
// one core matrix (128 contiguous bytes). Adds the squares of the values it
// splits to ss: this thread's share of column n = threadIdx.x % 64 (the
// threads t and t + 64 share a column).
__device__ __forceinline__ void split_b(const float* Bs, float* hi, float* lo, float& ss) {
#pragma unroll
  for (int i = 0; i < (kTile * kBK / 4) / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads, n = e % kTile, kq = e / kTile;
    const float4 v = *reinterpret_cast<const float4*>(Bs + n * kPadK + kq * 4);
    ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    uint4 h, l;
    split_tf32(v.x, h.x, l.x);
    split_tf32(v.y, h.y, l.y);
    split_tf32(v.z, h.z, l.z);
    split_tf32(v.w, h.w, l.w);
    const int at = ((n / 8) * 8 + kq) * (kCoreBytes / 4) + (n % 8) * 4;
    *reinterpret_cast<uint4*>(hi + at) = h;
    *reinterpret_cast<uint4*>(lo + at) = l;
  }
}

// Runs the ring over n stages into the warpgroup's 64 x 64 tile. A stage's
// raw tiles arrive in two slots (load(first, second, j)): 64 x kBK K-major
// (row stride kPadK), and 64 x kBK K-major or kBK x 64 M-major (row stride
// kPadN). Forward (kTransposed false): A is the first slot, B the second,
// both K-major. Backward (true): A is the second, M-major, and B the
// first: the product is dxh^T = M^T . dl^T, so that B, dl, is K-major as
// wgmma takes tf32 (the bank, summed over its rows, is M-major, and A's
// fragments are read by hand in any layout). Per stage, B is split into
// shared memory, each warp splits its 16 rows of A in registers, and per
// k = 8 step three wgmma add lo.hi, hi.lo, hi.hi (the small terms first);
// the stage's products complete before the next stage's split overwrites
// B's parts. Accumulator element i of a thread: row 16 * warp + lane / 4
// (+ 8 for i % 4 >= 2), column 8 * (i / 4) + 2 * (lane % 4) + i % 2.
// On the way it sums the squares of this thread's A values of those two
// rows (ss.a) and of its B values (ss.b, see split_b): the forward's norms.
struct SumSq {
  float a[2] = {0.0f, 0.0f};
  float b = 0.0f;
};

template <bool kTransposed, typename Load>
__device__ __forceinline__ void ring_product(float (&acc)[32], SumSq& ss, float* smem,
                                             int n, Load load) {
  constexpr int kSlot = kTile * kPadK;   // = kBK * kPadN
  float* first = smem;
  float* second = first + kStages * kSlot;
  float* hi = second + kStages * kSlot;
  float* lo = hi + kSplitFloats;
  const int warp = threadIdx.x / reid::kWarp, lane = threadIdx.x % reid::kWarp;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n) load(first + j * kSlot, second + j * kSlot, j);
    cp_async_commit();
  }
  for (int j = 0; j < n; ++j) {
    reid::cp_async_wait<kStages - 2>();
    __syncthreads();   // stage j has landed for all; slot (j - 1) is free
    const int next = j + kStages - 1, buf = j % kStages;
    if (next < n) {
      const int nb = next % kStages;
      load(first + nb * kSlot, second + nb * kSlot, next);
    }
    cp_async_commit();
    split_b((kTransposed ? first : second) + buf * kSlot, hi, lo, ss.b);
    reid::fence_proxy_async();
    __syncthreads();   // B's parts written and visible to the tensor cores
    uint32_t ah[4][4], al[4][4];
    const int m = warp * 16 + g;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      // A(m, k) for (m, k) = (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
      float v[4];
      if (kTransposed) {
        const float* a = second + buf * kSlot + (8 * s + t) * kPadN + m;
        v[0] = a[0]; v[1] = a[8]; v[2] = a[4 * kPadN]; v[3] = a[4 * kPadN + 8];
      } else {
        const float* a = first + buf * kSlot + m * kPadK + 8 * s + t;
        v[0] = a[0]; v[1] = a[8 * kPadK]; v[2] = a[4]; v[3] = a[8 * kPadK + 4];
      }
      ss.a[0] += v[0] * v[0] + v[2] * v[2];
      ss.a[1] += v[1] * v[1] + v[3] * v[3];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(v[i], ah[s][i], al[s][i]);
    }
    pin(acc);
    reid::wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      // k = 8s .. 8s + 7 are the core matrices 2s and 2s + 1 of each n group
      const uint64_t bh = smem_desc(hi + s * 2 * (kCoreBytes / 4), kCoreBytes, 8 * kCoreBytes);
      const uint64_t bl = smem_desc(lo + s * 2 * (kCoreBytes / 4), kCoreBytes, 8 * kCoreBytes);
      wgmma_tf32(acc, al[s], bh);
      wgmma_tf32(acc, ah[s], bl);
      wgmma_tf32(acc, ah[s], bh);
    }
    reid::wgmma_commit();
    reid::wgmma_wait<0>();
    pin(acc);
    pin(ah);
    pin(al);
  }
}

// Leaves the warpgroup's 64 x 64 accumulator tile in shared memory (rows
// of kRedStride floats; transposed with kTransposed), then the tile's 64
// row sums of squares of A and its 2 x 64 column shares of those of B, and
// waits for the cluster: after it, every block of the cluster can read
// every other block's tile.
constexpr int kRedRowSs = kTile * kRedStride;
constexpr int kRedColSs = kRedRowSs + kTile;

template <bool kTransposed>
__device__ __forceinline__ void share_tile(const float (&acc)[32], const SumSq& ss,
                                           float* red) {
  const int w = threadIdx.x / reid::kWarp, lane = threadIdx.x % reid::kWarp;
  __syncthreads();   // the ring is done with: red may reuse it
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * w + lane / 4 + 8 * h;
#pragma unroll
    for (int c = 0; c < kTile / 8; ++c) {
      const int col = 8 * c + 2 * (lane % 4);
      if (kTransposed) {
        red[col * kRedStride + r] = acc[4 * c + 2 * h];
        red[(col + 1) * kRedStride + r] = acc[4 * c + 2 * h + 1];
      } else {
        *reinterpret_cast<float2*>(red + r * kRedStride + col) =
            make_float2(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
      }
    }
    float a = ss.a[h];   // the row's four lanes, in a fixed order
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    a += __shfl_xor_sync(0xffffffffu, a, 2);
    if (lane % 4 == 0) red[kRedRowSs + 16 * w + lane / 4 + 8 * h] = a;
  }
  red[kRedColSs + threadIdx.x] = ss.b;
  cooperative_groups::this_cluster().sync();
}

__device__ __forceinline__ void add(float2& a, const float2& b) { a.x += b.x; a.y += b.y; }

__device__ __forceinline__ void add(float4& a, const float4& b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

// Columns c .. c + |V| - 1 of row r of the tile, summed over the cluster's
// blocks in rank order.
template <typename V>
__device__ __forceinline__ V cluster_sum(float* red, int r, int c) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks());
  V part[kMaxSplits];
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
    if (s < n)
      part[s] = *reinterpret_cast<const V*>(cluster.map_shared_rank(red, s) + r * kRedStride + c);
  V v = part[0];
#pragma unroll
  for (int s = 1; s < kMaxSplits; ++s)
    if (s < n) add(v, part[s]);
  return v;
}

// A row's (col = false) or a column's (col = true) sum of squares over the
// cluster's blocks in rank order.
__device__ __forceinline__ float cluster_sumsq(float* red, int i, bool col) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks());
  float part[kMaxSplits];
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    if (s < n) {
      const float* r = cluster.map_shared_rank(red, s);
      part[s] = col ? r[kRedColSs + i] + r[kRedColSs + kTile + i] : r[kRedRowSs + i];
    }
  }
  float v = part[0];
#pragma unroll
  for (int s = 1; s < kMaxSplits; ++s)
    if (s < n) v += part[s];
  return v;
}

// The rows of the tile that this block of the cluster finishes.
__device__ __forceinline__ void my_rows(int& r0, int& r1) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int per = cdiv(kTile, static_cast<int>(cluster.num_blocks()));
  r0 = min(kTile, static_cast<int>(cluster.block_rank()) * per);
  r1 = min(kTile, r0 + per);
}

// Logits tile (64 rows of x) x (64 columns), one D slice a block of the
// cluster (blockIdx.z, grid z = the cluster). Column tiles below ceil(K /
// 64) take the bank's rows, of which the first num_valid are live; the
// tiles after them take the T extra rows ex, all live, with the additive
// self-mask (row b / group == column t gets -10000), stored from column K
// of logits rows of K + T floats. The product runs on the raw rows; the
// norms come from the same tiles: r[b] = 1 / sqrt(sum_d x[b,d]^2 + 1e-12)
// and likewise rex[t] for an extra row, and
//   logits[b,k]   = (x[b] . M[k]) * r[b] / temp, or -inf for k >= num_valid
//   logits[b,K+t] = ((x[b] . ex[t]) * r[b] * rex[t] + mask) / temp.
// Writes the tile's logits and, per row, the max and the sum of exp over
// its columns to part_m, part_s at [tile * B + row]; the first column tile
// writes r (rnorm), the extra columns' first row tile rex (rexn).
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
infonce_logits_kernel(const float* __restrict__ x, const float* __restrict__ bank,
                      const int* __restrict__ num_valid, int K,
                      const float* __restrict__ ex, int T, int group, int B, int D,
                      int fslice, float temp, float* __restrict__ rnorm,
                      float* __restrict__ rexn, float* __restrict__ logits,
                      float* __restrict__ part_m, float* __restrict__ part_s) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int bank_tiles = cdiv(K, kTile), ld = K + T;
  const bool is_ex = static_cast<int>(blockIdx.x) >= bank_tiles;
  const float* __restrict__ rows = is_ex ? ex : bank;
  const int ncols = is_ex ? T : K, col0 = is_ex ? K : 0;
  const int k0 = (is_ex ? blockIdx.x - bank_tiles : blockIdx.x) * kTile;
  const int nv = is_ex ? T : min(*num_valid, K);
  const int b0 = blockIdx.y * kTile, tid = threadIdx.x;
  int r0, r1;
  my_rows(r0, r1);
  if (k0 >= nv) {   // a dead tile of the bank: the whole cluster skips it
    for (int e = tid; e < (r1 - r0) * kTile; e += kThreads) {
      const int b = b0 + r0 + e / kTile, k = k0 + e % kTile;
      if (b < B && k < ncols) logits[static_cast<size_t>(b) * ld + k] = -INFINITY;
    }
    return;
  }
  const int d_begin = blockIdx.z * fslice, d_end = min(D, d_begin + fslice);
  auto load = [&](float* first, float* second, int j) {   // A: x, B: the rows
    const int d0 = d_begin + j * kBK;
#pragma unroll
    for (int i = 0; i < (kTile * kBK / 4) / kThreads; ++i) {
      const int e = tid + i * kThreads, row = e / (kBK / 4), cq = (e % (kBK / 4)) * 4;
      const int d = d0 + cq;
      const bool va = b0 + row < B && d < d_end;
      cp_async16(first + row * kPadK + cq,
                 va ? x + static_cast<size_t>(b0 + row) * D + d : x, va);
      const bool vb = k0 + row < nv && d < d_end;
      cp_async16(second + row * kPadK + cq,
                 vb ? rows + static_cast<size_t>(k0 + row) * D + d : rows, vb);
    }
  };
  float acc[32] = {};
  SumSq ss;
  ring_product<false>(acc, ss, smem, cdiv(d_end - d_begin, kBK), load);
  share_tile<false>(acc, ss, smem);
  // the norms of this block's rows (and of the tile's extra columns), a
  // thread each
  __shared__ float rnorm_s[kTile], rex_s[kTile];
  if (tid < r1 - r0) {
    const float rb = 1.0f / sqrtf(cluster_sumsq(smem, r0 + tid, false) + 1e-12f);
    rnorm_s[tid] = rb;
    if (blockIdx.x == 0 && b0 + r0 + tid < B) rnorm[b0 + r0 + tid] = rb;
  }
  if (is_ex && tid >= kTile) {
    const int c = tid - kTile;
    rex_s[c] = 1.0f / sqrtf(cluster_sumsq(smem, c, true) + 1e-12f);
    if (blockIdx.y == 0 && r0 == 0 && k0 + c < T) rexn[k0 + c] = rex_s[c];
  }
  __syncthreads();
  // a warp a row, two neighbouring columns a lane: finish, write, and the
  // row's partials
  const int w = tid / reid::kWarp, lane = tid % reid::kWarp;
  for (int r = r0 + w; r < r1; r += kThreads / reid::kWarp) {
    const int b = b0 + r;
    const float rb = rnorm_s[r - r0];
    const float2 sum = cluster_sum<float2>(smem, r, 2 * lane);
    float v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + 2 * lane + h;
      const float a = h == 0 ? sum.x : sum.y;
      if (k >= ncols) {
        v[h] = -INFINITY;   // past the last column: in no partial
        continue;
      }
      v[h] = k >= nv ? -INFINITY
                     : (is_ex ? a * rb * rex_s[2 * lane + h] +
                                    (b / group == k ? -10000.0f : 0.0f)
                              : a * rb) / temp;
      if (b < B) logits[static_cast<size_t>(b) * ld + col0 + k] = v[h];
    }
    const float m = reid::warp_max(fmaxf(v[0], v[1]));
    float e = 0.0f;
    if (m != -INFINITY) e = expf(v[0] - m) + expf(v[1] - m);   // exp(-inf) = 0
    e = reid::warp_sum(e);
    if (lane == 0 && b < B) {
      part_m[static_cast<size_t>(blockIdx.x) * B + b] = m;
      part_s[static_cast<size_t>(blockIdx.x) * B + b] = e;
    }
  }
  cooperative_groups::this_cluster().sync();   // others may still read this tile
}

// A warp a row: merges the live column tiles' max and sum of exp in tile
// order (the bank's, then the extra columns'), then lse and the loss.
__global__ void __launch_bounds__(kRowThreads)
infonce_lse_kernel(const float* __restrict__ logits, const float* __restrict__ part_m,
                   const float* __restrict__ part_s, const int* __restrict__ num_valid,
                   const int* __restrict__ targets, int B, int K, int T,
                   float* __restrict__ lse, float* __restrict__ loss) {
  const int b = blockIdx.x * (kRowThreads / reid::kWarp) + threadIdx.x / reid::kWarp;
  const int lane = threadIdx.x % reid::kWarp;
  if (b >= B) return;
  const int live = cdiv(min(*num_valid, K), kTile), bank_tiles = cdiv(K, kTile);
  const int tiles = live + cdiv(T, kTile);
  float m = -INFINITY;
  for (int i = lane; i < tiles; i += reid::kWarp) {
    const int tile = i < live ? i : bank_tiles + (i - live);
    m = fmaxf(m, part_m[static_cast<size_t>(tile) * B + b]);
  }
  m = reid::warp_max(m);
  float s = 0.0f;
  if (m != -INFINITY) {
    for (int i = lane; i < tiles; i += reid::kWarp) {
      const size_t at = static_cast<size_t>(i < live ? i : bank_tiles + (i - live)) * B + b;
      if (part_m[at] != -INFINITY) s += part_s[at] * expf(part_m[at] - m);
    }
  }
  s = reid::warp_sum(s);
  if (lane == 0) {
    const float z = m + logf(s);
    const int y = targets[b];
    lse[b] = z;
    loss[b] = (y >= 0 && y < K) ? z - logits[static_cast<size_t>(b) * (K + T) + y]
                                  : __int_as_float(0x7fc00000);  // NaN
  }
}

// dl = (softmax - onehot) * g / temp, rows of ldl floats, zero past K + T;
// an extra column t also times rex[t], so that the product takes ex's raw
// rows. Only a bank column can be the target.
__global__ void __launch_bounds__(kRowThreads)
infonce_dl_kernel(const float* __restrict__ logits, const float* __restrict__ lse,
                  const int* __restrict__ targets, const float* __restrict__ grad,
                  const float* __restrict__ rexn, int K, int T, int ldl, float temp,
                  float* __restrict__ dl) {
  const int b = blockIdx.x, ld = K + T, y = targets[b];
  const float z = lse[b], gb = grad[b];
  const float* row = logits + static_cast<size_t>(b) * ld;
  float* out = dl + static_cast<size_t>(b) * ldl;
  for (int k = threadIdx.x; k < ldl; k += blockDim.x) {
    float v = 0.0f;
    if (k < ld) {
      const float p = expf(row[k] - z);
      v = (p - (k < K && k == y ? 1.0f : 0.0f)) * gb / temp;
      if (k >= K) v *= rexn[k - K];
    }
    out[k] = v;
  }
}

// A 64 x 64 tile of dxh = dl . [M; ex], one slice of bstages stages of the
// K + T reduction rows a block of the cluster (blockIdx.z, grid z = the
// cluster): reduction row k < K is bank row k (zero from num_valid on), row
// K + t is ex row t (dl's column already holds rex[t]). Stages that hold
// only dead bank rows are skipped. The product runs transposed (see
// ring_product); the cluster adds the slices in rank order and writes dxh,
// rows of D floats.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
infonce_dxh_kernel(const float* __restrict__ dl, int ldl, const float* __restrict__ bank,
                   const int* __restrict__ num_valid, int K,
                   const float* __restrict__ ex, int T, int B, int D, int bstages,
                   float* __restrict__ dxh) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nv = min(*num_valid, K);
  const int b0 = blockIdx.y * kTile, d0 = blockIdx.x * kTile;
  const int stages = cdiv(K + T, kBK);
  const int j0 = blockIdx.z * bstages, j1 = min(stages, j0 + bstages);
  // live stages: those with bank rows below num_valid, then those with extra rows
  const int a_stop = max(j0, min(j1, cdiv(nv, kBK)));
  const int b_start = T > 0 ? max(a_stop, K / kBK) : j1;
  const int n_a = a_stop - j0, n = n_a + max(0, j1 - b_start);
  const int tid = threadIdx.x;
  auto load = [&](float* first, float* second, int v) {
    const int k0 = (v < n_a ? j0 + v : b_start + (v - n_a)) * kBK;
#pragma unroll
    for (int i = 0; i < (kTile * kBK / 4) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      {  // first slot, B: dl, 64 rows (b) x kBK, K-major
        const int row = e / (kBK / 4), cq = (e % (kBK / 4)) * 4, k = k0 + cq;
        const bool va = b0 + row < B && k < ldl;
        cp_async16(first + row * kPadK + cq,
                   va ? dl + static_cast<size_t>(b0 + row) * ldl + k : dl, va);
      }
      {  // second slot, A: kBK reduction rows x 64 of D, M-major
        const int row = e / (kTile / 4), cq = (e % (kTile / 4)) * 4, k = k0 + row;
        const float* src = k < K ? (k < nv ? bank + static_cast<size_t>(k) * D : nullptr)
                                 : (k - K < T ? ex + static_cast<size_t>(k - K) * D : nullptr);
        const bool vb = src != nullptr && d0 + cq < D;
        cp_async16(second + row * kPadN + cq, vb ? src + d0 + cq : bank, vb);
      }
    }
  };
  float acc[32] = {};
  SumSq ss;   // the norms are the forward's; unused here
  ring_product<true>(acc, ss, smem, n, load);   // dxh^T: rows d, columns b
  share_tile<true>(acc, ss, smem);
  int r0, r1;
  my_rows(r0, r1);
  // a float4 of 4 columns a thread per step; D % 4 == 0
  for (int e = tid; e < (r1 - r0) * (kTile / 4); e += kThreads) {
    const int r = r0 + e / (kTile / 4), c = (e % (kTile / 4)) * 4;
    const int b = b0 + r, d = d0 + c;
    const float4 v = cluster_sum<float4>(smem, r, c);
    if (b < B && d < D) *reinterpret_cast<float4*>(dxh + static_cast<size_t>(b) * D + d) = v;
  }
  cooperative_groups::this_cluster().sync();   // others may still read this tile
}

// One block a row: dx = r * (dxh - xh * (xh . dxh)) with xh = x * r, a
// float4 a thread per step.
__global__ void __launch_bounds__(kRowThreads)
infonce_l2n_backward_kernel(const float* __restrict__ x, const float* __restrict__ rnorm,
                            const float* __restrict__ dxh, int D, float* __restrict__ dx) {
  __shared__ float scratch[kRowThreads / reid::kWarp];
  const size_t row = static_cast<size_t>(blockIdx.x) * D / 4;
  const float4* xr = reinterpret_cast<const float4*>(x) + row;
  const float4* gr = reinterpret_cast<const float4*>(dxh) + row;
  const int d4 = D / 4;
  const float r = rnorm[blockIdx.x];
  float dot = 0.0f;
#pragma unroll 4
  for (int i = threadIdx.x; i < d4; i += blockDim.x) {
    const float4 v = gr[i], a = xr[i];
    dot += a.x * r * v.x + a.y * r * v.y + a.z * r * v.z + a.w * r * v.w;
  }
  dot = reid::block_sum(dot, scratch);
  float4* o = reinterpret_cast<float4*>(dx) + row;
#pragma unroll 4
  for (int i = threadIdx.x; i < d4; i += blockDim.x) {
    const float4 v = gr[i], a = xr[i];
    o[i] = make_float4(r * (v.x - a.x * r * dot), r * (v.y - a.y * r * dot),
                       r * (v.z - a.z * r * dot), r * (v.w - a.w * r * dot));
  }
}

// Launches a product kernel as clusters of `splits` blocks along grid z.
template <typename Kernel, typename... Args>
int launch_clusters(Kernel kernel, dim3 grid, int splits, cudaStream_t st, Args... args) {
  int rc = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes));
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args...));
  return rc != 0 ? rc : reid::launch_status();
}

}  // namespace

// The fp32 scratch of K6 for these sizes: of reid_infonce_forward
// (backward = 0: the column tiles' row max and sum of exp, part_m then
// part_s, 2 x tiles x B) or of reid_infonce_backward (backward = 1: dl,
// B x ldl, then dxh, B x D).
extern "C" long long reid_infonce_scratch(int B, int K, int T, int D, int backward) {
  if (backward)
    return static_cast<long long>(B) * (make_plan(B, K, T, D).ldl + D);
  return 2LL * (cdiv(K, kTile) + cdiv(T, kTile)) * B;
}

// x: (B, D) fp32; bank: (K, D) fp32; ex: (T, D) fp32 or null with T = 0;
// all contiguous, 16-byte aligned, D % 4 == 0. num_valid: one int32 on the
// device; targets: (B,) int32 in [0, K); group: the extra columns' self-mask
// group (> 0 when T > 0).
// Outputs: rnorm (B,) = 1 / |x|, rexn (T,) = 1 / |ex|, logits (B, K + T),
// lse (B,), loss (B,); a target outside [0, K) gives a NaN loss.
// part: reid_infonce_scratch(B, K, T, D, 0) fp32.
extern "C" int reid_infonce_forward(const void* x, const void* bank,
                                    const void* num_valid, const void* targets,
                                    int B, int K, int D, float temp, const void* ex,
                                    int T, int group, void* rnorm, void* rexn,
                                    void* logits, void* part, void* lse, void* loss,
                                    void* stream) {
  const Plan pl = make_plan(B, K, T, D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = cdiv(K, kTile) + cdiv(T, kTile);
  float* part_m = static_cast<float*>(part);
  float* part_s = part_m + static_cast<size_t>(tiles) * B;
  int rc = launch_clusters(infonce_logits_kernel,
                           dim3(tiles, cdiv(B, kTile), pl.fsplits), pl.fsplits, st,
                           static_cast<const float*>(x), static_cast<const float*>(bank),
                           static_cast<const int*>(num_valid), K,
                           static_cast<const float*>(ex), T, group, B, D, pl.fslice, temp,
                           static_cast<float*>(rnorm), static_cast<float*>(rexn),
                           static_cast<float*>(logits), part_m, part_s);
  if (rc != 0) return rc;
  constexpr int rows_per_block = kRowThreads / reid::kWarp;
  infonce_lse_kernel<<<cdiv(B, rows_per_block), kRowThreads, 0, st>>>(
      static_cast<const float*>(logits), part_m, part_s,
      static_cast<const int*>(num_valid), static_cast<const int*>(targets), B, K, T,
      static_cast<float*>(lse), static_cast<float*>(loss));
  return reid::launch_status();
}

// The forward's x, rnorm, logits, lse, ex and rexn (null with T = 0).
// grad: (B,) fp32 = dL/dloss. scratch: reid_infonce_scratch(B, K, T, D, 1)
// fp32. dx: (B, D) fp32.
extern "C" int reid_infonce_backward(const void* x, const void* rnorm,
                                     const void* bank, const void* num_valid,
                                     const void* targets, const void* logits,
                                     const void* lse, const void* grad, int B,
                                     int K, int D, float temp, const void* ex,
                                     const void* rexn, int T, void* scratch, void* dx,
                                     void* stream) {
  const Plan pl = make_plan(B, K, T, D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dl = static_cast<float*>(scratch);
  float* dxh = dl + static_cast<size_t>(B) * pl.ldl;
  infonce_dl_kernel<<<B, kRowThreads, 0, st>>>(
      static_cast<const float*>(logits), static_cast<const float*>(lse),
      static_cast<const int*>(targets), static_cast<const float*>(grad),
      static_cast<const float*>(rexn), K, T, pl.ldl, temp, dl);
  int rc = reid::launch_status();
  if (rc != 0) return rc;
  rc = launch_clusters(infonce_dxh_kernel,
                       dim3(cdiv(D, kTile), cdiv(B, kTile), pl.bsplits), pl.bsplits, st,
                       static_cast<const float*>(dl), pl.ldl,
                       static_cast<const float*>(bank), static_cast<const int*>(num_valid),
                       K, static_cast<const float*>(ex), T, B, D, pl.bstages, dxh);
  if (rc != 0) return rc;
  infonce_l2n_backward_kernel<<<B, kRowThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(rnorm), dxh, D,
      static_cast<float*>(dx));
  return reid::launch_status();
}
