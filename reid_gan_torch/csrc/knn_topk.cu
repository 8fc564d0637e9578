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
// N (N + 1) / 2 products of the upper triangle: N (N + 1) D flops (3.43e11
// at N 12,936, D 2048: 5.12 ms at 67 TFLOP/s fp32), against N D + 2 N k
// words of traffic. This kernel computes both triangles, 2 N^2 D. The products are
// fp32 FMA with no TF32: TF32 keeps ~3 digits and would reorder neighbours,
// which changes the Jaccard distances and the labels. The N x N matrix never
// exists. A block owns 64 query rows and walks its share of the gallery in
// tiles of 64 rows: a plain tiled FMA product (4x4 outputs a thread, depth
// 32 a stage in shared memory), then each warp filters its 8 rows' 64
// candidates against the row's current k-th key (a ballot; after the first
// tiles almost every candidate fails) and inserts the few survivors into
// the row's sorted list, which lives in the warp's registers (slots lane and
// lane + 32). A block walks its gallery in ascending index order, so a
// candidate equal to a listed key always goes after it, which is the tie
// order. The gallery is split over blockIdx.y so that enough blocks fill the
// card at Market-1501's N; a last pass merges each row's per-split lists.
//
// k above 64 (up to N): the row's list no longer fits two register slots a
// lane, so it lives in the split's own output rows of the scratch
// (part_key/part_idx, k entries a row, L1/L2 resident), kept sorted by its
// warp: the position is a ballot count over the list's 32-entry chunks, and
// the entries behind it shift one place up, chunk by chunk from the end.
// The same filter (a candidate must beat the k-th key) keeps the inserts
// few after the first tiles, and the same ascending walk keeps the tie
// order, so the merge pass is unchanged.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTile = 64;      // query rows and gallery rows per tile
constexpr int kDepth = 32;     // D per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kWarps = kThreads / reid::kWarp;
constexpr int kRowsPerWarp = kTile / kWarps;  // 8
constexpr int kRegK = 2 * reid::kWarp;        // two list slots a lane
constexpr int kTargetBlocks = 528;            // 4 a streaming multiprocessor
constexpr int kMaxSplits = 8;
constexpr int kMergeThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Gallery tiles per split, and the number of splits (none empty).
void split_geometry(int n, int* per, int* splits) {
  const int tiles = ceil_div(n, kTile);
  int s = ceil_div(kTargetBlocks, tiles);
  s = s < 1 ? 1 : (s > kMaxSplits ? kMaxSplits : s);
  s = s > tiles ? tiles : s;
  *per = ceil_div(tiles, s);
  *splits = ceil_div(tiles, *per);
}

// |x_q|^2, one warp a row, summed as x*x in FMA.
__global__ void __launch_bounds__(kThreads)
row_norms_kernel(const float* __restrict__ x, int n, int d, float* __restrict__ norms) {
  const int row = blockIdx.x * kWarps + threadIdx.x / reid::kWarp;
  const int lane = threadIdx.x % reid::kWarp;
  if (row >= n) return;  // the whole warp leaves together
  const float* xr = x + static_cast<size_t>(row) * d;
  float s = 0.0f;
  for (int j = lane; j < d; j += reid::kWarp) s = fmaf(xr[j], xr[j], s);
  s = reid::warp_sum(s);
  if (lane == 0) norms[row] = s;
}

// One row's sorted list: slot `lane` in (klo, ilo), slot `lane + 32` in
// (khi, ihi); unused slots hold (+inf, INT32_MAX).
struct RowList {
  float klo, khi;
  int ilo, ihi;
};

__device__ __forceinline__ float kth_key(const RowList& l, int k) {
  const float v = (k - 1) >= reid::kWarp ? l.khi : l.klo;
  return __shfl_sync(kFull, v, (k - 1) % reid::kWarp);
}

// Insert (v, gi), known to beat the k-th key and to have a higher index than
// every listed entry: it goes after every key <= v.
__device__ __forceinline__ void insert(RowList& l, float v, int gi, int k, int lane) {
  const int pos = __popc(__ballot_sync(kFull, l.klo <= v)) +
                  __popc(__ballot_sync(kFull, l.khi <= v));
  const float up_lo = __shfl_up_sync(kFull, l.klo, 1);
  const int iup_lo = __shfl_up_sync(kFull, l.ilo, 1);
  const float last_lo = __shfl_sync(kFull, l.klo, reid::kWarp - 1);
  const int ilast_lo = __shfl_sync(kFull, l.ilo, reid::kWarp - 1);
  float up_hi = __shfl_up_sync(kFull, l.khi, 1);
  int iup_hi = __shfl_up_sync(kFull, l.ihi, 1);
  if (lane == 0) {
    up_hi = last_lo;
    iup_hi = ilast_lo;
  }
  const int s_lo = lane, s_hi = lane + reid::kWarp;
  if (s_lo > pos) {
    l.klo = up_lo;
    l.ilo = iup_lo;
  } else if (s_lo == pos) {
    l.klo = v;
    l.ilo = gi;
  }
  if (s_hi > pos) {
    l.khi = up_hi;
    l.ihi = iup_hi;
  } else if (s_hi == pos) {
    l.khi = v;
    l.ihi = gi;
  }
  if (s_lo >= k) {
    l.klo = INFINITY;
    l.ilo = INT32_MAX;
  }
  if (s_hi >= k) {
    l.khi = INFINITY;
    l.ihi = INT32_MAX;
  }
}

// The list of k > kRegK entries in global scratch (lk, li), sorted by
// (key, index): insert (v, gi), known to beat lk[k - 1] and to have a higher
// index than every listed entry, after every key <= v. Every lane of the
// warp calls it with the same arguments.
__device__ __forceinline__ void insert_global(float* lk, int* li, float v, int gi, int k,
                                              int lane) {
  int pos = 0;
  for (int c = 0; c < k; c += reid::kWarp) {
    const int i = c + lane;
    pos += __popc(__ballot_sync(kFull, i < k && lk[i] <= v));
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

// Stage a (kTile x kDepth) slice of rows [r0, r_end) starting at column d0,
// transposed into s[depth][row]; rows and columns past the ends read zero.
__device__ __forceinline__ void stage(float (*s)[kTile + 4], const float* __restrict__ x,
                                     int r0, int r_end, int d0, int d, int tid) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = tid + h * kThreads;
    const int row = f / (kDepth / 4), dq = (f % (kDepth / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < r_end && d0 + dq < d)
      v = *reinterpret_cast<const float4*>(x + static_cast<size_t>(r0 + row) * d + d0 + dq);
    s[dq][row] = v.x;
    s[dq + 1][row] = v.y;
    s[dq + 2][row] = v.z;
    s[dq + 3][row] = v.w;
  }
}

// grid (query tiles, splits). Writes each query row's sorted k keys and
// indices over gallery split blockIdx.y to part_*[(split * n + q) * k + s].
// kGlobal: the lists live there during the walk (k > kRegK), else in
// registers until the end.
template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
knn_tile_kernel(const float* __restrict__ x, const float* __restrict__ norms, int n,
                int d, int k, int l2, int tiles_per_split, float* part_key,
                int* part_idx) {
  __shared__ __align__(16) float As[kDepth][kTile + 4];
  __shared__ __align__(16) float Bs[kDepth][kTile + 4];
  __shared__ float keys[kTile][kTile + 1];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int lane = tid % reid::kWarp, warp = tid / reid::kWarp;
  const int q0 = blockIdx.x * kTile;
  const int g_begin = blockIdx.y * tiles_per_split * kTile;
  const int g_end = min(n, g_begin + tiles_per_split * kTile);

  RowList lists[kGlobal ? 1 : kRowsPerWarp];
  if constexpr (kGlobal) {
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int q = q0 + warp * kRowsPerWarp + r;
      if (q >= n) continue;
      const size_t base = (static_cast<size_t>(blockIdx.y) * n + q) * k;
      for (int s = lane; s < k; s += reid::kWarp) {
        part_key[base + s] = INFINITY;
        part_idx[base + s] = INT32_MAX;
      }
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) lists[r] = {INFINITY, INFINITY, INT32_MAX, INT32_MAX};
  }

  float qn[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty * 4 + i;
    qn[i] = (l2 && q < n) ? norms[q] : 0.0f;
  }

  for (int g0 = g_begin; g0 < g_end; g0 += kTile) {
    float acc[4][4] = {};
    for (int d0 = 0; d0 < d; d0 += kDepth) {
      stage(As, x, q0, n, d0, d, tid);
      stage(Bs, x, g0, g_end, d0, d, tid);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float a[4] = {av.x, av.y, av.z, av.w};
        const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
    // epilogue: keys of the tile; gallery rows past the split never enter
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int g = g0 + tx * 4 + j;
      const float gn = (l2 && g < g_end) ? norms[g] : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v;
        if (g >= g_end)
          v = INFINITY;
        else if (l2)
          v = fmaxf((qn[i] + gn) - 2.0f * acc[i][j], 0.0f);
        else
          v = -acc[i][j];
        keys[ty * 4 + i][tx * 4 + j] = v;
      }
    }
    __syncthreads();
    // merge: warp w owns rows w*8 .. w*8+7 of the query tile
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      float* lk = nullptr;
      int* li = nullptr;
      float thr;
      if constexpr (kGlobal) {
        if (q0 + row >= n) continue;  // the whole warp skips the row
        const size_t base = (static_cast<size_t>(blockIdx.y) * n + q0 + row) * k;
        lk = part_key + base;
        li = part_idx + base;
        thr = lk[k - 1];
      } else {
        thr = kth_key(lists[r], k);
      }
      unsigned m0 = __ballot_sync(kFull, keys[row][lane] < thr);
      unsigned m1 = __ballot_sync(kFull, keys[row][lane + reid::kWarp] < thr);
      while (m0 | m1) {  // the same masks in every lane: the loop is uniform
        int c;
        if (m0) {
          c = __ffs(m0) - 1;
          m0 &= m0 - 1;
        } else {
          c = reid::kWarp + __ffs(m1) - 1;
          m1 &= m1 - 1;
        }
        const float v = keys[row][c];
        if (v < thr) {
          if constexpr (kGlobal) {
            insert_global(lk, li, v, g0 + c, k, lane);
            thr = lk[k - 1];
          } else {
            insert(lists[r], v, g0 + c, k, lane);
            thr = kth_key(lists[r], k);
          }
        }
      }
    }
    __syncthreads();  // keys is rewritten by the next tile
  }

  if constexpr (kGlobal) return;  // the lists are already in place
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int q = q0 + warp * kRowsPerWarp + r;
    if (q >= n) continue;
    const size_t base = (static_cast<size_t>(blockIdx.y) * n + q) * k;
    if (lane < k) {
      part_key[base + lane] = lists[r].klo;
      part_idx[base + lane] = lists[r].ilo;
    }
    if (lane + reid::kWarp < k) {
      part_key[base + lane + reid::kWarp] = lists[r].khi;
      part_idx[base + lane + reid::kWarp] = lists[r].ihi;
    }
  }
}

// One thread a row: merge the splits' sorted lists in (key, index) order.
__global__ void __launch_bounds__(kMergeThreads)
knn_merge_kernel(const float* __restrict__ part_key, const int* __restrict__ part_idx,
                 int n, int k, int splits, int l2, float* __restrict__ vals,
                 int* __restrict__ idx) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  int pos[kMaxSplits];
  for (int s = 0; s < splits; ++s) pos[s] = 0;
  for (int o = 0; o < k; ++o) {
    int best = -1;
    float bk = INFINITY;
    int bi = INT32_MAX;
    for (int s = 0; s < splits; ++s) {
      if (pos[s] >= k) continue;
      const size_t at = (static_cast<size_t>(s) * n + q) * k + pos[s];
      const float kv = part_key[at];
      const int iv = part_idx[at];
      if (best < 0 || kv < bk || (kv == bk && iv < bi)) {
        best = s;
        bk = kv;
        bi = iv;
      }
    }
    ++pos[best];
    vals[static_cast<size_t>(q) * k + o] = l2 ? bk : -bk;
    idx[static_cast<size_t>(q) * k + o] = bi;
  }
}

}  // namespace

// Elements of each of the two per-split buffers (keys fp32, indices int32).
extern "C" long long reid_knn_topk_scratch(int n, int k) {
  int per, splits;
  split_geometry(n, &per, &splits);
  return static_cast<long long>(splits) * n * k;
}

// x: (n, d) fp32 row-major, d % 4 == 0, 16-byte aligned. norms: (n,) fp32
// scratch (written when l2). part_key / part_idx: reid_knn_topk_scratch(n, k)
// elements each. vals (n, k) fp32 and idx (n, k) int32 out. 1 <= k <= n.
// l2: 1 for squared L2 distance, 0 for inner product.
extern "C" int reid_knn_topk(const void* x, int n, int d, int k, int l2, void* norms,
                             void* part_key, void* part_idx, void* vals, void* idx,
                             void* stream) {
  if (n < 1 || k < 1 || k > n || d < 1 || d % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* nf = static_cast<float*>(norms);
  if (l2) row_norms_kernel<<<ceil_div(n, kWarps), kThreads, 0, st>>>(xf, n, d, nf);
  int per, splits;
  split_geometry(n, &per, &splits);
  const dim3 grid(ceil_div(n, kTile), splits);
  if (k <= kRegK)
    knn_tile_kernel<false><<<grid, kThreads, 0, st>>>(xf, nf, n, d, k, l2, per,
                                                      static_cast<float*>(part_key),
                                                      static_cast<int*>(part_idx));
  else
    knn_tile_kernel<true><<<grid, kThreads, 0, st>>>(xf, nf, n, d, k, l2, per,
                                                     static_cast<float*>(part_key),
                                                     static_cast<int*>(part_idx));
  knn_merge_kernel<<<ceil_div(n, kMergeThreads), kMergeThreads, 0, st>>>(
      static_cast<const float*>(part_key), static_cast<const int*>(part_idx), n, k,
      splits, l2, static_cast<float*>(vals), static_cast<int*>(idx));
  return reid::launch_status();
}
