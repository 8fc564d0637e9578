// K3: per-query rank statistics (average precision, first-match CMC bin,
// number of valid matches) from a (q, n) distance block.
//
// Replaces: reid_gan_tpu/engine/metrics.py::_chunk_stats_jax (metrics.py:
// 213-259), the fused rank pass that the JAX package jits per query chunk
// behind the distance product (_chunk_stats_feats_jax, :265-279; caller
// rank_metrics_features, :282-352). There: a stable argsort by distance, drop
// same-id-same-camera entries, scatter-compact, cumsums, tie-group ends.
//
// This kernel computes the same numbers without sorting. For query i, with
// valid entries V (gallery id != query id, or camera != query camera) and
// valid matches M (gallery id == query id, camera != query camera):
//   AP        = (1/|M|) sum_{m in M} #{v in M : d_v <= d_m} / #{v in V : d_v <= d_m}
//               (the tie-exact distinct-threshold AP of metrics.py:236-244:
//               every entry tied with d_m counts as ranked before it)
//   first bin = #{v in V : (d_v, v) < (d_m*, m*)}, m* the (distance, index)-
//               smallest valid match (the stable argsort's first match)
// so it equals the JAX backend, ties included, at any gallery size.
//
// The variants of fd_evaluate_all (reid_gan_tpu/engine/fdgan.py:155-205,
// through _rank_metrics_jax, metrics.py:355-392):
//   separate camera set: V also drops every entry of the query's camera
//               (g_cam != q_cam), which changes AP, the first bin and M;
//   all shots (first_match_break=False): each valid match m adds 1 / |M|
//               to bin #{v in V \ M : (d_v, v) < (d_m, m)}, the number of
//               valid non-matches ranked before it, which is JAX's
//               valid_rank - (matches before it) (metrics.py:250-256).
// The all-shots bins go to a (q, topk) row of the query's own block,
// written by its thread 0 alone (1 / |M| added to one bin in any order is
// the same float), and the caller sums the rows in a fixed order, so the
// histogram does not depend on atomics. Staging then keeps each match's
// gallery index beside its distance, and a row pass keeps a third counter
// per staged match.
//
// Bound: bytes. The block is read once from device memory (q x n fp32; 214 MB
// at Market-1501's 3,368 x 15,913, ~64 us at 3.35 TB/s); ids and cameras are
// shared by all queries and stay in L2. Design: one block per query row.
// Pass 0 counts the valid matches and finds m*. The matches are then staged
// in shared memory in index order, up to kCap per round (tiles of one block
// width, so any number of matches is handled in rounds), and each further
// pass over the row counts, for kGroup staged matches at a time held in
// registers, the valid entries and valid matches at or below each match's
// distance. A row costs 1 + ceil(|M| / kGroup) passes; re-reads of the row
// (64 KB at Market scale) hit L1/L2, and |M| is ~20 on re-ID galleries.
// The AP terms are summed in double by thread 0, so the order in which
// matches are staged does not move the result.
#include <float.h>
#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCap = 1024;   // staged matches per round (>= kThreads)
constexpr int kGroup = 8;    // matches counted per row pass

__device__ __forceinline__ bool lex_less(float da, int ja, float db, int jb) {
  return da < db || (da == db && ja < jb);
}

// kAllShots: also write the query's all-shots row hist[row, 0 .. topk).
template <bool kAllShots>
__global__ void __launch_bounds__(kThreads)
rank_stats_kernel(const float* __restrict__ d, const int* __restrict__ qid,
                  const int* __restrict__ qcam, const int* __restrict__ gid,
                  const int* __restrict__ gcam, int n, int sep,
                  float* __restrict__ ap_out, int* __restrict__ first_out,
                  int* __restrict__ nm_out, float* __restrict__ hist, int topk) {
  constexpr int kCounters = (kAllShots ? 3 : 2) * kGroup + 1;
  __shared__ float md[kCap];
  __shared__ int mj[kAllShots ? kCap : 1];
  __shared__ int s_slot;
  __shared__ int iscratch[kThreads / reid::kWarp];
  __shared__ int red[kCounters][kThreads / reid::kWarp];
  __shared__ float best_d_w[kThreads / reid::kWarp];
  __shared__ int best_j_w[kThreads / reid::kWarp];

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % reid::kWarp, warp = tid / reid::kWarp;
  const int nwarps = kThreads / reid::kWarp;
  const float* dr = d + static_cast<size_t>(row) * n;
  const int qi = qid[row], qc = qcam[row];
  float* hrow = kAllShots ? hist + static_cast<size_t>(row) * topk : nullptr;
  if constexpr (kAllShots) {
    for (int b = tid; b < topk; b += kThreads) hrow[b] = 0.0f;
    __syncthreads();  // thread 0 adds to the row below
  }

  // ---- pass 0: number of valid matches and the first one in (d, j) order
  int nm = 0;
  float bd = FLT_MAX;
  int bj = INT_MAX;
  for (int j = tid; j < n; j += kThreads) {
    if (gid[j] == qi && gcam[j] != qc) {
      ++nm;
      const float dj = dr[j];
      if (bj == INT_MAX || lex_less(dj, j, bd, bj)) { bd = dj; bj = j; }
    }
  }
  nm = reid::block_sum(nm, iscratch);
  if (nm == 0) {
    if (tid == 0) { ap_out[row] = 0.0f; first_out[row] = 0; nm_out[row] = 0; }
    return;
  }
#pragma unroll
  for (int o = reid::kWarp / 2; o > 0; o >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, bd, o);
    const int oj = __shfl_xor_sync(0xffffffffu, bj, o);
    if (oj != INT_MAX && (bj == INT_MAX || lex_less(od, oj, bd, bj))) { bd = od; bj = oj; }
  }
  if (lane == 0) { best_d_w[warp] = bd; best_j_w[warp] = bj; }
  __syncthreads();
  for (int w = 0; w < nwarps; ++w) {
    const int oj = best_j_w[w];
    if (oj != INT_MAX && (bj == INT_MAX || lex_less(best_d_w[w], oj, bd, bj))) {
      bd = best_d_w[w]; bj = oj;
    }
  }

  // ---- rounds: stage up to kCap matches, then count against them
  double ap_acc = 0.0;   // meaningful in thread 0
  int first_bin = 0;
  bool first_pass = true;
  int tile = 0;
  while (tile < n) {
    if (tid == 0) s_slot = 0;
    __syncthreads();
    int staged = 0;  // identical in every thread
    for (; tile < n; tile += kThreads) {
      const int j = tile + tid;
      const bool is_m = j < n && gid[j] == qi && gcam[j] != qc;
      const int cnt = __syncthreads_count(is_m);
      if (staged + cnt > kCap) break;
      if (is_m) {
        const int slot = atomicAdd(&s_slot, 1);
        md[slot] = dr[j];
        if constexpr (kAllShots) mj[slot] = j;
      }
      staged += cnt;
    }
    __syncthreads();

    for (int g0 = 0; g0 < staged; g0 += kGroup) {
      const int kn = min(kGroup, staged - g0);
      float dm[kGroup];
      int jm[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        dm[k] = k < kn ? md[g0 + k] : -FLT_MAX;
        jm[k] = kAllShots && k < kn ? mj[g0 + k] : -1;
      }
      int cv[kGroup], cm[kGroup], cn[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) { cv[k] = 0; cm[k] = 0; cn[k] = 0; }
      int cb = 0;
      for (int j = tid; j < n; j += kThreads) {
        const int gj = gid[j], cj = gcam[j];
        const float dj = dr[j];
        const bool valid = (gj != qi || cj != qc) && (!sep || cj != qc);
        const bool vmatch = gj == qi && cj != qc;
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          const bool le = valid && dj <= dm[k];
          cv[k] += le;
          cm[k] += le && vmatch;
          if constexpr (kAllShots) cn[k] += valid && !vmatch && lex_less(dj, j, dm[k], jm[k]);
        }
        if (first_pass) cb += valid && lex_less(dj, j, bd, bj);
      }
      // block reduction of the 2 * kGroup + 1 counters
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        cv[k] = reid::warp_sum(cv[k]);
        cm[k] = reid::warp_sum(cm[k]);
        if constexpr (kAllShots) cn[k] = reid::warp_sum(cn[k]);
      }
      cb = reid::warp_sum(cb);
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          red[k][warp] = cv[k];
          red[kGroup + k][warp] = cm[k];
          if constexpr (kAllShots) red[2 * kGroup + 1 + k][warp] = cn[k];
        }
        red[2 * kGroup][warp] = cb;
      }
      __syncthreads();
      if (tid == 0) {
        for (int k = 0; k < kn; ++k) {
          int v = 0, m = 0;
          for (int w = 0; w < nwarps; ++w) { v += red[k][w]; m += red[kGroup + k][w]; }
          ap_acc += static_cast<double>(m) / static_cast<double>(v);
          if constexpr (kAllShots) {
            int b = 0;
            for (int w = 0; w < nwarps; ++w) b += red[2 * kGroup + 1 + k][w];
            if (b < topk) hrow[b] += 1.0f / static_cast<float>(nm);
          }
        }
        if (first_pass) {
          int b = 0;
          for (int w = 0; w < nwarps; ++w) b += red[2 * kGroup][w];
          first_bin = b;
        }
      }
      first_pass = false;
      __syncthreads();  // red and md are reused
    }
  }
  if (tid == 0) {
    ap_out[row] = static_cast<float>(ap_acc / nm);
    first_out[row] = first_bin;
    nm_out[row] = nm;
  }
}

}  // namespace

// d: (q, n) fp32 contiguous. qid/qcam: q int32. gid/gcam: n int32.
// sep: 1 drops the query's camera from the valid set.
// Outputs, q each: ap (fp32), first_bin (int32), num_matches (int32); with
// topk > 0 also hist, (q, topk) fp32, each query's all-shots row.
extern "C" int reid_rank_stats(const void* d, const void* qid, const void* qcam,
                               const void* gid, const void* gcam, int q, int n, int sep,
                               void* ap, void* first_bin, void* num_matches, void* hist,
                               int topk, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (topk > 0)
    rank_stats_kernel<true><<<q, kThreads, 0, st>>>(
        static_cast<const float*>(d), static_cast<const int*>(qid),
        static_cast<const int*>(qcam), static_cast<const int*>(gid),
        static_cast<const int*>(gcam), n, sep, static_cast<float*>(ap),
        static_cast<int*>(first_bin), static_cast<int*>(num_matches),
        static_cast<float*>(hist), topk);
  else
    rank_stats_kernel<false><<<q, kThreads, 0, st>>>(
        static_cast<const float*>(d), static_cast<const int*>(qid),
        static_cast<const int*>(qcam), static_cast<const int*>(gid),
        static_cast<const int*>(gcam), n, sep, static_cast<float*>(ap),
        static_cast<int*>(first_bin), static_cast<int*>(num_matches), nullptr, 0);
  return reid::launch_status();
}
