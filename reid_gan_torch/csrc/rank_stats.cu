// K3: per-query rank statistics (average precision, first-match CMC bin,
// number of valid matches) from a (q, n) distance block.
//
// Replaces: reid_gan_tpu/engine/metrics.py::_chunk_stats_jax (metrics.py:
// 213-259), the fused rank pass that the JAX package jits per query chunk
// behind the distance product (_chunk_stats_feats_jax, :265-279; caller
// rank_metrics_features, :282-352). There: a stable argsort by distance, drop
// same-id-same-camera entries, scatter-compact, cumsums, tie-group ends.
//
// This kernel computes the same numbers without sorting the row. For query
// i, with valid entries V (gallery id != query id, or camera != query
// camera) and valid matches M (gallery id == query id, camera != query
// camera):
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
// The all-shots bins go to a (q, topk) row of the query's own, written by
// one lane (1 / |M| added to a bin in any order is the same float), and the
// caller sums the rows in a fixed order.
//
// Bound: bytes. The block is read once from device memory (q x n fp32: 65 MB
// for Market-1501's 1,024-query chunk against 15,913 gallery images, 19.5 us
// at 3.35 TB/s). Only the valid entries at or below a row's farthest match
// need counting: about a tenth of a Market row. Design: a block takes a few
// query rows whose first 16-byte aligned column is the same (rows `period`
// apart; 4 rows and two blocks an SM at first match, 8 rows and one block
// with the all-shots counters), and its 16 warps split the gallery into
// steps of 128 columns, a warp taking a step for all the block's rows, so
// the block reads each id (and camera) once, and no barrier holds a warp
// back. A row:
//   1. the warps test each step's ids against every row's id and append a
//      row's same-id entries to its list (a shared atomic for the rare lane
//      that finds one); the row's warp then loads their cameras and
//      distances at once, keeps the matches and sorts them by (distance,
//      index) in the warp (|M| is ~18 at Market, ~25 at MSMT17);
//   2. a warp copies its next step of the rows' distances into its own
//      shared-memory slot (cp.async, 16 bytes a lane) and its next step's
//      ids (and cameras) into registers while it counts a step. For each
//      row it gathers the valid entries at or below the farthest match
//      into its scratch (a ballot a column), then buckets them a lane each:
//      by binary search into the sorted match distances (entries at or
//      below the nearest match go to bucket 0 without one) and, for the
//      all-shots rows, by (distance, index) into the sorted matches. Each
//      bucket is a per-lane counter in shared memory, bumped by a shared
//      reduction no one waits for (no bank conflicts);
//   3. the row's warp turns the buckets into prefix sums: #{v in V \ M :
//      d_v <= s_k} and the lex counts; #{v in M : d_v <= s_k} comes from the
//      sorted list. The AP terms are summed in double, in sorted order, by
//      one lane, so a launch gives the same bits as the last.
// A row with more than kCap same-id entries takes rounds: its block then
// rescans the ids in index order for each round's kCap of them (one warp a
// row), loads the cameras too, and buckets the matches themselves in the
// count pass (the high 16 bits of a counter), since a round's list holds
// only some of them, and counts |M| there.
#include <limits.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma_tf32.cuh"   // cp_async16, cp_async_commit, cp_async_wait

namespace {

constexpr int kRowsFirst = 4;          // query rows a block, first match (two blocks an SM)
constexpr int kRowsAll = 8;            // query rows a block, all shots (one block an SM)
constexpr int kWarps = 16;             // warps a block (at least the rows)
constexpr int kCap = 64;               // same-id entries a row stages a round (a power of two)
constexpr int kVec = 4;                // columns a lane copies at once: 4 (16 bytes) or 1
constexpr bool kLinearSearch = false;  // bucket by counting compares, not by binary search
constexpr int kThreads = kWarps * reid::kWarp;
constexpr int kStep = 4 * reid::kWarp;   // columns a warp covers in a step
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kMatch = 0x10000u;    // a match's count in a counter, above a non-match's
constexpr int kMaxN = 1 << 21;           // keeps a lane's 16-bit counts from overflowing
static_assert(kWarps >= kRowsAll, "a row's list is sorted and summed by its own warp");

struct Args {
  const float* d;
  const int* qid;
  const int* qcam;
  const int* gid;
  const int* gcam;
  float* ap;
  int* first;
  int* nm;
  float* hist;
  int q, n, sep, topk;
  int period;   // rows whose first 16-byte aligned column is the same are `period` apart
  int a0;       // the block's first float, counted in floats past a 16-byte boundary
};

// What the count pass reads of a row each step: 32 bytes, two 16-byte loads.
struct alignas(16) RowView {
  float s0, slast;   // the nearest and farthest staged match
  int j0, jlast;     //   and their gallery indices
  int pow2;          // staged matches, rounded up to a power of two
  int qi, qc;        // the query's id and camera
  int on;            // the row is counted this round
};

// A row's staging in shared memory.
struct RowSmem {
  double term[kCap];   // AP terms, in sorted order
  int cj[kCap];        // the round's same-id entries (gallery index)
  float ud[kCap];      // the round's matches, unsorted: distance
  int uj[kCap];        //   and gallery index
  float sd[kCap];      // sorted by (distance, index); padded with (+inf, INT_MAX)
  int sj[kCap];
  int bin[kCap];       // all-shots bins, in sorted order
  RowView v;
  int nc;              // same-id entries of the row
  int staged;          // matches staged this round
};

// A block's geometry: its rows; a row's buckets, a column a lane; its first
// bins and |M|, a column a lane; a warp's step of the rows' distances in
// flight; a warp's gathered entries of a row's step.
__host__ __device__ constexpr int block_rows(bool all_shots) {
  return all_shots ? kRowsAll : kRowsFirst;
}
__host__ __device__ constexpr int counters(bool all_shots) {
  return block_rows(all_shots) * kCap * reid::kWarp;
}
__host__ __device__ constexpr int misc_size(bool all_shots) {
  return block_rows(all_shots) * 2 * reid::kWarp;
}
constexpr int kScratch = 4 * reid::kWarp;

__host__ __device__ constexpr size_t smem_bytes(bool all_shots) {
  return sizeof(RowSmem) * block_rows(all_shots) +
         sizeof(float) * kWarps * block_rows(all_shots) * kStep +
         sizeof(float) * 2 * kWarps * kScratch +
         sizeof(unsigned) * (counters(all_shots) * (all_shots ? 2 : 1) + misc_size(all_shots));
}

__device__ __forceinline__ bool lex_less(float da, int ja, float db, int jb) {
  return da < db || (da == db && ja < jb);
}

// 4 bytes from global to shared memory, asynchronously; zero when !valid.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0));
}

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T v, int lane) {
#pragma unroll
  for (int o = 1; o < reid::kWarp; o <<= 1) {
    const T y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// counter[0] += v where pred, in shared memory; no one waits for the result.
// Nothing reads the counters before the barrier that ends the pass.
__device__ __forceinline__ void red_add_if(unsigned* counter, unsigned v, bool pred) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(counter));
  asm volatile("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n @q red.shared.add.u32 [%0], %1;\n}\n"
               ::"r"(a), "r"(v), "r"(static_cast<int>(pred)));
}

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// Counts E entries of a lane against one row's staged matches: distance x,
// gallery index j, id g, camera c, where ok. Only the valid entries at or
// below the farthest match count (about a tenth of a Market row): the warp
// gathers them into its scratch (qx, qj; 32 * E slots) and buckets them a
// lane each, by binary search into the sorted match distances (and, for
// the all-shots rows, by (distance, index) into the sorted matches). cnt,
// lcnt and misc point at the lane's column of the row's counters. kSep: the
// separate camera set; kMulti: the block's rows take rounds, so matches are
// counted here too. Every lane of the warp calls it.
template <bool kAllShots, bool kSep, bool kMulti, int E>
__device__ __forceinline__ void count_row(const RowSmem& rs, unsigned* cnt, unsigned* lcnt,
                                          unsigned* misc, float* qx, int* qj,
                                          const float (&x)[E], const int (&j)[E],
                                          const int (&g)[E], const int (&c)[E],
                                          const bool (&ok)[E], int lane) {
  const RowView v = rs.v;
  int total = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const bool same = g[e] == v.qi;
    // valid, and a non-match or (with rounds) a match
    const bool keep = ok[e] && (same ? kMulti && c[e] != v.qc : !(kSep && c[e] == v.qc));
    if constexpr (kMulti) red_add_if(misc + reid::kWarp, 1u, keep && same);
    const bool in = keep && x[e] <= v.slast;
    const unsigned b = __ballot_sync(kFull, in);
    if (in) {
      const int slot = total + __popc(b & ((1u << lane) - 1u));
      qx[slot] = x[e];
      qj[slot] = same ? j[e] | INT_MIN : j[e];   // a match: the high bit set
    }
    total += __popc(b);
  }
  __syncwarp();
  for (int r0 = 0; r0 < total; r0 += reid::kWarp) {
    const bool on = r0 + lane < total;
    const float xe = on ? qx[r0 + lane] : 0.0f;
    const int t = on ? qj[r0 + lane] : 0;
    const int je = t & INT_MAX;
    const bool match = t < 0;
    const bool low = xe <= v.s0;   // bucket 0, without a search
    int b = 0;
    if (on && !low) {
      if constexpr (kLinearSearch) {
        for (int k = 0; k < v.pow2; ++k) b += rs.sd[k] < xe;
      } else {
        for (int h = v.pow2 >> 1; h > 0; h >>= 1) b += rs.sd[b + h - 1] < xe ? h : 0;
      }
    }
    red_add_if(cnt + reid::kWarp * b, match ? kMatch : 1u, on);
    if constexpr (kAllShots) {
      const bool lneed = on && !match && lex_less(xe, je, v.slast, v.jlast);
      int lb = 0;
      if (lneed) {
        if constexpr (kLinearSearch) {
          for (int k = 0; k < v.pow2; ++k) lb += lex_less(rs.sd[k], rs.sj[k], xe, je);
        } else {
          for (int h = v.pow2 >> 1; h > 0; h >>= 1)
            lb += lex_less(rs.sd[lb + h - 1], rs.sj[lb + h - 1], xe, je) ? h : 0;
        }
      }
      red_add_if(lcnt + reid::kWarp * lb, 1u, lneed);
    } else {   // (x, j) before (s_0, j_0): the first bin
      red_add_if(misc, 1u, on && low && !match && (xe < v.s0 || je < v.j0));
    }
  }
  __syncwarp();   // the scratch is written again by the next call
}

// kAllShots: also write the query's all-shots row hist[row, 0 .. topk).
template <bool kAllShots>
__global__ void __launch_bounds__(kThreads, kAllShots ? 1 : 2) rank_stats_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  RowSmem* rows = reinterpret_cast<RowSmem*>(smem);
  constexpr int kRows = block_rows(kAllShots);
  float* stage = reinterpret_cast<float*>(rows + kRows);   // [kWarps][kRows][kStep]
  float* scratch_x = stage + kWarps * kRows * kStep;       // [kWarps][kScratch]
  int* scratch_j = reinterpret_cast<int*>(scratch_x + kWarps * kScratch);
  unsigned* counts = reinterpret_cast<unsigned*>(scratch_j + kWarps * kScratch);   // [kRows][kCap][32]
  unsigned* misc = counts + counters(kAllShots);                                  // [kRows][2][32]
  unsigned* lex_counts = misc + misc_size(kAllShots);                             // [kRows][kCap][32]

  const int tid = threadIdx.x, lane = tid % reid::kWarp, warp = tid / reid::kWarp;
  const int row0 = blockIdx.x % a.period + a.period * (blockIdx.x / a.period) * kRows;
  if (row0 >= a.q) return;
  const int n = a.n;
  // columns before the rows' first 16-byte aligned one, then whole groups of 4
  const int head = kVec == 4
      ? min((4 - static_cast<int>((a.a0 + static_cast<long long>(row0) * n) & 3)) & 3, n) : 0;
  const int body = (n - head) & ~3;
  const int tail = head + body;   // the last n - tail < 4 columns
  const int steps = (body + kStep - 1) / kStep;
  // the ids and cameras of a lane's 4 columns in one 16-byte load where aligned
  const bool vec_ids = kVec == 4 && ((reinterpret_cast<uintptr_t>(a.gid) / 4 + head) & 3) == 0 &&
                       ((reinterpret_cast<uintptr_t>(a.gcam) / 4 + head) & 3) == 0;
  auto row_of = [&](int k) { return row0 + a.period * k; };
  // a lane's column e (0..3) of step s
  auto column = [&](int s, int e) {
    return kVec == 4 ? head + s * kStep + 4 * lane + e : s * kStep + e * reid::kWarp + lane;
  };
  auto load4 = [&](const int* p, int s, int (&v)[4]) {   // 0 past the body
    if (vec_ids) {
      const int4 t = column(s, 0) < tail
          ? __ldg(reinterpret_cast<const int4*>(p + column(s, 0))) : make_int4(0, 0, 0, 0);
      v[0] = t.x;
      v[1] = t.y;
      v[2] = t.z;
      v[3] = t.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = column(s, e) < tail ? __ldg(p + column(s, e)) : 0;
    }
  };

  if (tid < kRows) {
    RowSmem& rs = rows[tid];
    const int row = row_of(tid);
    rs.nc = 0;
    rs.v.on = 0;
    rs.v.qi = row < a.q ? a.qid[row] : 0;
    rs.v.qc = row < a.q ? a.qcam[row] : 0;
  }
  if constexpr (kAllShots)
    for (int i = tid; i < kRows * a.topk; i += kThreads)
      if (row_of(i / a.topk) < a.q) a.hist[static_cast<size_t>(row_of(i / a.topk)) * a.topk +
                                           i % a.topk] = 0.0f;
  __syncthreads();

  // ---- 1. every row's same-id entries: a warp tests a step's ids against
  // all the block's rows
  {
    int rq[kRows];
    unsigned live_rows = 0;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      rq[k] = rows[k].v.qi;
      live_rows |= static_cast<unsigned>(row_of(k) < a.q) << k;
    }
    auto append = [&](unsigned m, int col) {   // m: the rows whose id is at col
      while (m) {
        const int k = __ffs(m) - 1;
        m &= m - 1;
        const int slot = atomicAdd(&rows[k].nc, 1);
        if (slot < kCap) rows[k].cj[slot] = col;
      }
    };
    auto rows_of = [&](int g) {
      unsigned m = 0;
#pragma unroll
      for (int k = 0; k < kRows; ++k) m |= static_cast<unsigned>(g == rq[k]) << k;
      return m & live_rows;
    };
    if (warp == 0) {   // < 4 columns at each end, one a lane
      if (lane < head) append(rows_of(a.gid[lane]), lane);
      if (tail + lane < n) append(rows_of(a.gid[tail + lane]), tail + lane);
    }
    constexpr int kAhead = 8;   // steps of ids in flight a warp
    for (int s0 = warp; s0 < steps; s0 += kAhead * kWarps) {
      int g[kAhead][4];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int s = s0 + u * kWarps;
        if (s < steps) load4(a.gid, s, g[u]);
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = s0 + u * kWarps;
          const int col = s < steps ? column(s, e) : tail;
          const unsigned m = rows_of(g[u][e]);
          if (m && col < tail) append(m, col);
        }
    }
  }
  __syncthreads();
  int max_nc = 0;
  for (int k = 0; k < kRows; ++k) max_nc = max(max_nc, rows[k].nc);
  const bool multi = max_nc > kCap;        // some row takes more than one round
  const int rounds = (max_nc + kCap - 1) / kCap;

  // the warp of row `warp` (warps past kRows have none)
  const bool row_warp = warp < kRows && row_of(warp) < a.q;
  RowSmem& rs = rows[warp < kRows ? warp : 0];
  const int row = row_of(warp);
  const float* drow = a.d + static_cast<size_t>(row_warp ? row : row0) * n;
  const int qi = rs.v.qi, qc = rs.v.qc;

  // With rounds: the row's same-id entries with ordinals in [lo, lo + kCap),
  // in index order, by the row's warp.
  auto scan_ordered = [&](int lo) {
    int ord = 0;
    auto take = [&](unsigned mask, int s) {   // this lane's columns of step s
      const int cnt = __popc(mask);
      const int incl = warp_inclusive_scan(cnt, lane);
      int slot = ord + incl - cnt;
      ord += __shfl_sync(kFull, incl, reid::kWarp - 1);
      while (mask) {
        const int e = __ffs(mask) - 1;
        mask &= mask - 1;
        if (slot >= lo && slot < lo + kCap) rs.cj[slot - lo] = s < 0 ? lane : s >= steps
            ? tail + lane : column(s, e);
        ++slot;
      }
    };
    take(lane < head && a.gid[lane] == qi ? 1u : 0u, -1);
    constexpr int kAhead = 4;   // steps of ids loaded at once
    for (int s0 = 0; s0 < steps; s0 += kAhead) {
      int g[kAhead][4];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) load4(a.gid, s0 + u, g[u]);
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int s = s0 + u;
        unsigned mask = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) mask |= (g[u][e] == qi && column(s, e) < tail) << e;
        if constexpr (kVec == 1) {   // columns lane, lane + 32, ...: in index order one at a time
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (__any_sync(kFull, mask >> e & 1u)) take(mask & (1u << e), s);
        } else {
          if (__any_sync(kFull, mask != 0)) take(mask, s);
        }
      }
    }
    take(tail + lane < n && a.gid[tail + lane] == qi ? 1u : 0u, steps);
    __syncwarp();
  };

  double ap_acc = 0.0;   // in lane 0 of a row's warp
  int nm = 0, first = 0;
  float best_d = 0.0f;
  int best_j = -1;
  for (int round = 0; round < rounds; ++round) {
    const int lo = round * kCap;
    if (multi && row_warp && rs.nc > lo) scan_ordered(lo);
    // ---- the round's matches: cameras and distances at once, then sorted
    if (row_warp) {
      const int ncand = max(0, min(kCap, rs.nc - lo));
      int kept = 0;
      for (int i0 = 0; i0 < ncand; i0 += reid::kWarp) {
        const int i = i0 + lane;
        bool m = false;
        float x = 0.0f;
        int j = 0;
        if (i < ncand) {
          j = rs.cj[i];
          x = drow[j];
          m = a.gcam[j] != qc;
        }
        const unsigned b = __ballot_sync(kFull, m);
        if (m) {
          const int s = kept + __popc(b & ((1u << lane) - 1u));
          rs.ud[s] = x;
          rs.uj[s] = j;
        }
        kept += __popc(b);
      }
      __syncwarp();
      for (int i = lane; i < kept; i += reid::kWarp) {
        const float x = rs.ud[i];
        const int j = rs.uj[i];
        int rank = 0;
        for (int k = 0; k < kept; ++k) rank += lex_less(rs.ud[k], rs.uj[k], x, j);
        rs.sd[rank] = x;
        rs.sj[rank] = j;
      }
      for (int i = kept + lane; i < kCap; i += reid::kWarp) {
        rs.sd[i] = __int_as_float(0x7f800000);
        rs.sj[i] = INT_MAX;
      }
      __syncwarp();
      if (lane == 0) {
        int p = 1;
        while (p < kept) p <<= 1;
        rs.staged = kept;
        rs.v.s0 = rs.sd[0];
        rs.v.j0 = rs.sj[0];
        rs.v.slast = kept > 0 ? rs.sd[kept - 1] : -__int_as_float(0x7f800000);
        rs.v.jlast = kept > 0 ? rs.sj[kept - 1] : INT_MAX;
        rs.v.pow2 = p;
        rs.v.on = kept > 0 || (multi && round == 0);   // round 0 counts |M| with rounds
      }
    }
    for (int i = tid; i < counters(kAllShots); i += kThreads) {
      counts[i] = 0u;
      if constexpr (kAllShots) lex_counts[i] = 0u;
    }
    for (int i = tid; i < misc_size(kAllShots); i += kThreads) misc[i] = 0u;
    __syncthreads();

    // ---- 2. one pass over the rows: a warp takes a step of all the rows,
    // the next step's distances in flight
    bool on[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) on[k] = rows[k].v.on != 0;
    auto pass = [&](auto sep_flag, auto multi_flag) {
      constexpr bool kSep = decltype(sep_flag)::value, kMulti = decltype(multi_flag)::value;
      constexpr bool kCams = kSep || kMulti;
      auto count = [&](int k, const auto& x, const auto& j, const auto& g, const auto& c,
                       const auto& ok) {
        count_row<kAllShots, kSep, kMulti>(rows[k], counts + k * kCap * reid::kWarp + lane,
                                           lex_counts + k * kCap * reid::kWarp + lane,
                                           misc + k * 2 * reid::kWarp + lane,
                                           scratch_x + warp * kScratch,
                                           scratch_j + warp * kScratch, x, j, g, c, ok, lane);
      };
      if (warp == 0) {   // < 4 columns at each end, one a lane
        const int j0 = lane, j1 = tail + lane;
        const bool ok[2] = {j0 < head, j1 < n};
        const int j[2] = {j0, j1};
        const int g[2] = {ok[0] ? a.gid[j0] : 0, ok[1] ? a.gid[j1] : 0};
        const int c[2] = {ok[0] ? a.gcam[j0] : 0, ok[1] ? a.gcam[j1] : 0};
        for (int k = 0; k < kRows; ++k) {
          if (!on[k]) continue;
          const float* p = a.d + static_cast<size_t>(row_of(k)) * n;
          const float x[2] = {ok[0] ? p[j0] : 0.0f, ok[1] ? p[j1] : 0.0f};
          count(k, x, j, g, c, ok);
        }
      }
      // The warp's next step of the rows' distances in flight, copied into
      // its slot, and the next step's ids (and cameras) in registers, while
      // it counts a step. A lane reads back only what it copied, before it
      // copies the next step over it.
      float* buf = stage + warp * kRows * kStep;
      auto issue = [&](int s) {
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          if (!on[k]) continue;
          const float* p = a.d + static_cast<size_t>(row_of(k)) * n;
          if constexpr (kVec == 4) {
            const bool ok = column(s, 0) < tail;
            reid::cp_async16(buf + k * kStep + 4 * lane, ok ? p + column(s, 0) : a.d, ok);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const bool ok = column(s, e) < tail;
              cp_async4(buf + k * kStep + e * reid::kWarp + lane, ok ? p + column(s, e) : a.d,
                        ok);
            }
          }
        }
        reid::cp_async_commit();
      };
      if (warp < steps) issue(warp);
      int gn[4], cn[4] = {0, 0, 0, 0};
      load4(a.gid, warp, gn);
      if constexpr (kCams) load4(a.gcam, warp, cn);
      for (int s = warp; s < steps; s += kWarps) {
        int j[4], g[4], c[4];
        bool ok[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          g[e] = gn[e];
          c[e] = cn[e];
          j[e] = column(s, e);
          ok[e] = j[e] < tail;
        }
        load4(a.gid, s + kWarps, gn);   // zeros past the end
        if constexpr (kCams) load4(a.gcam, s + kWarps, cn);
        reid::cp_async_wait<0>();
        float x[kRows][4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int k = 0; k < kRows; ++k)
            x[k][e] = buf[k * kStep + (kVec == 4 ? 4 * lane + e : e * reid::kWarp + lane)];
        if (s + kWarps < steps) issue(s + kWarps);
#pragma unroll
        for (int k = 0; k < kRows; ++k)
          if (on[k]) count(k, x[k], j, g, c, ok);
      }
    };
    if (multi) {
      if (a.sep) pass(Flag<true>(), Flag<true>());
      else pass(Flag<false>(), Flag<true>());
    } else {
      if (a.sep) pass(Flag<true>(), Flag<false>());
      else pass(Flag<false>(), Flag<false>());
    }
    __syncthreads();

    // ---- 3. prefix sums over the buckets, the AP terms and the bins
    if (row_warp && rs.v.on) {
      const int staged = rs.staged;
      const unsigned* cnt = counts + warp * kCap * reid::kWarp;
      const unsigned* lcnt = lex_counts + warp * kCap * reid::kWarp;
      const unsigned* mc = misc + warp * 2 * reid::kWarp;
      const unsigned f_first = reid::warp_sum(mc[lane]);
      const unsigned m_all = reid::warp_sum(mc[reid::kWarp + lane]);
      if (round == 0) nm = multi ? static_cast<int>(m_all) : staged;
      unsigned car_n = 0, car_m = 0, car_l = 0;
      for (int k0 = 0; k0 < staged; k0 += reid::kWarp) {
        const int k = k0 + lane;
        unsigned nk = 0, mk = 0, lk = 0;
        if (k < staged) {
          for (int i = 0; i < reid::kWarp; ++i) {
            const int col = (i + lane) & (reid::kWarp - 1);   // no bank conflicts
            const unsigned v = cnt[reid::kWarp * k + col];
            nk += v & 0xffffu;
            mk += v >> 16;
            if constexpr (kAllShots) lk += lcnt[reid::kWarp * k + col];
          }
        }
        nk = warp_inclusive_scan(nk, lane) + car_n;
        mk = warp_inclusive_scan(mk, lane) + car_m;
        lk = warp_inclusive_scan(lk, lane) + car_l;
        car_n = __shfl_sync(kFull, nk, reid::kWarp - 1);
        car_m = __shfl_sync(kFull, mk, reid::kWarp - 1);
        car_l = __shfl_sync(kFull, lk, reid::kWarp - 1);
        if (k < staged) {
          unsigned m = mk;
          if (!multi) {   // every match is on the list: those at or below s_k
            m = 0;
            for (int i = 0; i < staged; ++i) m += rs.sd[i] <= rs.sd[k];
          }
          rs.term[k] = static_cast<double>(m) / static_cast<double>(nk + m);
          rs.bin[k] = static_cast<int>(lk);
        }
      }
      __syncwarp();
      if (lane == 0 && staged > 0) {
        for (int k = 0; k < staged; ++k) ap_acc += rs.term[k];
        if constexpr (kAllShots) {
          float* hrow = a.hist + static_cast<size_t>(row) * a.topk;
          const float w = 1.0f / static_cast<float>(nm);
          for (int k = 0; k < staged; ++k)
            if (rs.bin[k] < a.topk) hrow[rs.bin[k]] += w;
        }
        if (best_j < 0 || lex_less(rs.sd[0], rs.sj[0], best_d, best_j)) {
          first = kAllShots ? rs.bin[0] : static_cast<int>(f_first);
          best_d = rs.sd[0];
          best_j = rs.sj[0];
        }
      }
    }
    __syncthreads();   // the lists and counters are rewritten next round
  }
  if (row_warp && lane == 0) {
    a.ap[row] = nm > 0 ? static_cast<float>(ap_acc / nm) : 0.0f;
    a.first[row] = nm > 0 ? first : 0;
    a.nm[row] = nm;
  }
}

}  // namespace

// d: (q, n) fp32 contiguous. qid/qcam: q int32. gid/gcam: n int32.
// sep: 1 drops the query's camera from the valid set.
// Outputs, q each: ap (fp32), first_bin (int32), num_matches (int32); with
// topk > 0 also hist, (q, topk) fp32, each query's all-shots row.
// n must be below 2^21.
extern "C" int reid_rank_stats(const void* d, const void* qid, const void* qcam,
                               const void* gid, const void* gcam, int q, int n, int sep,
                               void* ap, void* first_bin, void* num_matches, void* hist,
                               int topk, void* stream) {
  if (q < 0 || n < 0 || n >= kMaxN || topk < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (q == 0) return 0;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(d);
  const int period = kVec == 1 || n % 4 == 0 ? 1 : n % 2 == 0 ? 2 : 4;
  const Args args{static_cast<const float*>(d), static_cast<const int*>(qid),
                  static_cast<const int*>(qcam), static_cast<const int*>(gid),
                  static_cast<const int*>(gcam), static_cast<float*>(ap),
                  static_cast<int*>(first_bin), static_cast<int*>(num_matches),
                  static_cast<float*>(hist), q, n, sep, topk, period,
                  static_cast<int>((addr / 4) % 4)};
  const bool all_shots = topk > 0;
  const int per_class = (q + period - 1) / period;
  const int rows = block_rows(all_shots);
  const int blocks = period * ((per_class + rows - 1) / rows);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = smem_bytes(all_shots);
  const int rc = static_cast<int>(all_shots
      ? cudaFuncSetAttribute(rank_stats_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes))
      : cudaFuncSetAttribute(rank_stats_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes)));
  if (rc != 0) return rc;
  if (all_shots) rank_stats_kernel<true><<<blocks, kThreads, bytes, st>>>(args);
  else rank_stats_kernel<false><<<blocks, kThreads, bytes, st>>>(args);
  return reid::launch_status();
}
