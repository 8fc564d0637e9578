// reidnative — host-side native kernels of the re-ID framework (the port's
// own copy of reid_gan_tpu/native/src/reidnative.cc; built and bound by
// reid_gan_torch/native/__init__.py).
//
// Replaces the reference's third-party native dependencies (SURVEY.md §2.4):
//   - infomap (C++): two-level directed map-equation community detection
//     used for pseudo-labels (CC/clustercontrast/utils/infomap_cluster.py)
//   - sklearn DBSCAN (Cython): density clustering over a precomputed
//     distance matrix (CC/examples/cluster_contrast_train_usl.py:160-163)
//   - the O(N·nnz) sparse min-sum inner loop of the k-reciprocal Jaccard
//     distance (CC/clustercontrast/utils/faiss_rerank.py:98-115)
//
// Exposed via a C ABI for ctypes (no pybind11 in this image). Threading uses
// std::thread sized to hardware_concurrency.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <random>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// DBSCAN over a precomputed distance matrix. labels: -1 = noise.
// ---------------------------------------------------------------------------
void reid_dbscan(const float* dist, int32_t n, float eps, int32_t min_samples,
                 int32_t* labels) {
  std::vector<uint8_t> core(n, 0);
  {
    unsigned nthreads = std::max(1u, std::thread::hardware_concurrency());
    std::vector<std::thread> ts;
    std::atomic<int32_t> next(0);
    auto work = [&]() {
      for (;;) {
        int32_t i = next.fetch_add(1);
        if (i >= n) return;
        const float* row = dist + (int64_t)i * n;
        int32_t c = 0;
        for (int32_t j = 0; j < n; ++j) c += (row[j] <= eps);
        core[i] = (c >= min_samples);
      }
    };
    for (unsigned t = 0; t < nthreads; ++t) ts.emplace_back(work);
    for (auto& t : ts) t.join();
  }

  std::fill(labels, labels + n, -1);
  int32_t cluster = 0;
  std::vector<int32_t> frontier, next_frontier;
  for (int32_t i = 0; i < n; ++i) {
    if (labels[i] != -1 || !core[i]) continue;
    labels[i] = cluster;
    frontier.assign(1, i);
    while (!frontier.empty()) {
      next_frontier.clear();
      for (int32_t p : frontier) {
        if (!core[p]) continue;
        const float* row = dist + (int64_t)p * n;
        for (int32_t j = 0; j < n; ++j) {
          if (row[j] <= eps && labels[j] == -1) {
            labels[j] = cluster;
            next_frontier.push_back(j);
          }
        }
      }
      frontier.swap(next_frontier);
    }
    ++cluster;
  }
}

// ---------------------------------------------------------------------------
// Sparse min-sum Jaccard rows.
// V in CSR (indptr/indices/data) and its transpose Vt (t_*). Output: dense
// (m x n), m = number of query rows. jac[i,k] = 1 - s/(2-s) with
// s = sum_j min(V[i,j], V[k,j]) over the nonzero columns j of row i.
// ---------------------------------------------------------------------------
void reid_jaccard_minsum(const int64_t* indptr, const int32_t* indices,
                         const float* data, const int64_t* t_indptr,
                         const int32_t* t_indices, const float* t_data,
                         int32_t n, int32_t m, float* out) {
  unsigned nthreads = std::max(1u, std::thread::hardware_concurrency());
  std::atomic<int32_t> next(0);
  auto work = [&]() {
    std::vector<float> temp_min(n);
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= m) return;
      std::fill(temp_min.begin(), temp_min.end(), 0.f);
      for (int64_t jj = indptr[i]; jj < indptr[i + 1]; ++jj) {
        int32_t j = indices[jj];
        float vij = data[jj];
        for (int64_t kk = t_indptr[j]; kk < t_indptr[j + 1]; ++kk) {
          int32_t k = t_indices[kk];
          float vkj = t_data[kk];
          temp_min[k] += vij < vkj ? vij : vkj;
        }
      }
      float* row = out + (int64_t)i * n;
      for (int32_t k = 0; k < n; ++k) {
        float s = temp_min[k];
        float j = 1.f - s / (2.f - s);
        row[k] = j > 0.f ? j : 0.f;
      }
    }
  };
  std::vector<std::thread> ts;
  for (unsigned t = 0; t < nthreads; ++t) ts.emplace_back(work);
  for (auto& t : ts) t.join();
}

// ---------------------------------------------------------------------------
// k-reciprocal expansion → sparse V rows (faiss_rerank.py:43-88).
//
// For each node i: its k-reciprocal neighbor set (within top-k+1 incl. self,
// mutual-rank test), expanded with the half-k reciprocal sets of candidates
// whose overlap is > 2/3 of the candidate set, then softmax weights over the
// cosine distances 2−2·⟨f_i, f_j⟩. Output is padded row storage
// (out_idx/out_w: (n, cap) row-major, out_cnt: per-row nnz) — V never exists
// densely, which is what keeps the MSMT17-scale (N≈33k) pseudo-label phase
// in budget (a dense fp32 V is 4.3 GB and the per-row Python loops dominate).
// Returns the max row size needed; if > cap the caller must retry with a
// larger cap (rows beyond cap are truncated, not written out of bounds).
// ---------------------------------------------------------------------------
namespace {

// k-reciprocal set of node i: j in rank[i][:kk] with i in rank[j][:kk].
inline int32_t krecip_set(const int32_t* rank, int32_t rank_w, int32_t i,
                          int32_t kk, int32_t* out) {
  const int32_t* fwd = rank + (int64_t)i * rank_w;
  int32_t cnt = 0;
  for (int32_t a = 0; a < kk; ++a) {
    int32_t j = fwd[a];
    const int32_t* back = rank + (int64_t)j * rank_w;
    for (int32_t b = 0; b < kk; ++b) {
      if (back[b] == i) {
        out[cnt++] = j;
        break;
      }
    }
  }
  return cnt;
}

}  // namespace

}  // extern "C" — templates may not have C linkage

namespace {

// Shared body of the k-reciprocal V builders; WeightFn(i, j) -> unnormalized
// weight of column j in row i (softmax numerator).
template <class WeightFn>
int32_t kreciprocal_v_impl(const int32_t* rank, int32_t n, int32_t rank_w,
                           int32_t k1, int32_t cap, int32_t* out_idx,
                           float* out_w, int32_t* out_cnt, WeightFn weight) {
  const int32_t kk1 = std::min(k1 + 1, rank_w);
  // np.around (banker's) rounding for odd k1: nearbyint in the default
  // to-nearest-even FP mode matches numpy, lround would not (14.5 → 15)
  const int32_t half = (int32_t)std::nearbyint(k1 / 2.0);
  const int32_t kkh = std::min(half + 1, rank_w);

  // Pass 1: all k-reciprocal sets (full and half), padded storage.
  std::vector<int32_t> nn_k1((int64_t)n * kk1), nn_cnt(n);
  std::vector<int32_t> nn_h((int64_t)n * kkh), nn_hcnt(n);
  unsigned nthreads = std::max(1u, std::thread::hardware_concurrency());
  {
    std::atomic<int32_t> next(0);
    auto work = [&]() {
      for (;;) {
        int32_t i = next.fetch_add(1);
        if (i >= n) return;
        nn_cnt[i] = krecip_set(rank, rank_w, i, kk1, &nn_k1[(int64_t)i * kk1]);
        nn_hcnt[i] = krecip_set(rank, rank_w, i, kkh, &nn_h[(int64_t)i * kkh]);
      }
    };
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < nthreads; ++t) ts.emplace_back(work);
    for (auto& t : ts) t.join();
  }

  // Pass 2: expansion + softmax weights.
  std::atomic<int32_t> next(0), max_need(0);
  auto work = [&]() {
    std::vector<int32_t> base, expanded;
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n) return;
      const int32_t* ki = &nn_k1[(int64_t)i * kk1];
      int32_t kc = nn_cnt[i];
      base.assign(ki, ki + kc);
      std::sort(base.begin(), base.end());
      expanded.assign(ki, ki + kc);
      for (int32_t a = 0; a < kc; ++a) {
        const int32_t* cs = &nn_h[(int64_t)ki[a] * kkh];
        int32_t cc = nn_hcnt[ki[a]];
        int32_t inter = 0;
        for (int32_t b = 0; b < cc; ++b)
          inter += std::binary_search(base.begin(), base.end(), cs[b]);
        if (3 * inter > 2 * cc)  // > 2/3 overlap (faiss_rerank.py:76-79)
          expanded.insert(expanded.end(), cs, cs + cc);
      }
      std::sort(expanded.begin(), expanded.end());
      expanded.erase(std::unique(expanded.begin(), expanded.end()),
                     expanded.end());
      int32_t m = (int32_t)expanded.size();
      int32_t prev = max_need.load();
      while (m > prev && !max_need.compare_exchange_weak(prev, m)) {
      }
      int32_t mw = std::min(m, cap);
      out_cnt[i] = mw;
      int32_t* oi = out_idx + (int64_t)i * cap;
      float* ow = out_w + (int64_t)i * cap;
      float esum = 0.f;
      for (int32_t a = 0; a < mw; ++a) {
        float e = weight(i, expanded[a]);
        oi[a] = expanded[a];
        ow[a] = e;
        esum += e;
      }
      float inv = esum > 0.f ? 1.f / esum : 0.f;
      for (int32_t a = 0; a < mw; ++a) ow[a] *= inv;
    }
  };
  std::vector<std::thread> ts;
  for (unsigned t = 0; t < nthreads; ++t) ts.emplace_back(work);
  for (auto& t : ts) t.join();
  return max_need.load();
}

}  // namespace

extern "C" {

int32_t reid_kreciprocal_v(const int32_t* rank, int32_t n, int32_t rank_w,
                           const float* feats, int32_t d, int32_t k1,
                           int32_t cap, int32_t* out_idx, float* out_w,
                           int32_t* out_cnt) {
  // softmax over cosine distances 2-2*<f_i, f_j> (faiss_rerank.py:81-85)
  auto weight = [feats, d](int32_t i, int32_t j) {
    const float* fi = feats + (int64_t)i * d;
    const float* fj = feats + (int64_t)j * d;
    float dot = 0.f;
    for (int32_t c = 0; c < d; ++c) dot += fi[c] * fj[c];
    return std::exp(-(2.f - 2.f * dot));
  };
  return kreciprocal_v_impl(rank, n, rank_w, k1, cap, out_idx, out_w,
                            out_cnt, weight);
}

// Same expansion, but weights from a dense row-major (n, n) distance matrix:
// w = exp(-dist[i, j]) (the eval-time re-ranking flavor, rerank.py:66-71).
int32_t reid_kreciprocal_v_dist(const int32_t* rank, int32_t n,
                                int32_t rank_w, const float* dist, int32_t k1,
                                int32_t cap, int32_t* out_idx, float* out_w,
                                int32_t* out_cnt) {
  auto weight = [dist, n](int32_t i, int32_t j) {
    return std::exp(-dist[(int64_t)i * n + j]);
  };
  return kreciprocal_v_impl(rank, n, rank_w, k1, cap, out_idx, out_w,
                            out_cnt, weight);
}

// ---------------------------------------------------------------------------
// k2 query expansion over padded sparse rows: row i ← mean of the rows of its
// top-k2 ranked neighbors (faiss_rerank.py:89-93). Same padded-row format and
// overflow contract as reid_kreciprocal_v.
// ---------------------------------------------------------------------------
int32_t reid_query_expand(const int32_t* in_idx, const float* in_w,
                          const int32_t* in_cnt, int32_t cap_in,
                          const int32_t* rank, int32_t rank_w, int32_t n,
                          int32_t k2, int32_t cap_out, int32_t* out_idx,
                          float* out_w, int32_t* out_cnt) {
  const int32_t kq = std::min(k2, rank_w);
  unsigned nthreads = std::max(1u, std::thread::hardware_concurrency());
  std::atomic<int32_t> next(0), max_need(0);
  auto work = [&]() {
    std::vector<std::pair<int32_t, float>> acc;
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n) return;
      acc.clear();
      for (int32_t t = 0; t < kq; ++t) {
        int32_t r = rank[(int64_t)i * rank_w + t];
        const int32_t* ri = in_idx + (int64_t)r * cap_in;
        const float* rw = in_w + (int64_t)r * cap_in;
        for (int32_t a = 0; a < in_cnt[r]; ++a) acc.emplace_back(ri[a], rw[a]);
      }
      std::sort(acc.begin(), acc.end());
      const float inv = 1.f / kq;
      int32_t m = 0;
      int32_t* oi = out_idx + (int64_t)i * cap_out;
      float* ow = out_w + (int64_t)i * cap_out;
      size_t a = 0;
      while (a < acc.size()) {
        int32_t col = acc[a].first;
        float s = 0.f;
        while (a < acc.size() && acc[a].first == col) s += acc[a++].second;
        if (m < cap_out) {
          oi[m] = col;
          ow[m] = s * inv;
        }
        ++m;
      }
      int32_t prev = max_need.load();
      while (m > prev && !max_need.compare_exchange_weak(prev, m)) {
      }
      out_cnt[i] = std::min(m, cap_out);
    }
  };
  std::vector<std::thread> ts;
  for (unsigned t = 0; t < nthreads; ++t) ts.emplace_back(work);
  for (auto& t : ts) t.join();
  return max_need.load();
}

// ---------------------------------------------------------------------------
// Two-level directed map-equation community detection ("Infomap").
//
// Flow model: PageRank with teleportation tau over out-weight-normalized
// links (dangling mass redistributed uniformly). Two-level map equation:
//
//   L(M) = plogp(Q) - 2*sum_m plogp(q_m) + sum_m plogp(q_m + p_m)
//          - sum_a plogp(p_a),      Q = sum_m q_m,
//   q_m  = tau * (n - n_m)/n * p_m
//          + (1-tau) * sum_{a in m, a->b, b notin m} p_a * w_ab.
//
// Optimization: Louvain-style sweeps of single-node moves with EXACT ΔL
// (including the global plogp(Q) term), node order shuffled per sweep,
// repeated until no move improves. Matches the reference's
// `--two-level --directed` usage (infomap_cluster.py:160-165).
// ---------------------------------------------------------------------------
namespace {

inline double plogp(double x) { return x > 1e-18 ? x * std::log(x) : 0.0; }

struct Graph {
  int32_t n;
  std::vector<int64_t> out_ptr, in_ptr;
  std::vector<int32_t> out_idx, in_idx;
  std::vector<float> out_w, in_w;  // normalized by source out-weight
  std::vector<double> p;           // stationary flow per node
};

void build_graph(int32_t n, int64_t n_edges, const int32_t* src,
                 const int32_t* dst, const float* w, double tau, Graph* g) {
  g->n = n;
  std::vector<int64_t> oc(n + 1, 0), ic(n + 1, 0);
  std::vector<double> out_sum(n, 0.0);
  for (int64_t e = 0; e < n_edges; ++e) {
    oc[src[e] + 1]++;
    ic[dst[e] + 1]++;
    out_sum[src[e]] += w[e];
  }
  g->out_ptr.assign(n + 1, 0);
  g->in_ptr.assign(n + 1, 0);
  std::partial_sum(oc.begin(), oc.end(), g->out_ptr.begin());
  std::partial_sum(ic.begin(), ic.end(), g->in_ptr.begin());
  g->out_idx.resize(n_edges);
  g->out_w.resize(n_edges);
  g->in_idx.resize(n_edges);
  g->in_w.resize(n_edges);
  std::vector<int64_t> op(g->out_ptr.begin(), g->out_ptr.end() - 1);
  std::vector<int64_t> ip(g->in_ptr.begin(), g->in_ptr.end() - 1);
  for (int64_t e = 0; e < n_edges; ++e) {
    double wn = out_sum[src[e]] > 0 ? w[e] / out_sum[src[e]] : 0.0;
    int64_t o = op[src[e]]++;
    g->out_idx[o] = dst[e];
    g->out_w[o] = (float)wn;
    int64_t q = ip[dst[e]]++;
    g->in_idx[q] = src[e];
    g->in_w[q] = (float)wn;
  }
  std::vector<double> pr(n, 1.0 / n), nxt(n);
  unsigned nthreads = std::max(1u, std::thread::hardware_concurrency());
  for (int iter = 0; iter < 200; ++iter) {
    double dang = 0;
    for (int32_t a = 0; a < n; ++a)
      if (out_sum[a] <= 0) dang += pr[a];
    double base = tau / n + (1 - tau) * dang / n;
    // Each destination node's accumulation is independent, so threading over
    // b keeps per-node summation order (and therefore results) bit-stable.
    std::vector<std::thread> ts;
    std::atomic<int32_t> next_blk(0);
    constexpr int32_t kBlk = 2048;
    auto work = [&]() {
      for (;;) {
        int32_t s = next_blk.fetch_add(kBlk);
        if (s >= n) return;
        int32_t e = std::min(s + kBlk, n);
        for (int32_t b = s; b < e; ++b) {
          double acc = 0;
          for (int64_t q = g->in_ptr[b]; q < g->in_ptr[b + 1]; ++q)
            acc += pr[g->in_idx[q]] * g->in_w[q];
          nxt[b] = base + (1 - tau) * acc;
        }
      }
    };
    for (unsigned t = 0; t < nthreads; ++t) ts.emplace_back(work);
    for (auto& t : ts) t.join();
    double diff = 0;
    for (int32_t a = 0; a < n; ++a) diff += std::fabs(nxt[a] - pr[a]);
    pr.swap(nxt);
    if (diff < 1e-13) break;
  }
  g->p = pr;
}

}  // namespace

int32_t reid_infomap(int32_t n, int64_t n_edges, const int32_t* src,
                     const int32_t* dst, const float* w, double tau,
                     int64_t seed, int32_t* labels) {
  if (n == 0) return 0;
  Graph g;
  build_graph(n, n_edges, src, dst, w, tau, &g);

  std::vector<int32_t> module(n);
  std::iota(module.begin(), module.end(), 0);
  std::vector<double> mod_p(g.p), mod_linkexit(n, 0.0);  // (1-tau) link exit
  std::vector<int32_t> mod_size(n, 1);

  // link-exit of module m = (1-tau) * sum_{a in m, a->b, b notin m} p_a*w_ab
  for (int32_t a = 0; a < n; ++a) {
    double le = 0;
    for (int64_t o = g.out_ptr[a]; o < g.out_ptr[a + 1]; ++o)
      if (g.out_idx[o] != a) le += g.p[a] * g.out_w[o];
    mod_linkexit[a] = (1 - tau) * le;
  }

  auto q_of = [&](int32_t m) {
    return tau * ((double)(n - mod_size[m]) / n) * mod_p[m] + mod_linkexit[m];
  };
  auto q_val = [&](double linkexit, double p, int32_t sz) {
    return tau * ((double)(n - sz) / n) * p + linkexit;
  };

  double Q = 0;
  for (int32_t m = 0; m < n; ++m) Q += q_of(m);

  std::mt19937_64 rng(seed);
  std::vector<int32_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::vector<int32_t> cands;
  // Per-module flow accumulators for the node being moved: filled in ONE
  // pass over a's edge lists (edge order, so sums are bit-identical to the
  // former per-candidate rescan), reset via the touched list. Turns the
  // local-move cost from O(deg * #cands) into O(deg + #cands) per node.
  std::vector<double> flow_out(n, 0.0), flow_in(n, 0.0);
  std::vector<char> seen(n, 0);

  bool improved = true;
  int sweeps = 0;
  while (improved && sweeps++ < 100) {
    improved = false;
    std::shuffle(order.begin(), order.end(), rng);
    for (int32_t a : order) {
      int32_t m_old = module[a];
      cands.clear();
      double total_out = 0;  // non-self outgoing flow of a
      for (int64_t o = g.out_ptr[a]; o < g.out_ptr[a + 1]; ++o) {
        int32_t b = g.out_idx[o];
        if (b == a) continue;
        int32_t m = module[b];
        if (!seen[m]) { seen[m] = 1; cands.push_back(m); }
        double f = g.p[a] * g.out_w[o];
        flow_out[m] += f;
        total_out += f;
      }
      for (int64_t q = g.in_ptr[a]; q < g.in_ptr[a + 1]; ++q) {
        int32_t s = g.in_idx[q];
        if (s == a) continue;
        int32_t m = module[s];
        if (!seen[m]) { seen[m] = 1; cands.push_back(m); }
        flow_in[m] += g.p[s] * g.in_w[q];
      }
      if (cands.empty()) continue;
      std::sort(cands.begin(), cands.end());  // keep the old tie-break order

      double out_to_old = flow_out[m_old], in_from_old = flow_in[m_old];

      // old module after removing a: internal links touching a become exit
      double le_old_after = mod_linkexit[m_old]
          - (1 - tau) * (total_out - out_to_old)   // a's exit links leave
          + (1 - tau) * in_from_old;               // members' links to a now exit
      double p_old_after = mod_p[m_old] - g.p[a];
      int32_t sz_old_after = mod_size[m_old] - 1;
      double q_old = q_of(m_old);
      double q_old_after = q_val(le_old_after, p_old_after, sz_old_after);
      double cost_old_before = -2 * plogp(q_old) + plogp(q_old + mod_p[m_old]);
      double cost_old_after = sz_old_after > 0
          ? -2 * plogp(q_old_after) + plogp(q_old_after + p_old_after)
          : 0.0;

      double best_delta = -1e-12;
      int32_t best_m = m_old;
      double best_le = 0, best_p = 0;
      double best_le_old = 0, best_p_old = 0, best_q_sum = 0;

      for (int32_t m_new : cands) {
        if (m_new == m_old) continue;
        double out_to_new = flow_out[m_new], in_from_new = flow_in[m_new];
        double le_new_after = mod_linkexit[m_new]
            + (1 - tau) * (total_out - out_to_new)
            - (1 - tau) * in_from_new;
        double p_new_after = mod_p[m_new] + g.p[a];
        int32_t sz_new_after = mod_size[m_new] + 1;
        double q_new = q_of(m_new);
        double q_new_after = q_val(le_new_after, p_new_after, sz_new_after);
        double cost_new_before =
            -2 * plogp(q_new) + plogp(q_new + mod_p[m_new]);
        double cost_new_after =
            -2 * plogp(q_new_after) + plogp(q_new_after + p_new_after);
        double Q_after = Q - q_old - q_new + q_old_after + q_new_after;
        double delta = (plogp(Q_after) - plogp(Q)) +
                       (cost_old_after - cost_old_before) +
                       (cost_new_after - cost_new_before);
        if (delta < best_delta) {
          best_delta = delta;
          best_m = m_new;
          best_le = le_new_after;
          best_p = p_new_after;
          best_le_old = le_old_after;
          best_p_old = p_old_after;
          best_q_sum = Q_after;
        }
      }

      for (int32_t m : cands) { flow_out[m] = 0.0; flow_in[m] = 0.0; seen[m] = 0; }

      if (best_m != m_old) {
        mod_linkexit[m_old] = best_le_old;
        mod_p[m_old] = best_p_old;
        mod_size[m_old]--;
        mod_linkexit[best_m] = best_le;
        mod_p[best_m] = best_p;
        mod_size[best_m]++;
        module[a] = best_m;
        Q = best_q_sum;
        improved = true;
      }
    }
  }

  std::vector<int32_t> remap(n, -1);
  int32_t k = 0;
  for (int32_t a = 0; a < n; ++a) {
    if (remap[module[a]] == -1) remap[module[a]] = k++;
    labels[a] = remap[module[a]];
  }
  return k;
}

}  // extern "C"
