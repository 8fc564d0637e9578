"""k-reciprocal Jaccard distance and re-ranking (port of
``reid_gan_tpu/ops/jaccard.py``; parity: CC/clustercontrast/utils/
faiss_rerank.py:30-123, rerank.py:31-97).

The O(N²·D) kNN ranking runs on the card (``ops.distance.knn_search``,
kernel K8); the irregular k-reciprocal expansion and the sparse min-sum run
in the port's host C++ (``reid_gan_torch.native``) over the small (N×k)
neighbour lists. The per-row python path stays as the plain version for the
tests, reached only with ``native=False``; there is no silent fallback.
"""

import time

import numpy as np

from ..native import (jaccard_minsum_rows_native, kreciprocal_v_dist_native,
                      kreciprocal_v_native)
from ..utils import Timer, to_numpy
from .distance import knn_search


def k_reciprocal_neigh(initial_rank, i, k):
    """Neighbours j of i (within top-k+1, self included) that also rank i
    within their own top-k+1 (faiss_rerank.py:23-27)."""
    forward = initial_rank[i, : k + 1]
    backward = initial_rank[forward, : k + 1]
    fi = np.where(backward == i)[0]
    return forward[fi]


def _expanded_reciprocal(initial_rank, i, nn_k1, nn_k1_half):
    """The k-reciprocal set of i expanded with every candidate whose half-k
    reciprocal set overlaps it by more than 2/3 (faiss_rerank.py:73-80)."""
    k_reciprocal_index = nn_k1[i]
    expansion = [k_reciprocal_index]
    for candidate in k_reciprocal_index:
        candidate_set = nn_k1_half[candidate]
        if len(np.intersect1d(candidate_set, k_reciprocal_index)) > (2.0 / 3) * len(candidate_set):
            expansion.append(candidate_set)
    return np.unique(np.concatenate(expansion))


def _query_expand(V, initial_rank, k2):
    """k2 query expansion: row i ← the mean of its top-k2 neighbours' rows
    (faiss_rerank.py:89-93)."""
    if k2 == 1:
        return V
    return V[initial_rank[:, :k2]].mean(axis=1)


def _min_sum_jaccard(V, query_num=None):
    """Jaccard distance from the dense soft-assignment matrix V (the plain
    version of ``jaccard_minsum_rows_native``):
    jac[i, :] = 1 − s / (2 − s), s = Σ_j min(V[i, j], V[:, j]) over the
    nonzero columns of row i (faiss_rerank.py:98-115)."""
    n = V.shape[0]
    m = n if query_num is None else query_num
    jaccard = np.zeros((m, n), V.dtype)
    Vt = V.T.copy()
    for i in range(m):
        cols = np.nonzero(V[i])[0]
        if cols.size == 0:
            jaccard[i] = 1.0
            continue
        temp_min = np.minimum(V[i, cols][:, None], Vt[cols]).sum(axis=0)
        jaccard[i] = 1.0 - temp_min / (2.0 - temp_min)
    return jaccard


def _k_reciprocal_sets(initial_rank, k1, n):
    half = int(np.around(k1 / 2))
    nn_k1 = [k_reciprocal_neigh(initial_rank, i, k1) for i in range(n)]
    nn_k1_half = [k_reciprocal_neigh(initial_rank, i, half) for i in range(n)]
    return nn_k1, nn_k1_half


def jaccard_from_rank(initial_rank, features, k1=30, k2=6, native=True):
    """The Jaccard half of ``compute_jaccard_distance`` (jaccard.py:121-158):
    from a kNN table ``initial_rank`` (N, rank_w) int32, self first, and the
    (N, D) L2-normalised features. Returns (N, N) float32, zeros clipped."""
    feats = np.asarray(features, np.float32)
    n = feats.shape[0]
    if native:
        idx, w, cnt = kreciprocal_v_native(initial_rank, feats, k1, k2)
        # the C min-sum clips negatives as it writes
        return jaccard_minsum_rows_native(idx, w, cnt)
    nn_k1, nn_k1_half = _k_reciprocal_sets(initial_rank, k1, n)
    V = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        idx = _expanded_reciprocal(initial_rank, i, nn_k1, nn_k1_half)
        # soft weights: softmax over −(2−2·cos) distances (faiss_rerank.py:81-85)
        dist = 2.0 - 2.0 * feats[i] @ feats[idx].T
        e = np.exp(-dist)
        V[i, idx] = e / e.sum()
    V = _query_expand(V, initial_rank, k2).astype(np.float32)
    jaccard = _min_sum_jaccard(V)
    np.clip(jaccard, 0.0, None, out=jaccard)
    return jaccard


def compute_jaccard_distance(features, k1=30, k2=6, print_flag=True, native=True,
                             device=None):
    """Jaccard distance over k-reciprocal encodings for pseudo-labelling
    (jaccard.py:89-158). ``features``: (N, D) L2-normalised, a host array
    (searched on ``device``, default the card) or a tensor (searched where
    it lies). The kNN table has ``min(k1, N)`` columns, self included.
    Returns the (N, N) float32 matrix, zeros clipped."""
    end = time.time()
    if print_flag:
        print("Computing jaccard distance...")
    with Timer("knn", verbose=print_flag):
        _, initial_rank = knn_search(features, k=min(k1, features.shape[0]),
                                     metric="l2", device=device)
    jaccard = jaccard_from_rank(initial_rank, to_numpy(features), k1, k2,
                                native=native)
    if print_flag:
        print(f"Jaccard distance computing time cost: {time.time() - end}")
    return jaccard


def _topk_rank(dist, rank_w):
    """Row-wise indices of the ``rank_w`` smallest entries, ascending: an
    argpartition, then a sort inside the kept block (jaccard.py:161-172)."""
    n = dist.shape[1]
    if rank_w >= n:
        return np.argsort(dist, axis=1).astype(np.int32)
    part = np.argpartition(dist, rank_w - 1, axis=1)[:, :rank_w]
    block = np.take_along_axis(dist, part, axis=1)
    order = np.argsort(block, axis=1)
    return np.take_along_axis(part, order, axis=1).astype(np.int32)


def re_ranking(q_g_dist, q_q_dist, g_g_dist, k1=20, k2=6, lambda_value=0.3,
               native=True):
    """k-reciprocal re-ranking of an eval distance matrix (jaccard.py:
    175-232; parity: rerank.py:31-97, weights exp(−dist / column max)).
    Host arrays in, the (query, gallery) host array out."""
    q_g_dist = np.asarray(q_g_dist, np.float32)
    q_q_dist = np.asarray(q_q_dist, np.float32)
    g_g_dist = np.asarray(g_g_dist, np.float32)
    original_dist = np.concatenate(
        [np.concatenate([q_q_dist, q_g_dist], axis=1),
         np.concatenate([q_g_dist.T, g_g_dist], axis=1)], axis=0)
    original_dist = np.power(original_dist, 2).astype(np.float32)
    original_dist = np.ascontiguousarray(
        (original_dist / np.max(original_dist, axis=0)).T)

    query_num = q_g_dist.shape[0]
    all_num = original_dist.shape[0]
    initial_rank = _topk_rank(original_dist, min(all_num, max(k1 + 1, k2)))

    if native:
        idx, w, cnt = kreciprocal_v_dist_native(initial_rank, original_dist, k1, k2)
        jaccard = jaccard_minsum_rows_native(idx, w, cnt, query_num=query_num)
    else:
        nn_k1, nn_k1_half = _k_reciprocal_sets(initial_rank, k1, all_num)
        V = np.zeros_like(original_dist, np.float32)
        for i in range(all_num):
            idx = _expanded_reciprocal(initial_rank, i, nn_k1, nn_k1_half)
            weight = np.exp(-original_dist[i, idx])
            V[i, idx] = weight / weight.sum()
        V = _query_expand(V, initial_rank, k2).astype(np.float32)
        jaccard = _min_sum_jaccard(V, query_num=query_num)
    final_dist = jaccard * (1 - lambda_value) + original_dist[:query_num] * lambda_value
    return final_dist[:, query_num:]
