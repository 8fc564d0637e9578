"""DBSCAN over a precomputed distance matrix (port of
``reid_gan_tpu/clustering/dbscan.py``; replaces sklearn's
DBSCAN(metric='precomputed'), CC/examples/cluster_contrast_train_usl.py:
160-163).

Core points (≥ min_samples neighbours within eps, self included) expand
clusters breadth-first; a border point joins the first core cluster that
reaches it; the rest are noise (−1). Deterministic in index order. The
port's host C++ (``reid_gan_torch.native``) runs it; the numpy BFS is the
plain version, reached only with ``native=False``.
"""

import numpy as np

from ..native import dbscan_native


def dbscan(dist, eps, min_samples=4, native=True):
    """dist: (N, N) symmetric host distance matrix. Returns labels (N,)
    int32, −1 = noise."""
    if native:
        return dbscan_native(dist, eps, min_samples)
    dist = np.asarray(dist)
    n = dist.shape[0]
    neighbors = dist <= eps          # boolean adjacency, self included
    core = neighbors.sum(axis=1) >= min_samples
    labels = np.full(n, -1, np.int32)
    cluster = 0
    for i in range(n):
        if labels[i] != -1 or not core[i]:
            continue
        labels[i] = cluster
        frontier = [i]
        while frontier:
            nxt = []
            for p in frontier:
                if not core[p]:
                    continue
                reach = np.nonzero(neighbors[p] & (labels == -1))[0]
                labels[reach] = cluster
                nxt.extend(reach.tolist())
            frontier = nxt
        cluster += 1
    return labels
