"""Infomap pseudo-labels: an inner-product kNN graph (kernel K8's IP
epilogue on the card) and the port's native two-level directed map-equation
communities (port of ``reid_gan_tpu/clustering/infomap.py``; parity:
CC/clustercontrast/utils/infomap_cluster.py).

- get_dist_nbr (faiss IP kNN, :230-234) → ``ops.distance.knn_search``
- get_links (sim ≥ min_sim, early break over sorted neighbours, :129-144)
- infomap.Infomap('--two-level --directed') (:160-165) → ``infomap_native``
- clusters with ≤ cluster_num members, isolated singletons included → −1
  (:204-216)
"""

import numpy as np

from ..native import infomap_native
from ..ops.distance import knn_search
from ..utils import Timer


def build_knn_links(features, k=15, min_sim=0.55, device=None):
    """Edge list (src, dst, sim) over the top-k inner-product neighbours with
    sim ≥ min_sim, and the isolated nodes. ``knn_search`` sorts neighbours
    by descending similarity, so the reference's early-break scan is the
    mask ``(sim ≥ min_sim) & (nbr ≠ self)`` (infomap.py:20-39)."""
    sims, nbrs = knn_search(features, k=k, metric="ip", device=device)
    n = sims.shape[0]
    mask = (sims >= min_sim) & (nbrs != np.arange(n, dtype=nbrs.dtype)[:, None])
    src = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None], mask.shape)[mask]
    dst = nbrs[mask].astype(np.int32)
    w = sims[mask].astype(np.float32)
    single = np.nonzero(~mask.any(axis=1))[0].tolist()
    return src, dst, w, single


def cluster_by_infomap(features, k=15, min_sim=0.55, cluster_num=2,
                       print_flag=True, seed=0, device=None):
    """Labels (N,) int64; −1 = outlier (a cluster of ≤ cluster_num)."""
    n = features.shape[0]
    with Timer("get links", verbose=print_flag):
        src, dst, w, single = build_knn_links(features, k=k, min_sim=min_sim,
                                              device=device)
    with Timer("infomap", verbose=print_flag):
        labels, _ = infomap_native(src, dst, w, n, seed=seed)

    # isolated nodes → their own singleton clusters (infomap_cluster.py:192-198)
    labels = labels.astype(np.int64)
    next_label = int(labels.max()) + 1 if n else 0
    for s in single:
        labels[s] = next_label
        next_label += 1
    if print_flag:
        print(f"isolated nodes: {len(single)}")

    # small clusters → outliers, relabelled densely (infomap_cluster.py:204-216)
    out = np.full(n, -1, np.int64)
    uniq, counts = np.unique(labels, return_counts=True)
    keep = uniq[counts > cluster_num]
    for new, old in enumerate(keep):
        out[labels == old] = new
    if print_flag:
        print(f"num clusters: {len(keep)} (of {next_label} raw modules)")
    return out
