"""Unsupervised cluster-contrast loop (port of ``reid_gan_tpu/engine/usl.py``;
parity: CC/examples/cluster_contrast_train_usl.py, DBSCAN recipe, and
cluster_contrast_train_usl_infomap.py, Infomap recipe). Per epoch,
``cluster_epoch``:

  1. extracts the L2-normalised features of the whole train set (kernels K1,
     K2 on the card);
  2. makes pseudo-labels: kNN (kernel K8) → k-reciprocal Jaccard → DBSCAN
     (host C++), or an inner-product kNN graph (K8) → Infomap, or k-means;
  3. builds the centroid bank (normalised means, padded to a multiple of
     256 rows).

The caller then rebuilds the P×K loader over the pseudo-labelled subset
(``make_train_loader``) and runs the InfoNCE epoch (``engine/trainers.py``).
"""

import numpy as np

from ..clustering.dbscan import dbscan
from ..clustering.infomap import cluster_by_infomap
from ..clustering.kmeans import kmeans_labels
from ..data import IterLoader
from ..data.loader import DataLoader, Preprocessor
from ..data.sampler import RandomMultipleGallerySampler
from ..ops.cluster_memory import init_memory
from ..ops.jaccard import compute_jaccard_distance
from ..utils import Timer


def generate_cluster_features(labels, features):
    """Mean feature per cluster id ≥ 0, ordered by id, L2-normalised
    (usl.py:24-32; CC/examples/...usl.py:169-184)."""
    labels = np.asarray(labels)
    order = np.unique(labels[labels >= 0])
    centers = np.stack([features[labels == k].mean(axis=0) for k in order])
    centers /= np.linalg.norm(centers, axis=1, keepdims=True) + 1e-12
    return centers


def pseudo_labels_dbscan(features, eps=0.4, min_samples=4, k1=30, k2=6,
                         print_flag=True, device=None):
    """Jaccard distance + DBSCAN (usl.py:35-44; CC/examples/
    cluster_contrast_train_usl.py:154-164). The kNN runs on ``device``."""
    with Timer("jaccard", verbose=print_flag):
        dist = compute_jaccard_distance(features, k1=k1, k2=k2,
                                        print_flag=print_flag, device=device)
    with Timer("dbscan", verbose=print_flag):
        labels = dbscan(dist, eps=eps, min_samples=min_samples)
    return labels


def pseudo_labels_infomap(features, eps=0.5, k1=15, print_flag=True,
                          cluster_num=4, device=None):
    """Inner-product kNN graph + Infomap communities, small ones → outliers
    (usl.py:47-55; CC/clustercontrast/utils/infomap_cluster.py:147-227)."""
    return cluster_by_infomap(features, k=k1, min_sim=eps, cluster_num=cluster_num,
                              print_flag=print_flag, device=device)


def build_pseudo_dataset(train_set, labels):
    """(fname, pseudo_label, camid) triples for clustered samples only
    (usl.py:58-65)."""
    out = []
    for (fname, _, camid), label in zip(train_set, labels):
        if label >= 0:
            out.append((fname, int(label), camid))
    return out


def bank_rows(num_clusters, k_pad=None):
    """Rows of the bank: the cluster count rounded up to a multiple of 256,
    and at least ``k_pad`` (usl.py:135-137), so the bank keeps its shape as
    the count drifts between epochs."""
    return max(k_pad or 0, 256 * -(-num_clusters // 256))


def extract_train_features(extractor, train_set, height, width, batch_size=256,
                           workers=4, cache="default"):
    """Features of the whole train set in its order → (N, D) host array
    (usl.py:68-84). The GAN-feature branch waits for the joint slice."""
    from .evaluators import extract_features

    if getattr(extractor, "extra", False):
        raise NotImplementedError(
            "clustering on GAN features is not ported yet: it comes with the "
            "joint GAN slice (ROADMAP A: GAN-feature clustering)")
    pre = Preprocessor(train_set, mode="reid", height=height, width=width, cache=cache)
    loader = DataLoader(pre, batch_size=batch_size, drop_last=False, num_workers=workers)
    features, _ = extract_features(extractor, loader, print_freq=1 << 30)
    return np.stack([features[f] for f, _, _ in train_set])


def make_train_loader(train_set, height, width, batch_size, num_instances,
                      workers=4, iters=400, seed=None, mode="reid", **pre_kw):
    """P×K loader over ``train_set`` (usl.py:87-95): an ``IterLoader`` of
    ``iters`` batches whose indices come from a seeded
    ``RandomMultipleGallerySampler``."""
    sampler = RandomMultipleGallerySampler(train_set, num_instances, seed=seed)
    pre = Preprocessor(train_set, mode=mode, height=height, width=width, **pre_kw)
    loader = DataLoader(pre, sampler=sampler, batch_size=batch_size,
                        num_workers=workers, drop_last=True)
    it = IterLoader(loader, length=iters)
    it.new_epoch()
    return it


def cluster_epoch(extractor, train_set, cfg, k_pad=None, backend=None,
                  print_flag=True, cache="default", on_cluster=None):
    """One clustering phase → (memory_state, pseudo_dataset, num_clusters)
    (usl.py:98-139). Features come from ``extractor`` (on its device); the
    kNN and the bank live on the same device. The bank is padded to a
    multiple of 256 rows and to at least ``k_pad``. ``on_cluster``, where
    given, is called with the (N, D) host features and the labels."""
    device = extractor.device
    with Timer("extract", verbose=print_flag):
        feats = extract_train_features(extractor, train_set, cfg.data.height,
                                       cfg.data.width, batch_size=cfg.data.batch_size,
                                       workers=cfg.data.workers, cache=cache)
    backend = backend or cfg.cluster.cluster_backend
    if backend == "dbscan":
        labels = pseudo_labels_dbscan(feats, eps=cfg.cluster.eps,
                                      min_samples=cfg.cluster.min_samples,
                                      k1=cfg.cluster.k1, k2=cfg.cluster.k2,
                                      print_flag=print_flag, device=device)
    elif backend == "infomap":
        labels = pseudo_labels_infomap(feats, eps=cfg.cluster.eps, k1=cfg.cluster.k1,
                                       cluster_num=cfg.cluster.k2,
                                       print_flag=print_flag, device=device)
    elif backend == "kmeans":
        labels, _ = kmeans_labels(feats, cfg.cluster.max_clusters or 64, device=device)
    else:
        raise KeyError(backend)
    if on_cluster is not None:
        on_cluster(feats, labels)
    num_clusters = int(labels.max()) + 1 if (labels >= 0).any() else 0
    if print_flag:
        print(f"==> Clustered into {num_clusters} classes "
              f"({int((labels == -1).sum())} outliers)")
    with Timer("bank", verbose=print_flag):
        memory = init_memory(generate_cluster_features(labels, feats),
                             k_pad=bank_rows(num_clusters, k_pad), device=device)
    return memory, build_pseudo_dataset(train_set, labels), num_clusters
