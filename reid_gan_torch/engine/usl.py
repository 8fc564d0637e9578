"""Unsupervised cluster-contrast loop (port of ``reid_gan_tpu/engine/usl.py``;
parity: CC/examples/cluster_contrast_train_usl.py, DBSCAN recipe, and
cluster_contrast_train_usl_infomap.py, Infomap recipe). Per epoch,
``cluster_epoch``:

  1. extracts the L2-normalised features of the whole train set (kernels K1,
     K2 on the card) and, with an ``extra_features`` extractor, the pooled
     GAN features too (K11);
  2. makes pseudo-labels: kNN (kernel K8) → k-reciprocal Jaccard → DBSCAN
     (host C++), or an inner-product kNN graph (K8) → Infomap, or k-means;
  3. builds the centroid bank (normalised means, padded to a multiple of
     256 rows), and from the pooled GAN features the parallel GAN bank.

The caller then rebuilds the P×K loader over the pseudo-labelled subset
(``make_train_loader``) and runs the InfoNCE epoch (``engine/trainers.py``).

Under the extractor's data mesh the extraction is sharded and every rank
gathers all the features; rank 0 alone runs the kNN (K8), the Jaccard
distance and the clustering, and broadcasts the labels, from which every
rank builds the same bank. K8 is not split into row slabs over the ranks, as
the JAX package shards its row blocks (usl.py:101-118): it computes each
tile pair of the symmetric product once, on the tensor cores, for both
rows' top-k lists (``csrc/knn_topk.cu``), which a slab of rows would break,
and it takes 8.3 ms for Market-1501's 12,936 train images; the labels are
the ones the JAX package's sharded blocks give.
"""

import numpy as np
import torch

from ..clustering.dbscan import dbscan
from ..clustering.infomap import cluster_by_infomap
from ..clustering.kmeans import kmeans_labels
from ..data import IterLoader
from ..data.loader import DataLoader, Preprocessor
from ..data.sampler import RandomMultipleGallerySampler
from ..ops.cluster_memory import init_memory
from ..ops.jaccard import compute_jaccard_distance
from ..parallel.mesh import is_main, replicate
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
    """Features of the whole train set in its order → ((N, D) host array,
    (N, C) pooled GAN features with an ``extra_features`` extractor, else
    None) (usl.py:68-84; reference ...infomap.py:309-318). Under the
    extractor's mesh each rank decodes its slice of each batch and gets all
    the features."""
    from .evaluators import extract_features

    pre = Preprocessor(train_set, mode="reid", height=height, width=width, cache=cache)
    loader = DataLoader(pre, batch_size=batch_size, drop_last=False, num_workers=workers,
                        shard=getattr(extractor, "mesh", None))
    out = extract_features(extractor, loader, print_freq=1 << 30)
    feats = np.stack([out[0][f] for f, _, _ in train_set])
    if not getattr(extractor, "extra", False):
        return feats, None
    return feats, np.stack([out[1][f] for f, _, _ in train_set])


def make_train_loader(train_set, height, width, batch_size, num_instances,
                      workers=4, iters=400, seed=None, mode="reid", shard=None,
                      **pre_kw):
    """P×K loader over ``train_set`` (usl.py:87-95): an ``IterLoader`` of
    ``iters`` batches whose indices come from a seeded
    ``RandomMultipleGallerySampler``. With ``shard`` (a mesh) each rank
    decodes its slice of each batch (``DataLoader``); the mesh size must
    divide ``batch_size``."""
    if shard is not None and batch_size % shard.world_size:
        raise ValueError(f"a batch of {batch_size} does not split over "
                         f"{shard.world_size} ranks")
    sampler = RandomMultipleGallerySampler(train_set, num_instances, seed=seed)
    pre = Preprocessor(train_set, mode=mode, height=height, width=width, **pre_kw)
    loader = DataLoader(pre, sampler=sampler, batch_size=batch_size,
                        num_workers=workers, drop_last=True, shard=shard)
    it = IterLoader(loader, length=iters)
    it.new_epoch()
    return it


def cluster_epoch(extractor, train_set, cfg, k_pad=None, backend=None,
                  print_flag=True, cache="default", on_cluster=None):
    """One clustering phase → (memory_state, pseudo_dataset, num_clusters)
    (usl.py:98-139). Features come from ``extractor`` (on its device); the
    kNN and the bank live on the same device. The bank is padded to a
    multiple of 256 rows and to at least ``k_pad``; with an
    ``extra_features`` extractor the GAN bank holds the clusters' normalised
    mean GAN features, row for row (usl.py:130-138). ``on_cluster``, where
    given, is called with the (N, D) host features and the labels. Under the
    extractor's mesh rank 0 clusters and broadcasts the labels (the
    module's docstring)."""
    device = extractor.device
    mesh = getattr(extractor, "mesh", None)
    with Timer("extract", verbose=print_flag):
        feats, gan_feats = extract_train_features(extractor, train_set, cfg.data.height,
                                       cfg.data.width, batch_size=cfg.data.batch_size,
                                       workers=cfg.data.workers, cache=cache)
    if is_main(mesh):
        labels = pseudo_labels(feats, cfg, backend, print_flag, device)
    else:
        labels = np.zeros(len(feats), np.int64)
    if mesh is not None:
        labels = replicate(mesh, torch.as_tensor(np.asarray(labels, np.int64))
                           .to(mesh.device)).cpu().numpy()
    if on_cluster is not None:
        on_cluster(feats, labels)
    num_clusters = int(labels.max()) + 1 if (labels >= 0).any() else 0
    if print_flag:
        print(f"==> Clustered into {num_clusters} classes "
              f"({int((labels == -1).sum())} outliers)")
    with Timer("bank", verbose=print_flag):
        gan_centers = None if gan_feats is None else \
            generate_cluster_features(labels, gan_feats)
        memory = init_memory(generate_cluster_features(labels, feats),
                             k_pad=bank_rows(num_clusters, k_pad),
                             gan_centroids=gan_centers, device=device)
    return memory, build_pseudo_dataset(train_set, labels), num_clusters


def pseudo_labels(feats, cfg, backend=None, print_flag=True, device=None):
    """The pseudo-labels of (N, D) host features by ``backend`` (default:
    ``cfg.cluster.cluster_backend``), −1 for outliers (usl.py:104-124)."""
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
    return labels
