"""Unsupervised cluster-contrast loop, host half (port of
``reid_gan_tpu/engine/usl.py``; parity: CC/examples/
cluster_contrast_train_usl.py): centroids of the pseudo-labels, the
pseudo-labelled train set, the P×K train loader and the bank's padded size.
``cluster_epoch`` (feature extraction → kNN → Jaccard → DBSCAN) comes with
the next slice.
"""

import numpy as np

from ..data import IterLoader
from ..data.loader import DataLoader, Preprocessor
from ..data.sampler import RandomMultipleGallerySampler


def generate_cluster_features(labels, features):
    """Mean feature per cluster id ≥ 0, ordered by id, L2-normalised
    (usl.py:24-32; CC/examples/...usl.py:169-184)."""
    labels = np.asarray(labels)
    order = np.unique(labels[labels >= 0])
    centers = np.stack([features[labels == k].mean(axis=0) for k in order])
    centers /= np.linalg.norm(centers, axis=1, keepdims=True) + 1e-12
    return centers


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
