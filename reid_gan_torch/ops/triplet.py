"""Batch-hard triplet mining (port of ``reid_gan_tpu/ops/triplet.py``).

The reference carries the triplet loss only as commented-out intent
(CC/clustercontrast/trainers.py:27 ``nn.TripletMarginLoss(margin=1.0,
p=2)``; trainers_b.py:371-378); this is its intended semantics: the whole
pairwise-distance matrix in one product, and the hardest positive and
negative of each anchor as masked row reductions over it.
"""

import torch

from .distance import squared_euclidean


def pairwise_l2(x, y):
    """Euclidean distances with a root safe to differentiate at zero: the
    squared distance clamped at 1e-12 before the root, and 0 where it is at
    or below 1e-12."""
    d2 = squared_euclidean(x, y)
    d = torch.sqrt(torch.clamp_min(d2, 1e-12))
    return torch.where(d2 <= 1e-12, torch.zeros_like(d), d)


def batch_hard_mine(features, labels):
    """The hardest positive and negative distance of each anchor (Hermans
    et al., "In Defense of the Triplet Loss"):
    d_ap[i] = max { d(i, j) : labels[j] == labels[i], j != i },
    d_an[i] = min { d(i, j) : labels[j] != labels[i] }.
    Returns (d_ap, d_an, valid): a distance is 0 where the batch holds no
    positive (negative) for the anchor, and ``valid`` flags the anchors
    that have both."""
    d = pairwise_l2(features, features)
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(labels.shape[0], dtype=torch.bool, device=d.device)
    inf = torch.full_like(d, torch.inf)
    d_ap = torch.amax(torch.where(same & ~eye, d, -inf), dim=1)
    d_an = torch.amin(torch.where(~same, d, inf), dim=1)
    valid = torch.isfinite(d_ap) & torch.isfinite(d_an)
    d_ap = torch.where(torch.isfinite(d_ap), d_ap, torch.zeros_like(d_ap))
    d_an = torch.where(torch.isfinite(d_an), d_an, torch.zeros_like(d_an))
    return d_ap, d_an, valid


def batch_hard_triplet_loss(features, labels, margin=1.0, soft=False):
    """The batch-hard triplet loss averaged over the anchors that have both
    a positive and a negative in the batch (the others add nothing, where a
    hinge on their zeroed distances would add a spurious ``margin``):
    ``max(d_ap − d_an + margin, 0)``, or with ``soft`` the margin-free
    ``ln(1 + exp(d_ap − d_an))``."""
    d_ap, d_an, valid = batch_hard_mine(features, labels)
    if soft:
        per_anchor = torch.logaddexp(d_ap - d_an, torch.zeros_like(d_ap))
    else:
        per_anchor = torch.clamp_min(d_ap - d_an + margin, 0.0)
    per_anchor = torch.where(valid, per_anchor, torch.zeros_like(per_anchor))
    return per_anchor.sum() / torch.clamp_min(valid.sum(), 1)
