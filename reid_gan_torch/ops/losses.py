"""Auxiliary losses: gradient matching and contrastive helpers (port of
``reid_gan_tpu/ops/losses.py``; parity: CC/clustercontrast/trainers_b.py:
``distance_wb`` :72-89, ``match_loss`` :92-144, ``contrastive_loss``
:1151-1159, ``intra_cl`` :1161-1172, ``cl_loss`` :1174-1184)."""

import torch


def _l2n(x, dim=-1, eps=1e-12):
    return x * torch.rsqrt(torch.sum(x * x, dim=dim, keepdim=True) + eps)


def _leaves(tree):
    """The tensors of a nested dict / list / tuple, dicts in sorted key
    order (as ``jax.tree_util.tree_leaves``)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def distance_wb(gwr, gws):
    """The grouped cosine distance of two gradient tensors: both reshaped to
    (shape[0], -1) (4-D and 3-D; 2-D as they are), then Σ over rows of
    1 − cos; a 1-D tensor (a bias or a norm's vector) gives 0."""
    if gwr.dim() == 1:
        return gwr.new_zeros(())
    if gwr.dim() in (3, 4):
        gwr = gwr.reshape(gwr.shape[0], -1)
        gws = gws.reshape(gws.shape[0], -1)
    num = torch.sum(gwr * gws, dim=-1)
    den = torch.linalg.vector_norm(gwr, dim=-1) * torch.linalg.vector_norm(gws, dim=-1) \
        + 1e-6
    return torch.sum(1.0 - num / den)


def match_loss(g_syn, g_real, dis_metric="ours"):
    """The distance of two gradient trees (dicts, lists or tuples of
    tensors of the same structure): ``ours`` sums ``distance_wb`` over the
    pairs, ``mse`` is the squared distance and ``cos`` 1 − the cosine of
    the flattened trees."""
    syn, real = _leaves(g_syn), _leaves(g_real)
    if dis_metric == "ours":
        return sum(distance_wb(a, b) for a, b in zip(real, syn))
    if dis_metric not in ("mse", "cos"):
        raise ValueError(f"unknown distance metric: {dis_metric}")
    gr = torch.cat([a.reshape(-1) for a in real])
    gs = torch.cat([a.reshape(-1) for a in syn])
    if dis_metric == "mse":
        return torch.sum((gr - gs) ** 2)
    return 1.0 - torch.sum(gr * gs) / (
        torch.linalg.vector_norm(gr) * torch.linalg.vector_norm(gs) + 1e-6)


def contrastive_loss(q, k, temp=0.05):
    """InfoNCE of ``q`` against ``k`` with the in-batch identity as targets,
    scaled by 2·temp."""
    logits = _l2n(q) @ _l2n(k).T / temp
    n = q.shape[0]
    idx = torch.arange(n, device=q.device)
    loss = (torch.logsumexp(logits, dim=1) - logits[idx, idx]).mean()
    return loss * 2 * temp


def intra_cl(q, k, group_size=16, temp=0.05):
    """The contrastive loss of the logits summed over each group of
    ``group_size`` rows of ``q``, group i's target column i."""
    logits = _l2n(q) @ _l2n(k).T / temp
    logits = logits.reshape(-1, group_size, logits.shape[1]).sum(dim=1)
    idx = torch.arange(logits.shape[0], device=q.device)
    return (torch.logsumexp(logits, dim=1) - logits[idx, idx]).mean()


def cl_loss(q, k, group_size=16, temp=0.05):
    """The contrastive loss of the logits summed over each group of
    ``group_size`` columns, row r's target group r // group_size of the
    first half."""
    logits = _l2n(q) @ _l2n(k).T / temp
    n_groups = logits.shape[1] // group_size
    logits = logits.reshape(logits.shape[0], n_groups, group_size).sum(dim=-1)
    labels = torch.arange(n_groups // 2, device=q.device).repeat_interleave(
        group_size)[:logits.shape[0]]
    picked = torch.gather(logits, 1, labels[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=1) - picked).mean()
