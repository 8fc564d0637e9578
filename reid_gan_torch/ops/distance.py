"""Pairwise distances (port of ``reid_gan_tpu/ops/distance.py``)."""

import torch


def squared_euclidean(x, y):
    """(m, d), (n, d) → (m, n) squared L2 distances ``‖x‖² + ‖y‖² − 2 x·yᵀ``
    (ops/distance.py:21-29).

    The product runs in full fp32, as the JAX package's
    ``Precision.HIGHEST``: TF32 keeps ~3 decimal digits and would reorder
    near-ties in the ranking that consumes this block. The flag is restored
    afterwards, so callers' own matmuls keep their setting."""
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    y2 = torch.sum(y * y, dim=1, keepdim=True)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        xy = torch.matmul(x, y.T)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return torch.clamp_min(x2 + y2.T - 2.0 * xy, 0.0)
