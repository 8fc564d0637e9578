"""k-means pseudo-labels: Lloyd iterations as fp32 products on the device
(port of ``reid_gan_tpu/clustering/kmeans.py``; replaces faiss.Kmeans in
CC/clustercontrast/models/kmeans.py:14-34). The JAX version leaves its
``Precision.HIGHEST`` products to XLA, outside any kernel, so the port
leaves them to ``torch.matmul`` in full fp32.
"""

import numpy as np
import torch

from ..device import resolve_device
from ..ops.distance import matmul_fp32


def _assign(feats, centers):
    """Nearest center by squared L2 (‖c‖² − 2 x·c; ‖x‖² is constant per
    row); the first center on a tie, as ``jnp.argmin``."""
    c2 = torch.sum(centers * centers, dim=1)
    return torch.argmin(c2[None, :] - 2.0 * matmul_fp32(feats, centers.T), dim=1)


def kmeans_labels(features, num_clusters, iters=20, seed=0, device=None):
    """Returns (labels (N,), centers (k, D)) as host arrays. The initial
    centers are rows drawn by ``np.random.RandomState(seed)``, as the JAX
    version draws them. ``features`` go to ``device`` (default: the card)."""
    device = resolve_device(device)
    feats = torch.from_numpy(np.asarray(features, np.float32)).to(device)
    rng = np.random.RandomState(seed)
    init_idx = rng.choice(feats.shape[0], num_clusters, replace=False)
    centers = feats[torch.from_numpy(init_idx).to(device)]
    for _ in range(iters):
        onehot = torch.nn.functional.one_hot(_assign(feats, centers),
                                             num_clusters).to(feats.dtype)
        sums = matmul_fp32(onehot.T, feats)
        counts = onehot.sum(dim=0)[:, None]
        centers = torch.where(counts > 0, sums / torch.clamp_min(counts, 1), centers)
    return _assign(feats, centers).cpu().numpy(), centers.cpu().numpy()
