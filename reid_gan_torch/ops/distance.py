"""Pairwise distances and the all-pairs kNN (port of
``reid_gan_tpu/ops/distance.py``).

Every product is fp32-accurate, as the JAX package's ``Precision.HIGHEST``:
TF32 keeps ~3 decimal digits and would reorder near-ties in the rankings
that consume these blocks. The plain products run in full fp32 with TF32
off (``matmul_fp32``). ``knn_search`` is kernel K8 (``csrc/knn_topk.cu``) on
a CUDA tensor: the products of the upper triangle only, on the tensor cores
at fp32 accuracy through 3xTF32, fused with a running top-k per row, so the
N x N matrix never exists. Its plain version, ``knn_search_plain``, takes
the row-blocked distance block and a stable sort; a CPU tensor takes it.
"""

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import KNN_TOPK

def matmul_fp32(x, y_t):
    """``x @ y_t`` with TF32 off; the flag is restored afterwards, so
    callers' own matmuls keep their setting."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(x, y_t)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def l2_normalize(x, dim=-1, eps=1e-12):
    """``x / sqrt(|x|^2 + eps)`` along ``dim`` (distance.py:17-18)."""
    return x * torch.rsqrt(torch.sum(x * x, dim=dim, keepdim=True) + eps)


def squared_euclidean(x, y):
    """(m, d), (n, d) → (m, n) squared L2 distances ``‖x‖² + ‖y‖² − 2 x·yᵀ``
    clamped at 0 (distance.py:21-29)."""
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    y2 = torch.sum(y * y, dim=1, keepdim=True)
    return torch.clamp_min(x2 + y2.T - 2.0 * matmul_fp32(x, y.T), 0.0)


def cosine_similarity(x, y):
    """Inner products of L2-normalised rows (distance.py:32-37)."""
    return matmul_fp32(l2_normalize(x), l2_normalize(y).T)


def _as_features(features, device):
    """A float32 tensor: a tensor stays where it lies, a host array goes to
    ``device`` (default: the card; raises if there is none)."""
    if torch.is_tensor(features):
        return features.to(torch.float32)
    return torch.from_numpy(np.asarray(features, np.float32)).to(resolve_device(device))


def pairwise_distance(query, gallery=None, block_rows=4096, device=None):
    """Full (m, n) squared-L2 matrix as a host float32 array, computed in
    row blocks of ``block_rows`` queries so device memory stays bounded
    (distance.py:81-115); ``gallery=None`` gives the self-distances."""
    q = _as_features(query, device)
    g = q if gallery is None else _as_features(gallery, q.device)
    out = np.empty((q.shape[0], g.shape[0]), np.float32)
    for s in range(0, q.shape[0], block_rows):
        out[s:s + block_rows] = squared_euclidean(q[s:s + block_rows], g).cpu().numpy()
    return out


def knn_search_plain(features, k, metric="l2", block_rows=4096):
    """Plain PyTorch version of K8: for each block of ``block_rows`` rows,
    the distances (``squared_euclidean``) or the fp32 products against the
    whole set, then a stable sort of each row, keeping the first ``k``. A
    stable sort puts the lower index first on an exact tie, as ``lax.top_k``
    orders ties (``torch.topk`` does not promise an order). Runs where the
    tensor lies. Returns host (vals (N, k) float32, idx (N, k) int32)."""
    f = features.to(torch.float32)
    vals, idxs = [], []
    for s in range(0, f.shape[0], block_rows):
        q = f[s:s + block_rows]
        d = squared_euclidean(q, f) if metric == "l2" else matmul_fp32(q, f.T)
        v, i = torch.sort(d, dim=1, descending=metric == "ip", stable=True)
        vals.append(v[:, :k].cpu().numpy())
        idxs.append(i[:, :k].to(torch.int32).cpu().numpy())
    return np.concatenate(vals), np.concatenate(idxs)


def knn_topk_cuda(f, k, metric="l2"):
    """K8 on a CUDA (N, D) float32 tensor, any 1 <= k <= N: device (vals,
    idx)."""
    n, d = f.shape
    if not 1 <= k <= n:
        raise ValueError(f"knn_search takes 1 <= k <= N; got k = {k}, N = {n}")
    if d % 4:      # zero columns change no norm and no product
        f = torch.nn.functional.pad(f, (0, 4 - d % 4))
    f = f.contiguous()
    if f.data_ptr() % 16:
        f = f.clone()
    dev = f.device
    size = KNN_TOPK.scratch_size(n, k)
    norms = torch.empty(n, dtype=torch.float32, device=dev)
    part_key = torch.empty(size, dtype=torch.float32, device=dev)
    part_idx = torch.empty(size, dtype=torch.int32, device=dev)
    vals = torch.empty((n, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    KNN_TOPK(f.data_ptr(), n, f.shape[1], k, int(metric == "l2"), norms.data_ptr(),
             part_key.data_ptr(), part_idx.data_ptr(), vals.data_ptr(),
             idx.data_ptr(), device=dev)
    return vals, idx


def knn_search(features, k, metric="l2", device=None):
    """All-pairs k-NN of a feature set against itself (distance.py:160-190):
    the ``k`` nearest rows by squared L2 distance (``metric="l2"``,
    ascending) or the ``k`` largest inner products (``"ip"``), in (value,
    index) order, so self comes first (distance 0 / similarity 1 on
    L2-normalised rows) unless an exact duplicate has a lower index.

    ``features``: an (N, D) tensor, searched where it lies, or a host array,
    moved to ``device`` (default: the card; raises if there is none). On the
    card this is kernel K8, for any 1 <= k <= N (else ``ValueError``); on the
    CPU its plain version. Returns host (vals (N, k) float32, idx (N, k)
    int32)."""
    if metric not in ("l2", "ip"):
        raise ValueError(f"knn_search: unknown metric {metric!r}")
    f = _as_features(features, device)
    if f.dim() != 2:
        raise ValueError(f"knn_search takes (N, D) features, got {tuple(f.shape)}")
    if f.is_cuda:
        vals, idx = knn_topk_cuda(f, k, metric)
        return vals.cpu().numpy(), idx.cpu().numpy()
    if f.device.type != "cpu":
        raise ValueError(f"knn_search: unsupported device {f.device}")
    return knn_search_plain(f, k, metric)
