"""Port parity for the all-pairs kNN and the distance matrix: K8's plain
version (``knn_search`` on the CPU, ``knn_search_plain``) against the JAX
``knn_search`` for L2 and inner product, at N below k1, N across the
4096-row block edge and k = 1; exact duplicates for the tie order; and
``pairwise_distance`` against JAX."""

import numpy as np
import pytest
import torch

from reid_gan_tpu.ops.distance import knn_search as jax_knn_search
from reid_gan_tpu.ops.distance import pairwise_distance as jax_pairwise
from reid_gan_torch.ops.distance import knn_search, knn_search_plain, pairwise_distance

MARGIN = 1e-5


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads per test: the suite runs six files at once, and
    torch's default of one thread per core would crowd the others out."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _gaps(f, k):
    """Per row, the gaps between consecutive keys among its first k + 1
    neighbours, in float64, for both metrics (the inner product's keys are
    the products themselves). Returns (gaps, order) of the L2 and IP
    searches."""
    f = f.astype(np.float64)
    k = min(k, f.shape[0] - 1)
    prod = f @ f.T
    sq = np.sum(f * f, axis=1)
    out = []
    for key in (sq[:, None] + sq[None, :] - 2 * prod, -prod):
        part = np.argpartition(key, k, axis=1)[:, :k + 1]
        vals = np.take_along_axis(key, part, axis=1)
        order = np.take_along_axis(part, np.argsort(vals, axis=1), axis=1)
        vals = np.take_along_axis(key, order, axis=1)
        out.append((np.diff(vals, axis=1), order))
    return out


def tie_free(rng, n, d, k, margin=MARGIN):
    """Unit rows from ``rng`` with every row's first k + 1 keys at least
    ``margin`` apart under both metrics: points that sit in a near-tie are
    dropped (a drop only widens the other rows' gaps) until none is left.
    Draws ``n`` points; returns what survives."""
    f = rng.randn(n, d)
    f = (f / np.linalg.norm(f, axis=1, keepdims=True)).astype(np.float32)
    while True:
        bad = set()
        for gaps, order in _gaps(f, k):
            rows, cols = np.nonzero(gaps <= margin)
            bad.update(order[rows, cols + 1].tolist())
        if not bad:
            return f
        f = np.delete(f, sorted(bad), axis=0)


@pytest.mark.parametrize("n,d,k", [
    (20, 3, 30),       # N < k1: k = min(k1, N), the whole row
    (4400, 8, 5),      # across the 4096-row block edge
    (500, 8, 1),       # k = 1: self only
])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_knn_search_plain_matches_jax(n, d, k, metric):
    """Tie-free data (margin > 1e-5 between consecutive neighbours, checked
    in float64): indices equal, values within 1e-5 (fp32 products summed in
    other orders)."""
    f = tie_free(np.random.RandomState(n + d), n, d, k)
    k = min(k, f.shape[0])
    if n > 4096:
        assert f.shape[0] > 4096
    for gaps, _ in _gaps(f, k):
        assert (gaps > MARGIN).all()
    ref_v, ref_i = (np.asarray(a) for a in jax_knn_search(f, k, metric=metric))
    vals, idx = knn_search(f, k, metric=metric, device="cpu")
    assert vals.dtype == np.float32 and idx.dtype == np.int32
    assert vals.shape == idx.shape == (f.shape[0], k)
    np.testing.assert_array_equal(idx, ref_i)
    np.testing.assert_allclose(vals, ref_v, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(idx[:, 0], np.arange(f.shape[0]))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_knn_search_orders_exact_ties_as_lax_top_k(metric):
    """Exact duplicate rows (each distinct row three times, at scattered
    positions): the lower index first on every tie, as ``lax.top_k``, and
    the same values. The distinct rows keep a 1e-5 margin."""
    rng = np.random.RandomState(7)
    base = tie_free(rng, 70, 4, 20)[:60]
    f = base[rng.permutation(np.repeat(np.arange(60), 3))]
    k = 20
    ref_v, ref_i = (np.asarray(a) for a in jax_knn_search(f, k, metric=metric))
    vals, idx = knn_search_plain(torch.from_numpy(f), k, metric)
    assert (ref_v[:, 1:] == ref_v[:, :-1]).sum() >= 2 * f.shape[0]
    np.testing.assert_array_equal(idx, ref_i)
    np.testing.assert_allclose(vals, ref_v, rtol=0, atol=1e-5)


def test_knn_search_raises_on_a_bad_metric():
    with pytest.raises(ValueError, match="metric"):
        knn_search(np.eye(4, dtype=np.float32), 2, metric="cos", device="cpu")


@pytest.mark.parametrize("with_gallery", [True, False])
def test_pairwise_distance_matches_jax(with_gallery):
    """Row blocks of 128 against the JAX blocks: within 1e-5."""
    rng = np.random.RandomState(3)
    q = rng.randn(300, 64).astype(np.float32) * 0.2
    g = rng.randn(200, 64).astype(np.float32) * 0.2 if with_gallery else None
    ref = np.asarray(jax_pairwise(q, g))
    got = pairwise_distance(q, g, block_rows=128, device="cpu")
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
