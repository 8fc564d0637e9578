"""The port's own build of the host C++ (``reid_gan_torch.native``) against
the JAX package's (``reid_gan_tpu.native``) on the same inputs, and the
port's python paths against its native ones: DBSCAN, the k-reciprocal V,
the Jaccard min-sum, the re-ranking and Infomap."""

import numpy as np
import pytest
from scipy.spatial.distance import cdist

from reid_gan_tpu import native as jax_native
from reid_gan_torch import native


def _clustered(rng, n=300, d=32, k=12, spread=0.3):
    centers = rng.randn(k, d)
    f = centers[rng.randint(k, size=n)] + spread * rng.randn(n, d)
    return (f / np.linalg.norm(f, axis=1, keepdims=True)).astype(np.float32)


def _rank(f, width):
    d = cdist(f, f, "sqeuclidean")
    return np.argsort(d, axis=1, kind="stable")[:, :width].astype(np.int32)


def test_the_library_builds_under_a_source_hash():
    lib = native.ensure_built()
    assert native.ensure_built() is lib
    path = native._library_path()
    assert path.startswith(native.BUILD_DIR) and path.endswith(".so")


def test_dbscan_native_matches_jax_native_and_python():
    from reid_gan_torch.clustering.dbscan import dbscan

    rng = np.random.RandomState(0)
    pts = np.concatenate([rng.randn(30, 4) * 0.05 + c for c in (0, 2, 4)]
                         + [rng.rand(10, 4) * 6]).astype(np.float32)
    dist = cdist(pts, pts).astype(np.float32)
    got = native.dbscan_native(dist, eps=0.4, min_samples=4)
    np.testing.assert_array_equal(got, jax_native.dbscan_native(dist, 0.4, 4))
    np.testing.assert_array_equal(got, dbscan(dist, eps=0.4, min_samples=4, native=False))
    assert got.max() == 2 and (got == -1).any()


@pytest.mark.parametrize("k1,k2", [(20, 6), (12, 1)])
def test_kreciprocal_v_and_jaccard_match_jax_native(k1, k2):
    """Padded rows of V: idx and cnt equal, w within 1e-6; the min-sum
    Jaccard within 1e-6."""
    f = _clustered(np.random.RandomState(k1))
    rank = _rank(f, k1)
    got = native.kreciprocal_v_native(rank, f, k1, k2)
    ref = jax_native.kreciprocal_v_native(rank, f, k1, k2)
    idx, w, cnt = got
    np.testing.assert_array_equal(cnt, ref[2])
    mask = np.arange(idx.shape[1])[None, :] < cnt[:, None]
    np.testing.assert_array_equal(idx[mask], ref[0][mask])
    np.testing.assert_allclose(w[mask], ref[1][mask], rtol=0, atol=1e-6)
    np.testing.assert_allclose(native.jaccard_minsum_rows_native(*got),
                               jax_native.jaccard_minsum_rows_native(*ref),
                               rtol=0, atol=1e-6)


def test_kreciprocal_v_dist_and_dense_minsum_match_jax_native():
    rng = np.random.RandomState(3)
    f = _clustered(rng, n=120)
    dist = cdist(f, f, "sqeuclidean").astype(np.float32)
    rank = _rank(f, 21)
    got = native.kreciprocal_v_dist_native(rank, dist, 20, 6)
    ref = jax_native.kreciprocal_v_dist_native(rank, dist, 20, 6)
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_allclose(native.jaccard_minsum_rows_native(*got, query_num=30),
                               jax_native.jaccard_minsum_rows_native(*ref, query_num=30),
                               rtol=0, atol=1e-6)
    V = rng.rand(50, 50).astype(np.float32)
    V[V < 0.8] = 0.0
    np.testing.assert_allclose(native.jaccard_minsum_native(V, query_num=7),
                               jax_native.jaccard_minsum_native(V, query_num=7),
                               rtol=0, atol=1e-6)


def test_infomap_matches_jax_native_at_the_same_seed():
    rng = np.random.RandomState(5)
    n, per = 100, 25
    src, dst = np.nonzero((rng.rand(n, n) < np.where(
        np.arange(n)[:, None] // per == np.arange(n)[None] // per, 0.5, 0.01))
        & ~np.eye(n, dtype=bool))
    w = rng.rand(src.size).astype(np.float32) + 0.5
    for seed in (0, 3):
        labels, k = native.infomap_native(src, dst, w, n, seed=seed)
        ref_labels, ref_k = jax_native.infomap_native(src, dst, w, n, seed=seed)
        np.testing.assert_array_equal(labels, ref_labels)
        assert k == ref_k


def test_python_paths_match_native_paths():
    """The plain (per-row python) Jaccard and re-ranking against the native
    ones (tests/test_native.py's pairs): within 2e-5."""
    from reid_gan_torch.ops.jaccard import _min_sum_jaccard, jaccard_from_rank, re_ranking

    rng = np.random.RandomState(9)
    f = _clustered(rng, n=160)
    for k1, k2 in ((20, 6), (12, 1)):
        rank = _rank(f, k1)
        np.testing.assert_allclose(jaccard_from_rank(rank, f, k1, k2),
                                   jaccard_from_rank(rank, f, k1, k2, native=False),
                                   rtol=0, atol=2e-5)
    q, g = f[:40], f[40:]

    def d(a, b):
        return cdist(a, b, "sqeuclidean").astype(np.float32)

    args = (d(q, g), d(q, q), d(g, g))
    for k1, k2 in ((20, 6), (10, 1)):
        np.testing.assert_allclose(re_ranking(*args, k1=k1, k2=k2),
                                   re_ranking(*args, k1=k1, k2=k2, native=False),
                                   rtol=0, atol=2e-5)
    V = rng.rand(40, 40).astype(np.float32)
    V[V < 0.8] = 0.0
    V /= V.sum(1, keepdims=True) + 1e-12      # rows of V are distributions
    np.testing.assert_allclose(native.jaccard_minsum_native(V), _min_sum_jaccard(V),
                               rtol=0, atol=1e-5)


def test_re_ranking_matches_jax():
    from reid_gan_tpu.ops.jaccard import re_ranking as jax_re_ranking
    from reid_gan_torch.ops.jaccard import re_ranking

    f = _clustered(np.random.RandomState(11), n=150)
    q, g = f[:30], f[30:]
    args = [cdist(a, b, "sqeuclidean").astype(np.float32)
            for a, b in ((q, g), (q, q), (g, g))]
    np.testing.assert_allclose(re_ranking(*args), jax_re_ranking(*args, native=True),
                               rtol=0, atol=1e-6)
