"""Port parity: distances and the fused rank metrics (kernel K3's plain
version) against the JAX package's ``rank_metrics_features``, with and
without exact ties; and the sort-free counting form that the CUDA kernel
computes, held against the plain version on tie-heavy data."""

import numpy as np
import pytest
import torch


def _ids_cams(rng, m, n, num_ids=7, num_cams=3):
    return (rng.randint(0, num_ids, m), rng.randint(0, num_ids, n),
            rng.randint(0, num_cams, m), rng.randint(0, num_cams, n))


def _features(rng, m, n, ties):
    if not ties:
        return (rng.randn(m, 16).astype(np.float32),
                rng.randn(n, 16).astype(np.float32))
    # half-integer coordinates: every product and distance is exact in fp32
    # in any summation order, and duplicated gallery rows tie exactly
    qf = (rng.randint(-2, 3, (m, 8)) * 0.5).astype(np.float32)
    gf = (rng.randint(-2, 3, (n, 8)) * 0.5).astype(np.float32)
    gf[1::3] = gf[0::3][:len(gf[1::3])]
    return qf, gf


def test_squared_euclidean_matches_jax():
    """fp32 on both sides; rtol 1e-5 / atol 1e-5 for cancellation near 0."""
    from reid_gan_tpu.ops.distance import squared_euclidean as jax_sq
    from reid_gan_torch.ops.distance import squared_euclidean

    rng = np.random.RandomState(0)
    x, y = rng.randn(9, 32).astype(np.float32), rng.randn(13, 32).astype(np.float32)
    ref = np.asarray(jax_sq(x, y))
    out = squared_euclidean(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "exact_ties"])
def test_rank_metrics_features_matches_jax(ties):
    """Same features, ids and cams through both implementations, with a
    chunk size that forces several chunks and sentinel padding: identical
    CMC and mAP within 1e-6 (fp32 AP sums in different orders)."""
    from reid_gan_tpu.engine.metrics import rank_metrics_features as jax_rank
    from reid_gan_torch.engine.metrics import rank_metrics_features

    rng = np.random.RandomState(1 + ties)
    m, n = 37, 101
    qf, gf = _features(rng, m, n, ties)
    qid, gid, qcam, gcam = _ids_cams(rng, m, n)
    ref_cmc, ref_map = jax_rank(qf, gf, qid, gid, qcam, gcam, chunk=16)
    cmc, mAP = rank_metrics_features(qf, gf, qid, gid, qcam, gcam, chunk=16,
                                     device="cpu")
    assert cmc.shape == (100,)
    np.testing.assert_allclose(cmc, ref_cmc, atol=1e-6, rtol=0)
    assert abs(mAP - ref_map) <= 1e-6


def _sort_free(d, qid, qcam, gid, gcam):
    """The counting form of csrc/rank_stats.cu, in numpy."""
    q, n = d.shape
    ap = np.zeros(q)
    first = np.zeros(q, np.int64)
    nm = np.zeros(q, np.int64)
    for i in range(q):
        valid = (gid != qid[i]) | (gcam != qcam[i])
        vmatch = (gid == qid[i]) & (gcam != qcam[i])
        js = np.nonzero(vmatch)[0]
        nm[i] = len(js)
        if not len(js):
            continue
        terms = [np.sum(vmatch & (d[i] <= d[i, j])) / np.sum(valid & (d[i] <= d[i, j]))
                 for j in js]
        ap[i] = np.sum(terms) / len(js)
        jstar = min(js, key=lambda j: (d[i, j], j))
        before = (d[i] < d[i, jstar]) | ((d[i] == d[i, jstar]) & (np.arange(n) < jstar))
        first[i] = np.sum(valid & before)
    return ap, first, nm


def test_sort_free_counting_form_matches_plain_rank_stats():
    """The kernel's sort-free AP / first-bin formulas equal the plain sort
    → compact → cumsum pass per query on data full of exact ties (AP within
    1e-6, bins and match counts exactly)."""
    from reid_gan_torch.engine.metrics import rank_stats

    rng = np.random.RandomState(3)
    q, n = 24, 60
    d = rng.randint(0, 6, (q, n)).astype(np.float32)   # many exact ties
    qid, gid, qcam, gcam = _ids_cams(rng, q, n, num_ids=4)
    qid[0] = 99                                        # a query without matches
    ap, first, nm = rank_stats(torch.from_numpy(d), *(torch.from_numpy(a.astype(np.int32))
                                                      for a in (qid, qcam, gid, gcam)))
    ref_ap, ref_first, ref_nm = _sort_free(d, qid, qcam, gid, gcam)
    np.testing.assert_array_equal(nm.numpy(), ref_nm)
    np.testing.assert_array_equal(first.numpy(), ref_first)
    np.testing.assert_allclose(ap.numpy(), ref_ap, atol=1e-6, rtol=0)
    assert nm[0] == 0 and ap[0] == 0 and first[0] == 0
