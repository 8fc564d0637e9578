"""Port parity: distances and the fused rank metrics (kernel K3's plain
version) against the JAX package's ``rank_metrics_features`` and
``rank_metrics``, with and without exact ties and with a short last chunk;
and the sort-free counting forms that the CUDA kernel computes (the
formulas, and the bucketed form in rounds that its passes take), held
against the plain version on tie-heavy data."""

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
    chunk size that forces several chunks and a short last one: identical
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


def _bucketed(d, qid, qcam, gid, gcam, sep=False, topk=0, cap=64):
    """The bucketed counting form of csrc/rank_stats.cu, in numpy. Per row,
    in rounds of ``cap`` same-id entries in index order: the round's
    matches sorted by (distance, index); every valid entry at or below the
    farthest of them bucketed once by lower_bound on distance, each valid
    non-match also by (distance, index); prefix sums over the buckets give
    #{valid non-matches <= s_k} and the all-shots bins; #{matches <= s_k}
    comes from the list when one round holds every match, else from the
    matches' own buckets. The AP terms are summed in sorted order, rounds
    in turn; the first bin is the round's whose first match is smallest."""
    q, n = d.shape
    ap = np.zeros(q)
    first = np.zeros(q, np.int64)
    nm = np.zeros(q, np.int64)
    hist = np.zeros((q, topk), np.float32)
    cols = np.arange(n)
    for i in range(q):
        x = d[i]
        same = np.nonzero(gid == qid[i])[0]
        match = (gid == qid[i]) & (gcam != qcam[i])
        nonmatch = (gid != qid[i]) & ~(sep & (gcam == qcam[i]))
        nm[i] = match.sum()
        if not nm[i]:
            continue
        w = np.float32(1.0) / np.float32(nm[i])
        acc, best = 0.0, None
        for lo in range(0, len(same), cap):
            cand = same[lo:lo + cap]
            ms = cand[gcam[cand] != qcam[i]]
            if not len(ms):
                continue
            order = np.lexsort((ms, x[ms]))
            sd, sj = x[ms][order], ms[order]
            k = len(sd)
            near = x <= sd[-1]
            b = np.searchsorted(sd, x, side="left")            # #{s_k < x}
            n_k = np.cumsum(np.bincount(b[nonmatch & near], minlength=k))
            if len(same) > cap:
                m_k = np.cumsum(np.bincount(b[match & near], minlength=k))
            else:
                m_k = np.array([np.sum(sd <= s) for s in sd])
                assert np.array_equal(
                    m_k, np.cumsum(np.bincount(b[match & near], minlength=k)))
            for term in m_k / (n_k + m_k):
                acc += term
            before_last = (x < sd[-1]) | ((x == sd[-1]) & (cols < sj[-1]))
            lex = b + ((sd[None, :] == x[:, None]) & (sj[None, :] < cols[:, None])).sum(1)
            bins = np.cumsum(np.bincount(lex[nonmatch & before_last], minlength=k))
            if best is None or (sd[0], sj[0]) < best:
                best, first[i] = (sd[0], sj[0]), bins[0]
            for bk in bins:
                if bk < topk:
                    hist[i, bk] += w
        ap[i] = acc / nm[i]
    return ap, first, nm, hist


@pytest.mark.parametrize("cap", [64, 8], ids=["one_round", "rounds"])
@pytest.mark.parametrize("allshots", [False, True], ids=["first_match", "allshots"])
@pytest.mark.parametrize("sep", [False, True], ids=["same_cams", "separate_cams"])
def test_bucketed_counting_form_matches_plain_rank_stats(sep, allshots, cap):
    """K3's bucketed one-pass form equals the plain sort → compact → cumsum
    pass on tie-heavy data, in one round and in rounds of 8 same-id entries
    (about 30 a row here): match counts and first bins exactly, AP and the
    all-shots rows within 1e-6 (sums in another order)."""
    from reid_gan_torch.engine.metrics import rank_stats

    rng = np.random.RandomState(5 + sep + 2 * allshots)
    q, n, topk = 24, 120, 20
    d = rng.randint(0, 6, (q, n)).astype(np.float32)   # many exact ties
    qid, gid, qcam, gcam = _ids_cams(rng, q, n, num_ids=4)
    qid[0] = 99                                        # a query without matches
    d[1] = 2.0                                         # every valid entry tied
    ref = rank_stats(torch.from_numpy(d), *(torch.from_numpy(a.astype(np.int32))
                                            for a in (qid, qcam, gid, gcam)),
                     separate_camera_set=sep, allshots_topk=topk if allshots else 0)
    ap, first, nm, hist = _bucketed(d, qid, qcam, gid, gcam, sep, topk, cap)
    if cap == 8:
        assert (gid[None, :] == qid[1:, None]).sum(1).min() > 2 * cap
    np.testing.assert_array_equal(nm, ref[2].numpy())
    np.testing.assert_array_equal(first, ref[1].numpy())
    np.testing.assert_allclose(ap, ref[0].numpy(), atol=1e-6, rtol=0)
    if allshots:
        np.testing.assert_allclose(hist, ref[3].numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("sep,fmb", [(False, True), (True, False)],
                         ids=["market1501", "allshots_separate_cams"])
def test_rank_chunks_short_last_chunk_matches_jax(sep, fmb):
    """``rank_metrics`` over 20 queries in chunks of 7 (7, 7 and a short
    6, ranked unpadded) against JAX's jitted ``rank_metrics`` in one chunk:
    CMC and mAP within 1e-6."""
    from reid_gan_tpu.engine.metrics import rank_metrics as jax_rank
    from reid_gan_torch.engine.metrics import rank_metrics

    rng = np.random.RandomState(7 + sep)
    m, n = 20, 57
    d = rng.randint(0, 9, (m, n)).astype(np.float32)
    qid, gid, qcam, gcam = _ids_cams(rng, m, n, num_ids=5)
    kw = dict(topk=20, separate_camera_set=sep, first_match_break=fmb)
    cmc, mAP = rank_metrics(d, qid, gid, qcam, gcam, chunk=7, device="cpu", **kw)
    ref_cmc, ref_map = jax_rank(d, qid, gid, qcam, gcam, backend="jax", **kw)
    np.testing.assert_allclose(cmc, ref_cmc, atol=1e-6, rtol=0)
    assert abs(mAP - ref_map) <= 1e-6
