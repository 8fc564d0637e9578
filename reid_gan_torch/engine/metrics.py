"""CMC and mAP on the device, from features or from a host distance matrix,
under the three protocols of the reference (allshots, cuhk03, market1501);
and the classification accuracy.

Port of ``reid_gan_tpu/engine/metrics.py``: ``rank_metrics_features``
(metrics.py:282-352), the distance-matrix entry ``rank_metrics`` (:394-420)
with its driver ``_rank_metrics_jax`` (:355-392), their per-chunk rank pass
``_chunk_stats_jax`` (:213-259), ``cmc`` (:423-456), ``mean_ap``
(:459-466), ``accuracy`` (:549-560) and a copy of the host
``single_gallery_shot`` sampler ``_sgs_rank_metrics_numpy`` (:147-207).
For each chunk of queries the (chunk, n) distance block is
``ops.distance.squared_euclidean`` (a plain fp32 ``torch.matmul``, as the JAX
package leaves the product to XLA) and the rank statistics are kernel K3
(``rank_stats``): per query the tie-exact AP, the first-match CMC bin, the
number of valid matches and, for the all-shots CMC, the query's histogram
row, in the JAX backend's order (stable by distance, then gallery index);
``separate_camera_set`` drops the query's camera from the valid set. Only
the (topk,) histogram and two scalars leave the card.

Under a data mesh (JAX ``metrics.py:309-345``, where the chunk's rows are
sharded against the replicated gallery) the query chunks are dealt over the
ranks in turn, each rank ranks its chunks against the whole gallery with K3,
and the histograms, AP sums and valid counts are summed over the ranks.
"""

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import RANK_STATS
from ..ops.distance import squared_euclidean
from ..parallel.mesh import all_reduce_sum
from ..utils import to_numpy

RANK_STATS_MAX_N = 1 << 21   # K3 keeps a counter's two halves in 16 bits (csrc/rank_stats.cu)


def rank_stats_plain(d, qid, qcam, gid, gcam, separate_camera_set=False,
                     allshots_topk=0):
    """Plain PyTorch version of K3: the JAX backend's sort → mask → compact
    → cumsum pass (metrics.py:217-256), line for line.

    d: (q, n) fp32; qid/qcam: (q,) int; gid/gcam: (n,) int.
    Returns (ap (q,) fp32, first_bin (q,) int32, num_matches (q,) int32),
    and with ``allshots_topk`` > 0 also each query's all-shots histogram
    row, (q, allshots_topk) fp32: its j-th valid match adds 1 / |M| to bin
    (valid rank − j).
    """
    q, n = d.shape
    order = torch.sort(d, dim=1, stable=True).indices
    d_s = torch.gather(d, 1, order)
    g_id = gid[order]
    g_cam = gcam[order]
    match = g_id == qid[:, None]
    valid = (g_id != qid[:, None]) | (g_cam != qcam[:, None])
    if separate_camera_set:
        valid &= g_cam != qcam[:, None]
    vrank = torch.cumsum(valid, dim=1)
    vcols = torch.where(valid, vrank - 1, n)          # column n is dropped
    vcols_d = torch.where(valid, vrank - 1, n + 1)    # column n+1 is dropped
    comp_d = torch.full((q, n + 2), float("inf"), dtype=d.dtype, device=d.device)
    comp_d = comp_d.scatter_(1, vcols_d, d_s)[:, :n + 1]
    comp_y = torch.zeros((q, n + 1), dtype=torch.bool, device=d.device)
    comp_y = comp_y.scatter_(1, vcols, match)[:, :n]
    tps = torch.cumsum(comp_y, dim=1)
    num_matches = tps[:, -1]
    is_end = comp_d[:, 1:] != comp_d[:, :n]
    ar = torch.arange(n, device=d.device).expand(q, n)
    cand = torch.where(is_end, ar, n - 1)
    end_idx = torch.flip(torch.cummin(torch.flip(cand, [1]), dim=1).values, [1])
    prec_end = torch.gather(tps, 1, end_idx).to(torch.float32) / (
        end_idx.to(torch.float32) + 1.0)
    ap = torch.where(comp_y, prec_end, 0.0).sum(dim=1) / torch.clamp_min(
        num_matches, 1)
    first_bin = torch.argmax(comp_y.to(torch.int32), dim=1)
    out = (ap, first_bin.to(torch.int32), num_matches.to(torch.int32))
    if allshots_topk <= 0:
        return out
    bins = torch.where(comp_y, ar - (tps - 1), allshots_topk)
    w = torch.where(comp_y, 1.0 / torch.clamp_min(num_matches, 1)[:, None].to(
        torch.float32), 0.0)
    hist = torch.zeros((q, allshots_topk + 1), dtype=torch.float32, device=d.device)
    hist.scatter_add_(1, torch.clamp(bins, max=allshots_topk), w)
    return out + (hist[:, :allshots_topk],)


def _rank_stats_cuda(d, qid, qcam, gid, gcam, separate_camera_set, allshots_topk):
    q, n = d.shape
    if d.dtype != torch.float32 or not d.is_contiguous():
        raise ValueError("rank_stats takes a contiguous float32 (q, n) block")
    if n >= RANK_STATS_MAX_N:
        raise ValueError(f"rank_stats takes fewer than {RANK_STATS_MAX_N} gallery "
                         f"entries; got {n}")
    for name, t, size in (("qid", qid, q), ("qcam", qcam, q),
                          ("gid", gid, n), ("gcam", gcam, n)):
        if t.dtype != torch.int32 or t.device != d.device or \
                t.shape != (size,) or not t.is_contiguous():
            raise ValueError(f"rank_stats: {name} must be ({size},) contiguous "
                             f"int32 on {d.device}")
    ap = torch.empty(q, dtype=torch.float32, device=d.device)
    first_bin = torch.empty(q, dtype=torch.int32, device=d.device)
    num_matches = torch.empty(q, dtype=torch.int32, device=d.device)
    topk = max(int(allshots_topk), 0)
    hist = torch.empty((q, topk), dtype=torch.float32, device=d.device) if topk else None
    RANK_STATS(d.data_ptr(), qid.data_ptr(), qcam.data_ptr(), gid.data_ptr(),
               gcam.data_ptr(), q, n, int(bool(separate_camera_set)), ap.data_ptr(),
               first_bin.data_ptr(), num_matches.data_ptr(),
               hist.data_ptr() if topk else None, topk, device=d.device)
    out = (ap, first_bin, num_matches)
    return out + (hist,) if topk else out


def rank_stats(d, qid, qcam, gid, gcam, separate_camera_set=False, allshots_topk=0):
    """Per-query (AP, first-match bin, number of valid matches) of a distance
    block, and with ``allshots_topk`` > 0 each query's all-shots histogram
    row (kernel K3 on the card). ``separate_camera_set`` drops the query's
    camera from the valid set. A query with no valid match has AP 0, bin 0
    and a zero row, and is left out by the caller."""
    if d.is_cuda:
        return _rank_stats_cuda(d, qid, qcam, gid, gcam, separate_camera_set,
                                allshots_topk)
    if d.device.type != "cpu":
        raise ValueError(f"rank_stats: unsupported device {d.device}")
    return rank_stats_plain(d, qid, qcam, gid, gcam, separate_camera_set, allshots_topk)


def _default_ids_cams(m, n, query_ids, gallery_ids, query_cams, gallery_cams):
    if query_ids is None:
        query_ids = np.arange(m)
    if gallery_ids is None:
        gallery_ids = np.arange(n)
    if query_cams is None:
        query_cams = np.zeros(m, np.int32)
    if gallery_cams is None:
        gallery_cams = np.ones(n, np.int32)
    return (np.asarray(query_ids), np.asarray(gallery_ids),
            np.asarray(query_cams), np.asarray(gallery_cams))


def _rank_chunks(block, m, n, query_ids, gallery_ids, query_cams, gallery_cams,
                 topk, chunk, device, separate_camera_set=False, first_match_break=True,
                 mesh=None):
    """The chunk loop shared by both entries: ``block(s, e)`` gives the
    (e - s, n) device distance block of queries s..e, ranked by K3 (its
    plain version on the CPU) as it is: a short last chunk is not padded to
    ``chunk`` rows. The all-shots rows are summed in float64 in query order.
    Only the (topk,) histogram and two scalars leave the device. Under
    ``mesh`` rank r ranks chunks r, r + size, ... and the sums are the
    ranks'."""
    query_ids, gallery_ids, query_cams, gallery_cams = _default_ids_cams(
        m, n, query_ids, gallery_ids, query_cams, gallery_cams)
    gids = torch.as_tensor(np.asarray(gallery_ids, np.int32)).to(device)
    gcams = torch.as_tensor(np.asarray(gallery_cams, np.int32)).to(device)
    hist = torch.zeros(topk, dtype=torch.float64, device=device)
    ap_sum = torch.zeros((), dtype=torch.float64, device=device)
    valid_q = torch.zeros((), dtype=torch.int64, device=device)
    starts = range(0, m, chunk)
    if mesh is not None:
        starts = starts[mesh.rank::mesh.world_size]
    for s in starts:
        e = min(s + chunk, m)
        d = block(s, e)
        qid = np.asarray(query_ids[s:e], np.int32)
        qcam = np.asarray(query_cams[s:e], np.int32)
        stats = rank_stats(
            d.contiguous(), torch.as_tensor(qid).to(device),
            torch.as_tensor(qcam).to(device), gids, gcams, separate_camera_set,
            0 if first_match_break else topk)
        ap, first_bin, num_matches = stats[:3]
        has = num_matches > 0
        if first_match_break:
            bins = first_bin[has & (first_bin < topk)].to(torch.int64)
            hist += torch.bincount(bins, minlength=topk).to(torch.float64)
        else:
            hist += stats[3].to(torch.float64).sum(dim=0)
        ap_sum += torch.where(has, ap, 0.0).sum().to(torch.float64)
        valid_q += has.sum()
    if mesh is not None:
        sums = all_reduce_sum(mesh, torch.cat([hist, ap_sum[None],
                                               valid_q[None].to(torch.float64)]))
        hist, ap_sum, valid_q = sums[:topk], sums[topk], sums[topk + 1]
    valid_q = int(valid_q)
    if valid_q == 0:
        raise RuntimeError("No valid query")
    return hist.cpu().numpy().cumsum() / valid_q, float(ap_sum) / valid_q


def rank_metrics_features(query_feats, gallery_feats, query_ids=None,
                          gallery_ids=None, query_cams=None,
                          gallery_cams=None, topk=100, chunk=1024,
                          device=None, mesh=None):
    """Fused CMC (market1501: same-id-same-camera entries dropped, first
    match breaks) + mAP from (m, d) query and (n, d) gallery features, on
    ``device`` (default: the card; raises if there is none); no distance
    matrix leaves the device. Under ``mesh`` the ranks share the chunks.

    Returns (cmc (topk,) float64, mAP float). Raises if no query has a valid
    match."""
    device = resolve_device(device)
    qf = torch.as_tensor(np.asarray(query_feats, np.float32))
    gf = torch.as_tensor(np.asarray(gallery_feats, np.float32)).to(device)
    return _rank_chunks(lambda s, e: squared_euclidean(qf[s:e].to(device), gf),
                        qf.shape[0], gf.shape[0], query_ids, gallery_ids,
                        query_cams, gallery_cams, topk, chunk, device, mesh=mesh)


def rank_metrics(distmat, query_ids=None, gallery_ids=None, query_cams=None,
                 gallery_cams=None, topk=100, separate_camera_set=False,
                 first_match_break=True, chunk=1024, device=None):
    """The same CMC + mAP from a host (m, n) distance matrix
    (metrics.py:355-420): sent to ``device`` (default: the card) in
    ``chunk``-row blocks, each ranked by K3. ``first_match_break=False`` is
    the all-shots CMC; ``separate_camera_set`` drops the query's camera from
    the gallery. Returns (cmc (topk,) float64, mAP float)."""
    device = resolve_device(device)
    distmat = np.asarray(to_numpy(distmat), np.float32)
    m, n = distmat.shape
    return _rank_chunks(lambda s, e: torch.from_numpy(distmat[s:e]).to(device),
                        m, n, query_ids, gallery_ids, query_cams, gallery_cams,
                        topk, chunk, device, separate_camera_set, first_match_break)


def _sgs_rank_metrics_numpy(distmat, query_ids, gallery_ids, query_cams,
                            gallery_cams, topk, separate_camera_set,
                            repeat=10, seed=None, chunk=512):
    """The ``single_gallery_shot`` (cuhk03) CMC on the host, a copy of the
    JAX package's vectorised 10-repeat sampler (metrics.py:147-207): per
    query and per repeat, one gallery instance per gallery id is sampled
    from the valid set by a random-key argmax, and the all-shots bins of the
    sampled subset are accumulated with weight 1 / (matches · repeat). The
    same ``seed`` gives the JAX function's numbers."""
    m, n = distmat.shape
    rng = np.random.RandomState(seed)
    _, gidx_all = np.unique(gallery_ids, return_inverse=True)
    num_groups = int(gidx_all.max()) + 1
    ret = np.zeros(topk)
    valid_q = 0
    for s in range(0, m, chunk):
        e = min(s + chunk, m)
        d = distmat[s:e]
        qid, qcam = query_ids[s:e], query_cams[s:e]
        q = e - s
        order = np.argsort(d, axis=1)
        g_id = gallery_ids[order]
        g_cam = gallery_cams[order]
        gidx = gidx_all[order]
        match = g_id == qid[:, None]
        valid = (g_id != qid[:, None]) | (g_cam != qcam[:, None])
        if separate_camera_set:
            valid &= g_cam != qcam[:, None]
        has = (match & valid).any(axis=1)
        valid_q += int(has.sum())
        rows = np.broadcast_to(np.arange(q)[:, None], (q, n))
        for _ in range(repeat):
            u = np.where(valid, rng.rand(q, n), -1.0)
            best = np.full((q, num_groups), -2.0)
            np.maximum.at(best, (rows.ravel(), gidx.ravel()), u.ravel())
            sampled = valid & (u == best[rows, gidx]) & (u >= 0)
            vrank = np.cumsum(sampled, axis=1, dtype=np.int32)
            m_s = match & sampled
            tps = np.cumsum(m_s, axis=1, dtype=np.int32)
            nm = tps[:, -1]
            bins = (vrank - 1) - (tps - 1)
            ok = has & (nm > 0)
            w_row = np.divide(1.0, nm * repeat, where=ok, out=np.zeros(q))
            sel = m_s & ok[:, None] & (bins < topk)
            np.add.at(ret, bins[sel], np.broadcast_to(w_row[:, None], (q, n))[sel])
    if valid_q == 0:
        raise RuntimeError("No valid query")
    return ret.cumsum() / valid_q


def cmc(distmat, query_ids=None, gallery_ids=None, query_cams=None,
        gallery_cams=None, topk=100, separate_camera_set=False,
        single_gallery_shot=False, first_match_break=False, seed=None, device=None):
    """Cumulative Matching Characteristics under the reference's switches
    (metrics.py:423-456): the all-shots and market1501 curves through K3 on
    ``device`` (default: the card), the cuhk03 ``single_gallery_shot`` curve
    through the host sampler with ``seed``."""
    if single_gallery_shot:
        if first_match_break:
            # the reference's accumulator exceeds 1 in this combination
            # (ranking.py:60-66); no shipped protocol uses it
            raise ValueError(
                "single_gallery_shot=True with first_match_break=True is not "
                "a valid CMC protocol (the reference implementation's "
                "accumulator exceeds 1 in this combination)")
        distmat = np.asarray(to_numpy(distmat))
        m, n = distmat.shape
        query_ids, gallery_ids, query_cams, gallery_cams = _default_ids_cams(
            m, n, query_ids, gallery_ids, query_cams, gallery_cams)
        return _sgs_rank_metrics_numpy(
            distmat, query_ids, gallery_ids, query_cams, gallery_cams,
            topk=topk, separate_camera_set=separate_camera_set, seed=seed)
    curve, _ = rank_metrics(distmat, query_ids, gallery_ids, query_cams,
                            gallery_cams, topk=topk,
                            separate_camera_set=separate_camera_set,
                            first_match_break=first_match_break, device=device)
    return curve


def mean_ap(distmat, query_ids=None, gallery_ids=None, query_cams=None,
            gallery_cams=None, device=None):
    """mAP over the queries with a valid match (metrics.py:459-466)."""
    _, mAP = rank_metrics(distmat, query_ids, gallery_ids, query_cams,
                          gallery_cams, topk=1, device=device)
    return mAP


def accuracy(output, target, topk=(1,)):
    """Top-k precision of logits against integer targets (metrics.py:549-560;
    parity: FD/reid/evaluation_metrics/classification.py:6-19)."""
    output = to_numpy(output)
    target = to_numpy(target)
    pred = np.argsort(-output, axis=1)[:, :max(topk)]
    correct = pred == target[:, None]
    return [float(correct[:, :k].any(axis=1).mean()) for k in topk]
