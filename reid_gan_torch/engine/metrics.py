"""CMC (market1501 protocol) and mAP on the device, from features or from a
host distance matrix.

Port of ``reid_gan_tpu/engine/metrics.py::rank_metrics_features``
(metrics.py:282-352), of the distance-matrix entry ``rank_metrics``
(:394-420) and of their per-chunk rank pass ``_chunk_stats_jax``
(:213-259). For each chunk of queries the (chunk, n) distance block is
``ops.distance.squared_euclidean`` (a plain fp32 ``torch.matmul``, as the JAX
package leaves the product to XLA) and the rank statistics are kernel K3
(``rank_stats``): per query the tie-exact AP, the first-match CMC bin and the
number of valid matches, in the JAX backend's order (stable by distance, then
gallery index). Only the (topk,) histogram and two scalars leave the card.
"""

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import RANK_STATS
from ..ops.distance import squared_euclidean


def rank_stats_plain(d, qid, qcam, gid, gcam):
    """Plain PyTorch version of K3: the JAX backend's sort → mask → compact
    → cumsum pass (metrics.py:217-244), line for line.

    d: (q, n) fp32; qid/qcam: (q,) int; gid/gcam: (n,) int.
    Returns (ap (q,) fp32, first_bin (q,) int32, num_matches (q,) int32).
    """
    q, n = d.shape
    order = torch.sort(d, dim=1, stable=True).indices
    d_s = torch.gather(d, 1, order)
    g_id = gid[order]
    g_cam = gcam[order]
    match = g_id == qid[:, None]
    valid = (g_id != qid[:, None]) | (g_cam != qcam[:, None])
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
    return ap, first_bin.to(torch.int32), num_matches.to(torch.int32)


def _rank_stats_cuda(d, qid, qcam, gid, gcam):
    q, n = d.shape
    if d.dtype != torch.float32 or not d.is_contiguous():
        raise ValueError("rank_stats takes a contiguous float32 (q, n) block")
    for name, t, size in (("qid", qid, q), ("qcam", qcam, q),
                          ("gid", gid, n), ("gcam", gcam, n)):
        if t.dtype != torch.int32 or t.device != d.device or \
                t.shape != (size,) or not t.is_contiguous():
            raise ValueError(f"rank_stats: {name} must be ({size},) contiguous "
                             f"int32 on {d.device}")
    ap = torch.empty(q, dtype=torch.float32, device=d.device)
    first_bin = torch.empty(q, dtype=torch.int32, device=d.device)
    num_matches = torch.empty(q, dtype=torch.int32, device=d.device)
    RANK_STATS(d.data_ptr(), qid.data_ptr(), qcam.data_ptr(), gid.data_ptr(),
               gcam.data_ptr(), q, n, ap.data_ptr(), first_bin.data_ptr(),
               num_matches.data_ptr(), device=d.device)
    return ap, first_bin, num_matches


def rank_stats(d, qid, qcam, gid, gcam):
    """Per-query (AP, first-match bin, number of valid matches) of a distance
    block (kernel K3 on the card). A query with no valid match has AP 0 and
    bin 0 and is left out by the caller."""
    if d.is_cuda:
        return _rank_stats_cuda(d, qid, qcam, gid, gcam)
    if d.device.type != "cpu":
        raise ValueError(f"rank_stats: unsupported device {d.device}")
    return rank_stats_plain(d, qid, qcam, gid, gcam)


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
                 topk, chunk, device):
    """The chunk loop shared by both entries: ``block(s, e)`` gives the
    (e - s, n) device distance block of queries s..e; each is padded to
    ``chunk`` rows and ranked by K3 (its plain version on the CPU). Only the
    (topk,) histogram and two scalars leave the device."""
    query_ids, gallery_ids, query_cams, gallery_cams = _default_ids_cams(
        m, n, query_ids, gallery_ids, query_cams, gallery_cams)
    gids = torch.as_tensor(np.asarray(gallery_ids, np.int32)).to(device)
    gcams = torch.as_tensor(np.asarray(gallery_cams, np.int32)).to(device)
    hist = torch.zeros(topk, dtype=torch.float64, device=device)
    ap_sum = torch.zeros((), dtype=torch.float64, device=device)
    valid_q = torch.zeros((), dtype=torch.int64, device=device)
    for s in range(0, m, chunk):
        e = min(s + chunk, m)
        d = block(s, e)
        qid = np.asarray(query_ids[s:e], np.int32)
        qcam = np.asarray(query_cams[s:e], np.int32)
        if e - s < chunk:      # pad to the fixed chunk shape
            pad = chunk - (e - s)
            d = torch.nn.functional.pad(d, (0, 0, 0, pad))
            # int32 min can never be a real gallery id/cam → padded rows
            # have zero matches and drop out via the has-mask
            sentinel = np.iinfo(np.int32).min
            qid = np.pad(qid, (0, pad), constant_values=sentinel)
            qcam = np.pad(qcam, (0, pad), constant_values=sentinel)
        ap, first_bin, num_matches = rank_stats(
            d.contiguous(), torch.as_tensor(qid).to(device),
            torch.as_tensor(qcam).to(device), gids, gcams)
        has = num_matches > 0
        bins = first_bin[has & (first_bin < topk)].to(torch.int64)
        hist += torch.bincount(bins, minlength=topk).to(torch.float64)
        ap_sum += torch.where(has, ap, 0.0).sum().to(torch.float64)
        valid_q += has.sum()
    valid_q = int(valid_q)
    if valid_q == 0:
        raise RuntimeError("No valid query")
    return hist.cpu().numpy().cumsum() / valid_q, float(ap_sum) / valid_q


def rank_metrics_features(query_feats, gallery_feats, query_ids=None,
                          gallery_ids=None, query_cams=None,
                          gallery_cams=None, topk=100, chunk=1024,
                          device=None):
    """Fused CMC (market1501: same-id-same-camera entries dropped, first
    match breaks) + mAP from (m, d) query and (n, d) gallery features, on
    ``device`` (default: the card; raises if there is none); no distance
    matrix leaves the device.

    Returns (cmc (topk,) float64, mAP float). Raises if no query has a valid
    match."""
    device = resolve_device(device)
    qf = torch.as_tensor(np.asarray(query_feats, np.float32))
    gf = torch.as_tensor(np.asarray(gallery_feats, np.float32)).to(device)
    return _rank_chunks(lambda s, e: squared_euclidean(qf[s:e].to(device), gf),
                        qf.shape[0], gf.shape[0], query_ids, gallery_ids,
                        query_cams, gallery_cams, topk, chunk, device)


def rank_metrics(distmat, query_ids=None, gallery_ids=None, query_cams=None,
                 gallery_cams=None, topk=100, chunk=1024, device=None):
    """The same CMC + mAP from a host (m, n) distance matrix
    (metrics.py:394-420, first_match_break and no separate camera set, as
    the evaluators call it): sent to ``device`` (default: the card) in
    ``chunk``-row blocks, each ranked by K3."""
    device = resolve_device(device)
    distmat = np.asarray(distmat, np.float32)
    m, n = distmat.shape
    return _rank_chunks(lambda s, e: torch.from_numpy(distmat[s:e]).to(device),
                        m, n, query_ids, gallery_ids, query_cams, gallery_cams,
                        topk, chunk, device)
