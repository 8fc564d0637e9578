"""Feature extraction + evaluation (port of
``reid_gan_tpu/engine/evaluators.py``; parity: CC/clustercontrast/
evaluators.py Evaluator, extract_features, evaluate_all).

The host ships raw uint8 batches; on the card the eval transform (K1), the
backbone (cuDNN), the fused GeM/feat_bn/L2 head (K2) and, per query chunk,
the distance product (cuBLAS) and the rank pass (K3) run without a host
round trip. With re-ranking, the three distance matrices come to the host
for the k-reciprocal re-ranking (host C++), and the rank pass (K3) runs on
the re-ranked matrix, sent back in chunks.

Under a data mesh (JAX ``evaluators.py:29-77``, ``:139-212``) each rank runs
K1 → encoder → K2 on its slice of each batch (the loader pads the last one,
``DataLoader(shard=)``), and the features are gathered in rank order and
trimmed, so every rank holds all of them; the rank pass deals the query
chunks over the ranks (``metrics.py``). Re-ranking is host-bound: rank 0
computes the distance matrices, the re-ranking and both rank passes, and
broadcasts the result.
"""

import time
from collections import OrderedDict

import numpy as np
import torch

from ..ops.distance import pairwise_distance as _pairwise
from ..ops.jaccard import re_ranking
from ..ops.transforms import eval_transform
from ..parallel.mesh import all_gather_rows, broadcast_object, is_main, mesh_device
from ..utils import AverageMeter
from .metrics import rank_metrics, rank_metrics_features


class FeatureExtractor:
    """Eval forward: uint8 staging batch → L2-normalised features.

    The model is moved to ``device`` (default: the card; raises if there is
    none) in channels_last memory and run in eval mode (each batch sets it,
    as a trainer may share the model). The staged batch is
    normalised and rounded to ``dtype`` (default bf16, as the JAX extractor
    rounds its input, evaluators.py:47), then cast to the model's parameter
    dtype. With ``extra_features`` the model runs its ``test_all`` forward
    and each image also gets its GAN map's spatial mean in fp32 (a plain
    ``torch.mean``, as the JAX extractor leaves it to XLA,
    evaluators.py:48-56). With ``mesh`` it runs on the rank's card and
    rows (the module's docstring).
    """

    def __init__(self, model, height=256, width=128, batch_size=256,
                 device=None, dtype=torch.bfloat16, extra_features=False, mesh=None):
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        self.model = model.to(self.device, memory_format=torch.channels_last).eval()
        self.param_dtype = next(self.model.parameters()).dtype
        self.height, self.width = height, width
        self.batch_size = batch_size
        self.dtype = dtype
        self.extra = extra_features

    def dispatch(self, img_u8, n=None):
        """Enqueue the forward of a host (B, H, W, 3) uint8 batch and return
        the device features (with ``extra_features``, the pair of features
        and pooled GAN features) and B, without waiting for the card. Under
        a mesh ``img_u8`` is the rank's rows of a batch of ``n``, and the
        features are every rank's, gathered and trimmed to ``n``."""
        x = torch.from_numpy(np.ascontiguousarray(img_u8)).to(self.device)
        self.model.eval()
        with torch.inference_mode():
            x = eval_transform(x, self.height, self.width, self.dtype).to(self.param_dtype)
            if not self.extra:
                out = self.model(x)
            else:
                t = self.model(x, test_all=True)
                out = (t["feat"], t["gan_feat"].float().mean(dim=(2, 3)))
            if self.mesh is None:
                return out, img_u8.shape[0]
            n = img_u8.shape[0] * self.mesh.world_size if n is None else n
            if not self.extra:
                return all_gather_rows(self.mesh, out, n), n
            return tuple(all_gather_rows(self.mesh, t, n) for t in out), n

    def __call__(self, img_u8):
        out, _ = self.dispatch(img_u8)
        if self.extra:
            return tuple(t.float().cpu().numpy() for t in out)
        return out.float().cpu().numpy()


def extract_features(extractor, data_loader, print_freq=50, max_pending=8):
    """Run the extractor over a loader; returns OrderedDicts fname → feature
    and fname → pid, with an ``extra_features`` extractor fname → feature,
    fname → pooled GAN feature and fname → pid (parity: evaluators.py:
    96-135).

    Batches are dispatched without a per-batch host sync, so the card runs
    ahead while the loader stages the next batch. At most ``max_pending``
    batches of device output stay live: once the window is full, each
    dispatch drains the oldest batch to the host."""
    batch_time = AverageMeter()
    data_time = AverageMeter()
    features = OrderedDict()
    gan_features = OrderedDict()
    labels = OrderedDict()
    pending = []
    extra = getattr(extractor, "extra", False)

    def drain_one():
        out, fnames = pending.pop(0)
        feats = (out[0] if extra else out).float().cpu().numpy()
        gans = out[1].cpu().numpy() if extra else None
        for j, fname in enumerate(fnames):
            features[fname] = feats[j]
            if extra:
                gan_features[fname] = gans[j]

    end = time.time()
    for i, batch in enumerate(data_loader):
        data_time.update(time.time() - end)
        out, _ = extractor.dispatch(batch["img"], len(batch["fname"]))
        pending.append((out, batch["fname"]))
        if len(pending) >= max_pending:
            drain_one()
        for fname, pid in zip(batch["fname"], batch["pid"]):
            labels[fname] = int(pid)
        batch_time.update(time.time() - end)
        end = time.time()
        if (i + 1) % print_freq == 0:
            print(f"Extract Features: [{i + 1}]\t"
                  f"Time {batch_time.val:.3f} ({batch_time.avg:.3f})\t"
                  f"Data {data_time.val:.3f} ({data_time.avg:.3f})")
    while pending:
        drain_one()
    if extra:
        return features, gan_features, labels
    return features, labels


def pairwise_distance(features, query, gallery, device=None):
    """(distmat, x, y) from the fname-keyed feature dict (evaluators.py:
    139-148); the host distance matrix is computed in row blocks on
    ``device`` (default: the card)."""
    x = np.stack([features[f] for f, _, _ in query])
    y = np.stack([features[f] for f, _, _ in gallery])
    return _pairwise(x, y, device=device), x, y


def _print_scores(scores, mAP, cmc_topk, cmc_flag):
    print("Mean AP: {:4.1%}".format(mAP))
    if not cmc_flag:
        return mAP
    print("CMC Scores:")
    for k in cmc_topk:
        print("  top-{:<4}{:12.1%}".format(k, scores[k - 1]))
    return scores, mAP


def evaluate_all(distmat, query, gallery, cmc_topk=(1, 5, 10), cmc_flag=False,
                 device=None):
    """mAP + market1501 CMC of a host (m, n) distance matrix
    (evaluators.py:151-171), ranked on ``device`` (default: the card)."""
    scores, mAP = rank_metrics(
        distmat, [pid for _, pid, _ in query], [pid for _, pid, _ in gallery],
        [cam for _, _, cam in query], [cam for _, _, cam in gallery], device=device)
    return _print_scores(scores, mAP, cmc_topk, cmc_flag)


def evaluate_all_features(x, y, query, gallery, cmc_topk=(1, 5, 10),
                          cmc_flag=False, device=None, mesh=None):
    """mAP + market1501 CMC from query features ``x`` and gallery features
    ``y`` on ``device`` (default: the card; raises if there is none); the
    (m, n) distance matrix never leaves the device. Under ``mesh`` the query
    chunks are dealt over the ranks."""
    scores, mAP = rank_metrics_features(
        x, y, [pid for _, pid, _ in query], [pid for _, pid, _ in gallery],
        [cam for _, _, cam in query], [cam for _, _, cam in gallery],
        device=device, mesh=mesh)
    return _print_scores(scores, mAP, cmc_topk, cmc_flag)


class Evaluator:
    """Parity: CC/clustercontrast/evaluators.py:125-142."""

    def __init__(self, extractor):
        self.extractor = extractor

    def evaluate(self, data_loader, query, gallery, cmc_flag=False, rerank=False):
        """(evaluators.py:199-214) Without ``rerank`` no host distance
        matrix exists; with it, the metrics before and after re-ranking.
        Under the extractor's mesh, ``data_loader`` is sharded over it."""
        device = self.extractor.device
        mesh = getattr(self.extractor, "mesh", None)
        features = extract_features(self.extractor, data_loader)[0]
        if not rerank:
            x = np.stack([features[f] for f, _, _ in query])
            y = np.stack([features[f] for f, _, _ in gallery])
            return evaluate_all_features(x, y, query, gallery, cmc_flag=cmc_flag,
                                         device=device, mesh=mesh)
        if mesh is not None:
            out = _rerank(features, query, gallery, cmc_flag, device) \
                if is_main(mesh) else None
            return broadcast_object(mesh, out)
        return _rerank(features, query, gallery, cmc_flag, device)


def _rerank(features, query, gallery, cmc_flag, device):
    """The metrics of the plain distance matrix, then of the re-ranked one
    (evaluators.py:205-212)."""
    distmat, _, _ = pairwise_distance(features, query, gallery, device)
    evaluate_all(distmat, query, gallery, cmc_flag=cmc_flag, device=device)
    print("Applying person re-ranking ...")
    distmat_qq, _, _ = pairwise_distance(features, query, query, device)
    distmat_gg, _, _ = pairwise_distance(features, gallery, gallery, device)
    distmat = re_ranking(distmat, distmat_qq, distmat_gg)
    return evaluate_all(distmat, query, gallery, cmc_flag=cmc_flag, device=device)
