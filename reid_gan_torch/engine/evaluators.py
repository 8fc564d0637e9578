"""Feature extraction + evaluation (port of
``reid_gan_tpu/engine/evaluators.py``; parity: CC/clustercontrast/
evaluators.py Evaluator, extract_features, evaluate_all).

The host ships raw uint8 batches; on the card the eval transform (K1), the
backbone (cuDNN), the fused GeM/feat_bn/L2 head (K2) and, per query chunk,
the distance product (cuBLAS) and the rank pass (K3) run without a host
round trip. Re-ranking is not ported yet.
"""

import time
from collections import OrderedDict

import numpy as np
import torch

from ..device import resolve_device
from ..ops.transforms import eval_transform
from ..utils import AverageMeter
from .metrics import rank_metrics_features


class FeatureExtractor:
    """Eval forward: uint8 staging batch → L2-normalised features.

    The model is moved to ``device`` (default: the card; raises if there is
    none) in channels_last memory and put in eval mode. The staged batch is
    normalised and rounded to ``dtype`` (default bf16, as the JAX extractor
    rounds its input, evaluators.py:47), then cast to the model's parameter
    dtype.
    """

    def __init__(self, model, height=256, width=128, batch_size=256,
                 device=None, dtype=torch.bfloat16):
        self.device = resolve_device(device)
        self.model = model.to(self.device, memory_format=torch.channels_last).eval()
        self.param_dtype = next(self.model.parameters()).dtype
        self.height, self.width = height, width
        self.batch_size = batch_size
        self.dtype = dtype

    def dispatch(self, img_u8):
        """Enqueue the forward of a host (B, H, W, 3) uint8 batch and return
        the device features and B, without waiting for the card."""
        x = torch.from_numpy(np.ascontiguousarray(img_u8)).to(self.device)
        with torch.inference_mode():
            x = eval_transform(x, self.height, self.width, self.dtype)
            return self.model(x.to(self.param_dtype)), img_u8.shape[0]

    def __call__(self, img_u8):
        f, _ = self.dispatch(img_u8)
        return f.float().cpu().numpy()


def extract_features(extractor, data_loader, print_freq=50, max_pending=8):
    """Run the extractor over a loader; returns OrderedDicts fname → feature
    and fname → pid (parity: evaluators.py:30-68).

    Batches are dispatched without a per-batch host sync, so the card runs
    ahead while the loader stages the next batch. At most ``max_pending``
    batches of device output stay live: once the window is full, each
    dispatch drains the oldest batch to the host."""
    batch_time = AverageMeter()
    data_time = AverageMeter()
    features = OrderedDict()
    labels = OrderedDict()
    pending = []

    def drain_one():
        f, fnames = pending.pop(0)
        feats = f.float().cpu().numpy()
        for j, fname in enumerate(fnames):
            features[fname] = feats[j]

    end = time.time()
    for i, batch in enumerate(data_loader):
        data_time.update(time.time() - end)
        f, _ = extractor.dispatch(batch["img"])
        pending.append((f, batch["fname"]))
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
    return features, labels


def evaluate_all_features(x, y, query, gallery, cmc_topk=(1, 5, 10),
                          cmc_flag=False, device=None):
    """mAP + market1501 CMC from query features ``x`` and gallery features
    ``y`` on ``device`` (default: the card; raises if there is none); the
    (m, n) distance matrix never leaves the device."""
    scores, mAP = rank_metrics_features(
        x, y, [pid for _, pid, _ in query], [pid for _, pid, _ in gallery],
        [cam for _, _, cam in query], [cam for _, _, cam in gallery],
        device=device)
    print("Mean AP: {:4.1%}".format(mAP))
    if not cmc_flag:
        return mAP
    print("CMC Scores:")
    for k in cmc_topk:
        print("  top-{:<4}{:12.1%}".format(k, scores[k - 1]))
    return scores, mAP


class Evaluator:
    """Parity: CC/clustercontrast/evaluators.py:125-142."""

    def __init__(self, extractor):
        self.extractor = extractor

    def evaluate(self, data_loader, query, gallery, cmc_flag=False, rerank=False):
        if rerank:
            raise NotImplementedError(
                "re-ranking is not ported yet: it waits for "
                "ops/jaccard.py::re_ranking (ROADMAP A8)")
        features = extract_features(self.extractor, data_loader)[0]
        x = np.stack([features[f] for f, _, _ in query])
        y = np.stack([features[f] for f, _, _ in gallery])
        return evaluate_all_features(x, y, query, gallery, cmc_flag=cmc_flag,
                                     device=self.extractor.device)
