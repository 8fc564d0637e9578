"""FD-GAN's engines: the stage-I Siamese verification trainer and the
two-stage ``CascadeEvaluator`` (port of ``reid_gan_tpu/engine/fdgan.py``;
parity: FD/reid/trainers.py:19-73, FD/reid/evaluators.py:101-228,
FD/baseline.py:96-143).

- ``SiameseTrainer``: the train transform of both pair halves (kernel K14,
  ``ops/transforms.fd_augment``), the weight-tied base in train mode on each
  half in turn, cross-entropy on the verification logits, SGD with momentum
  and coupled weight decay, lr × 0.1 every ``step_size`` epochs. The loss
  and logits stay on the card; one fetch per ``print_freq`` steps.
- ``fd_evaluate_all``: mAP and the allshots / cuhk03 / market1501 CMC
  table of a host distance matrix (K3 and its variants through
  ``engine/metrics``; the cuhk03 curve through the host sampler).
- ``CascadeEvaluator``: stage 1 extracts features (K1, the base), ranks the
  gallery by squared L2; stage 2 re-scores each query's top k with the
  verifier (softmax column 0, one batched forward over the m·k pairs on the
  card) and pushes the rest beyond a gap. The top-k set
  (``np.argpartition``) and the merge stay on the host, as in JAX, so ties
  at the boundary pick the same set.
"""

import time

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.transforms import fd_augment, sample_fd_augment_params
from ..parallel.mesh import refuse_mesh
from ..utils import AverageMeter
from .evaluators import extract_features, pairwise_distance
from .metrics import accuracy, cmc, rank_metrics


class SiameseTrainer:
    """Stage-I supervised verification baseline on ``device`` (default: the
    card). ``seed`` seeds the ``torch.Generator`` of the augmentation draws."""

    def __init__(self, model, lr=0.01, momentum=0.9, weight_decay=5e-4, step_size=40,
                 device=None, seed=0, mesh=None):
        refuse_mesh("SiameseTrainer (FD-GAN stage I)", mesh)
        self.device = resolve_device(device)
        self.model = model.to(self.device, memory_format=torch.channels_last)
        self.base_lr = lr
        self.step_size = step_size
        # optax.chain(add_decayed_weights, sgd(momentum)) is torch's SGD with
        # coupled weight decay: the decay joins the gradient before the trace
        self.optimizer = torch.optim.SGD(self.model.parameters(), lr=lr, momentum=momentum,
                                         weight_decay=weight_decay)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def adjust_lr(self, epoch):
        """lr = base · 0.1^(epoch // step_size) (FD/baseline.py:135-139)."""
        for g in self.optimizer.param_groups:
            g["lr"] = self.base_lr * 0.1 ** (epoch // self.step_size)

    def step(self, img1, img2, targets, params1=None, params2=None):
        """One step on device uint8 pair halves (B, H, W, 3) and int64
        targets (1 = same pid); ``params1``/``params2``: K14 draws (B, 9),
        drawn from the trainer's generator when not given. Returns the
        device (loss, logits)."""
        n, h, w = img1.shape[:3]
        p_dtype = next(self.model.parameters()).dtype
        if params1 is None:
            params1 = sample_fd_augment_params(n, h, w, self.generator)
        if params2 is None:
            params2 = sample_fd_augment_params(n, h, w, self.generator)
        x1 = fd_augment(img1, params1).to(p_dtype)
        x2 = fd_augment(img2, params2).to(p_dtype)
        self.model.train()
        _, _, logits = self.model(x1, x2)
        loss = F.cross_entropy(logits, targets)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach(), logits.detach()

    def train(self, epoch, data_loader, print_freq=1):
        """One epoch over a ``pair``-mode loader of (batch1, batch2); returns
        the mean loss. The losses and logits of a print window are fetched
        in one copy."""
        batch_time, data_time = AverageMeter(), AverageMeter()
        losses, precisions = AverageMeter(), AverageMeter()
        buf = []

        def drain():
            if not buf:
                return
            fetched = torch.stack([torch.cat([l[None], g.flatten()]) for l, g, _ in buf]).cpu()
            for row, (_, g, tgt) in zip(fetched.numpy(), buf):
                prec, = accuracy(row[1:].reshape(g.shape), tgt)
                losses.update(float(row[0]), len(tgt))
                precisions.update(prec, len(tgt))
            buf.clear()

        self.adjust_lr(epoch)
        end = window_start = time.time()
        for i, (b1, b2) in enumerate(data_loader):
            data_time.update(time.time() - end)
            targets = (b1["pid"] == b2["pid"]).astype(np.int64)
            img1 = torch.from_numpy(np.ascontiguousarray(b1["img"])).to(self.device)
            img2 = torch.from_numpy(np.ascontiguousarray(b2["img"])).to(self.device)
            loss, logits = self.step(img1, img2, torch.from_numpy(targets).to(self.device))
            buf.append((loss, logits, targets))
            end = time.time()
            if (i + 1) % print_freq == 0:
                drain()
                now = time.time()
                batch_time.update((now - window_start) / print_freq, n=print_freq)
                window_start = end = now
                print(f"Epoch: [{epoch}][{i + 1}]\t"
                      f"Time {batch_time.val:.3f} ({batch_time.avg:.3f})\t"
                      f"Data {data_time.val:.3f} ({data_time.avg:.3f})\t"
                      f"Loss {losses.val:.3f} ({losses.avg:.3f})\t"
                      f"Prec {precisions.val:.2%} ({precisions.avg:.2%})")
        drain()
        return losses.avg


_PROTOCOLS = {
    "allshots": dict(separate_camera_set=False, single_gallery_shot=False,
                     first_match_break=False),
    "cuhk03": dict(separate_camera_set=True, single_gallery_shot=True,
                   first_match_break=False),
    "market1501": dict(separate_camera_set=False, single_gallery_shot=False,
                       first_match_break=True),
}


def fd_evaluate_all(distmat, query, gallery, cmc_topk=(1, 5, 10), dataset=None,
                    top1=True, device=None):
    """mAP and the CMC table of a host distance matrix (fdgan.py:155-205):
    all three protocols without ``dataset``, else cuhk03 for ``"cuhk03"``
    and market1501 for any other name. Returns mAP without ``top1``; the
    allshots top-1 without ``dataset``; else (top-1, mAP)."""
    ids = lambda items, k: [it[k] for it in items]  # noqa: E731
    args = (ids(query, 1), ids(gallery, 1), ids(query, 2), ids(gallery, 2))
    _, mAP = rank_metrics(distmat, *args, topk=1, device=device)
    print("Mean AP: {:4.1%}".format(mAP))
    if not top1:
        return mAP
    if not dataset:
        names = list(_PROTOCOLS)
    else:
        names = ["cuhk03" if dataset == "cuhk03" else "market1501"]
    scores = {n: cmc(distmat, *args, seed=0, device=device, **_PROTOCOLS[n])
              for n in names}
    print("CMC Scores" + "".join(f"{n:>12}" for n in names))
    for k in cmc_topk:
        print("  top-{:<4}".format(k) + "".join(f"{scores[n][k - 1]:12.1%}" for n in names))
    if not dataset:
        return scores["allshots"][0]
    return scores[names[0]][0], mAP


class CascadeEvaluator:
    """Two-stage evaluation (fdgan.py:208-274): ``extractor`` (a
    ``FeatureExtractor`` over the Siamese net's base) gives the features;
    ``embed_model`` (its ``EltwiseSubEmbed``) re-scores the top k in eval
    mode. Both are the live modules, so a trainer's later weights need no
    swap."""

    def __init__(self, extractor, embed_model, embed_dist_fn="softmax0"):
        refuse_mesh("CascadeEvaluator (FD-GAN's evaluation)",
                    getattr(extractor, "mesh", None))
        self.extractor = extractor
        self.embed_model = embed_model.to(extractor.device)
        self.embed_dist_fn = embed_dist_fn

    def _embed(self, probe, gallery):
        self.embed_model.eval()
        dev = self.extractor.device
        dtype = next(self.embed_model.parameters()).dtype
        with torch.inference_mode():
            logits = self.embed_model(torch.from_numpy(probe).to(dev, dtype),
                                      torch.from_numpy(gallery).to(dev, dtype))
            if self.embed_dist_fn == "softmax0":
                logits = torch.softmax(logits, dim=1)
            return logits[:, 0].float().cpu().numpy()

    def evaluate(self, data_loader, query, gallery, rerank_topk=75, second_stage=True,
                 dataset=None, top1=True):
        device = self.extractor.device
        features, _ = extract_features(self.extractor, data_loader, print_freq=1 << 30)
        distmat, qf, gf = pairwise_distance(features, query, gallery, device)
        print("First stage evaluation:")
        if second_stage:
            fd_evaluate_all(distmat, query, gallery, dataset=dataset, top1=top1,
                            device=device)
            m = len(query)
            # only the top-k set and the (k+1)-th boundary element are needed
            part = np.argpartition(distmat, (rerank_topk - 1, rerank_topk), axis=1)
            topk_idx = part[:, :rerank_topk]
            scores = self._embed(np.repeat(qf, rerank_topk, axis=0),
                                 gf[topk_idx.reshape(-1)]).reshape(m, rerank_topk)
            # the verifier's distance replaces the top k; the tail moves past
            # the gap (FD/reid/evaluators.py:219-226)
            nxt = np.take_along_axis(distmat, part[:, rerank_topk:rerank_topk + 1],
                                     axis=1)[:, 0]
            np.put_along_axis(distmat, topk_idx, scores, axis=1)
            gap = np.maximum(scores.max(axis=1) + 1.0 - nxt, 0.0)
            tail = np.ones(distmat.shape, bool)
            np.put_along_axis(tail, topk_idx, False, axis=1)
            distmat += gap[:, None] * tail
            print("Second stage evaluation:")
        return fd_evaluate_all(distmat, query, gallery, dataset=dataset, top1=top1,
                               device=device)
