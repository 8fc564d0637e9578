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

Under a data mesh (one rank a card, JAX ``engine/fdgan.py:52-54,90-93,
129-133,240-243``) the Siamese net is replicated from rank 0 and each rank
takes its contiguous slice of both halves of each pair batch
(``DataLoader(shard=)``). Its BatchNorms become global (``ops/norm.py``):
the base runs in train mode on each half in turn, so each half is
normalised with that half's statistics over every rank and the running
stats fold twice, as on one card. K14's draws are the whole batch's, drawn
alike on every rank from the same generator and sliced; the gradients are
averaged over the ranks before SGD; the printed loss and precision are the
whole batch's, reduced once a print window. The cascade evaluator extracts
on every rank's rows and gathers the features (``engine/evaluators.py``),
and every rank ranks the same distance matrix; the verifier scores the
rank's contiguous share of the m·k top-k pairs, gathered in order, and
rank 0's metrics are every rank's.
"""

import time

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.norm import convert_global_bn
from ..ops.transforms import fd_augment, sample_fd_augment_params
from ..parallel.mesh import (
    all_gather_rows,
    all_reduce_grads,
    all_reduce_sum,
    broadcast_object,
    main_prints,
    mesh_device,
    pad_to_multiple,
    replicate,
    shard_batch,
)
from ..utils import AverageMeter
from .evaluators import extract_features, pairwise_distance
from .metrics import accuracy, cmc, rank_metrics


class SiameseTrainer:
    """Stage-I supervised verification baseline on ``device`` (default: the
    card). ``seed`` seeds the ``torch.Generator`` of the augmentation draws.
    With ``mesh`` the device is the rank's, the net's BatchNorms become
    global and its weights rank 0's (the module's docstring)."""

    def __init__(self, model, lr=0.01, momentum=0.9, weight_decay=5e-4, step_size=40,
                 device=None, seed=0, mesh=None):
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        self.model = replicate(mesh, convert_global_bn(model, mesh).to(
            self.device, memory_format=torch.channels_last))
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
        drawn from the trainer's generator when not given. Under a mesh the
        halves and targets are the rank's rows and the draws the whole
        batch's. Returns the device (loss, logits) of the rank's rows."""
        n, h, w = img1.shape[:3]
        n *= self.mesh.world_size if self.mesh else 1
        p_dtype = next(self.model.parameters()).dtype
        if params1 is None:
            params1 = sample_fd_augment_params(n, h, w, self.generator)
        if params2 is None:
            params2 = sample_fd_augment_params(n, h, w, self.generator)
        if self.mesh is not None:
            params1, params2 = shard_batch(self.mesh, (params1, params2))
        x1 = fd_augment(img1, params1).to(p_dtype)
        x2 = fd_augment(img2, params2).to(p_dtype)
        self.model.train()
        _, _, logits = self.model(x1, x2)
        loss = F.cross_entropy(logits, targets)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_grads(self.mesh, self.model.parameters())
        self.optimizer.step()
        return loss.detach(), logits.detach()

    def train(self, epoch, data_loader, print_freq=1):
        """One epoch over a ``pair``-mode loader of (batch1, batch2); returns
        the mean loss. The losses and logits of a print window are fetched
        in one copy; under a mesh each step's loss and correct count are
        then summed over the ranks in one reduction a window."""
        batch_time, data_time = AverageMeter(), AverageMeter()
        losses, precisions = AverageMeter(), AverageMeter()
        buf = []
        world = self.mesh.world_size if self.mesh else 1

        def drain():
            if not buf:
                return
            fetched = torch.stack([torch.cat([l[None], g.flatten()]) for l, g, _ in buf]).cpu()
            rows = [(float(row[0]), accuracy(row[1:].reshape(g.shape), tgt)[0] * len(tgt),
                     len(tgt) * world) for row, (_, g, tgt) in zip(fetched.numpy(), buf)]
            if self.mesh is not None:
                sums = all_reduce_sum(self.mesh, torch.tensor(
                    [r[:2] for r in rows], dtype=torch.float64, device=self.device)).cpu()
                rows = [(loss / world, correct, n)
                        for (loss, correct), (_, _, n) in zip(sums.tolist(), rows)]
            for loss, correct, n in rows:
                losses.update(loss, n)
                precisions.update(correct / n, n)
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
    swap. Under the extractor's mesh the loader is sharded over it (the
    module's docstring)."""

    def __init__(self, extractor, embed_model, embed_dist_fn="softmax0"):
        self.extractor = extractor
        self.mesh = getattr(extractor, "mesh", None)
        self.embed_model = embed_model.to(extractor.device)
        self.embed_dist_fn = embed_dist_fn

    def _embed(self, probe, gallery):
        """The verifier's distance of each (probe, gallery) row pair; under
        a mesh each rank scores its contiguous share of the rows (padded to
        a multiple of the mesh size), gathered in order."""
        self.embed_model.eval()
        dev = self.extractor.device
        dtype = next(self.embed_model.parameters()).dtype
        n = len(probe)
        if self.mesh is not None:
            probe, gallery = (shard_batch(self.mesh, pad_to_multiple(a, self.mesh.world_size)[0])
                              for a in (probe, gallery))
        probe, gallery = (torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)
                          for a in (probe, gallery))
        with torch.inference_mode():
            logits = self.embed_model(probe, gallery)
            if self.embed_dist_fn == "softmax0":
                logits = torch.softmax(logits, dim=1)
            return all_gather_rows(self.mesh, logits[:, 0].float(), n).cpu().numpy()

    def evaluate(self, data_loader, query, gallery, rerank_topk=75, second_stage=True,
                 dataset=None, top1=True):
        """(top-1, mAP) with ``dataset``, else as ``fd_evaluate_all`` returns
        (fdgan.py:230-274); under a mesh rank 0's, on every rank, and only
        rank 0 prints."""
        with main_prints(self.mesh):
            out = self._evaluate(data_loader, query, gallery, rerank_topk, second_stage,
                                 dataset, top1)
        return broadcast_object(self.mesh, out)

    def _evaluate(self, data_loader, query, gallery, rerank_topk, second_stage, dataset,
                  top1):
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
