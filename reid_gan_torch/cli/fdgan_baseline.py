"""FD-GAN stage I: the supervised Siamese verification baseline (port of
``reid_gan_tpu/cli/fdgan_baseline.py``; parity: FD/baseline.py, batch 256,
SGD lr 0.01, step 40, 100 epochs, the CascadeEvaluator with the verifier's
re-scoring):

    python -m reid_gan_torch.cli.fdgan_baseline --dataset market1501 \\
        --data-dir ./data --lr 0.01 --step-size 40 --epochs 100 [--device cuda]

Each epoch trains on ``RandomPairSampler`` pairs (one positive and one
negative per anchor) through ``SiameseTrainer`` (kernel K14 augments both
halves), and every ``--eval-step`` epochs (and after the last) evaluates
with ``CascadeEvaluator`` (K1, the base, K3; the verifier re-scores each
query's top 100, 20 with ``--debug``) and writes ``checkpoint.pth.tar``
(``{"state_dict", "epoch", "best_mAP"}``, copied to ``model_best.pth.tar``),
the file ``cli/fdgan_train --stage 1 --netE-pretrain`` reads. ``--debug``:
ResNet-18, one epoch of 2 iterations. ``--resume`` reads the port's
``.pth.tar``; a flax ``.msgpack`` raises. Runs on the card unless
``--device cpu`` is given. ``--dataset cuhk03`` (``JsonDataset``) is not
ported yet (ROADMAP A: `JsonDataset`/CUHK03).
"""

import argparse
import os.path as osp
import sys

import torch

from ..config import dump_config, parse_config
from ..data.loader import DataLoader, Preprocessor
from ..data.sampler import RandomPairSampler
from ..device import resolve_device
from ..engine.evaluators import FeatureExtractor
from ..engine.fdgan import CascadeEvaluator, SiameseTrainer
from ..models import siamese_baseline
from ..utils import Logger
from ..utils.serialization import load_checkpoint, save_checkpoint

SECTIONS = ("data", "model", "optim", "train")


def create_fd_dataset(cfg):
    """The dataset of ``--dataset``; ``cuhk03`` and ``json`` (the JSON
    split datasets) raise, naming their roadmap item."""
    from ..data.datasets import create as create_dataset

    if cfg.data.dataset in ("cuhk03", "json"):
        raise NotImplementedError(
            f"--dataset {cfg.data.dataset}: JsonDataset/CUHK03 are not ported yet "
            "(ROADMAP A: `JsonDataset`/CUHK03)")
    return create_dataset(cfg.data.dataset, cfg.data.data_dir, verbose=True)


def main(argv=None):
    """Parse the flags (JAX's, plus ``--device``), tee stdout to
    ``<logs-dir>/log.txt``, write ``opt.txt``, load the dataset and train.
    Returns the best mAP (the evaluation's (top-1, mAP) with
    ``--evaluate``)."""
    argv = sys.argv[1:] if argv is None else argv
    extra = argparse.ArgumentParser(allow_abbrev=False)
    extra.add_argument("--device", default="cuda",
                       help="torch device; 'cpu' runs the plain versions of "
                            "the kernels")
    ns, rest = extra.parse_known_args(argv)
    cfg = parse_config(rest, sections=SECTIONS)
    device = resolve_device(ns.device)
    if cfg.train.resume.endswith(".msgpack"):
        raise NotImplementedError(
            "--resume of a flax msgpack checkpoint is not ported yet "
            "(ROADMAP A: msgpack checkpoints); resume from the port's checkpoint.pth.tar")
    logger = Logger(osp.join(cfg.train.logs_dir, "log.txt"))
    sys.stdout = logger
    try:
        dump_config(cfg, cfg.train.logs_dir, "opt.txt", sections=SECTIONS)
        return run(cfg, create_fd_dataset(cfg), device)
    finally:
        sys.stdout = logger.console
        logger.close()


def make_cascade_evaluator(model, cfg, device):
    """The two-stage evaluator over a Siamese net: its base's features in
    fp32 (the JAX CLI's ``dtype=jnp.float32``), its head as the verifier."""
    ex = FeatureExtractor(model.base_model, height=cfg.data.height, width=cfg.data.width,
                          batch_size=cfg.data.batch_size, device=device,
                          dtype=torch.float32)
    return CascadeEvaluator(ex, model.embed_model)


def run(cfg, dataset, device=None, image_cache=None, depth=50):
    """Stage I (fdgan_baseline.py:28-111) on ``dataset`` (``.train``,
    ``.query``, ``.gallery`` lists of ``(fname, pid, camid)``), on ``device``
    (default: the card). ``image_cache`` goes to every ``Preprocessor``
    (default: the shared decode cache). Returns the best mAP, or the
    evaluation's (top-1, mAP) with ``--evaluate``."""
    device = resolve_device(device)
    # TF32 convolutions as in the training CLIs; every other product stays fp32
    torch.backends.cudnn.allow_tf32 = True
    if cfg.train.debug:
        depth = 18
    cache = "default" if image_cache is None else image_cache
    torch.manual_seed(cfg.train.seed)
    model = siamese_baseline(depth=depth)
    if cfg.train.resume:
        model.load_state_dict(load_checkpoint(cfg.train.resume)["state_dict"])
    model = model.to(device, memory_format=torch.channels_last)
    h, w = cfg.data.height, cfg.data.width
    query, gallery = list(dataset.query), list(dataset.gallery)
    test_loader = DataLoader(Preprocessor(query + gallery, mode="reid", height=h, width=w,
                                          cache=cache),
                             batch_size=cfg.data.batch_size, drop_last=False,
                             num_workers=cfg.data.workers)
    rerank_topk = min(20 if cfg.train.debug else 100, len(gallery) - 1)
    evaluator = make_cascade_evaluator(model, cfg, device)

    def evaluate():
        return evaluator.evaluate(test_loader, query, gallery, rerank_topk=rerank_topk,
                                  dataset=cfg.data.dataset)

    if cfg.train.evaluate:
        return evaluate()
    trainer = SiameseTrainer(model, lr=cfg.optim.lr, momentum=cfg.optim.momentum,
                             weight_decay=cfg.optim.weight_decay,
                             step_size=cfg.optim.step_size, device=device,
                             seed=cfg.train.seed)
    epochs = 1 if cfg.train.debug else cfg.train.epochs
    best_map = 0.0
    for epoch in range(epochs):
        train = list(dataset.train)
        loader = DataLoader(
            Preprocessor(train, mode="pair", height=h, width=w, seed=cfg.train.seed + epoch,
                         cache=cache),
            sampler=RandomPairSampler(train, neg_pos_ratio=1, seed=cfg.train.seed + epoch),
            batch_size=cfg.data.batch_size, num_workers=cfg.data.workers, drop_last=True)
        trainer.train(epoch, _limit(loader, 2) if cfg.train.debug else loader,
                      print_freq=cfg.train.print_freq)
        if epoch % cfg.train.eval_step == 0 or epoch == epochs - 1:
            _, mAP = evaluate()
            is_best = mAP > best_map
            best_map = max(mAP, best_map)
            save_checkpoint({"state_dict": {k: v.detach().cpu()
                                            for k, v in model.state_dict().items()},
                             "epoch": epoch + 1, "best_mAP": best_map}, is_best,
                            osp.join(cfg.train.logs_dir, "checkpoint.pth.tar"))
            print(f"\n * Finished epoch {epoch:3d}  mAP: {mAP:5.1%} "
                  f"best: {best_map:5.1%}{' *' if is_best else ''}\n")
    return best_map


def _limit(loader, n):
    """The first ``n`` batches; the loader's producer stops after them."""
    it = iter(loader)
    try:
        for _, b in zip(range(n), it):
            yield b
    finally:
        it.close()


if __name__ == "__main__":
    main()
