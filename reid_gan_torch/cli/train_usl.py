"""Unsupervised cluster-contrast training CLI (port of
``reid_gan_tpu/cli/train_usl.py``; parity: CC/examples/
cluster_contrast_train_usl.py, DBSCAN backend, and
cluster_contrast_train_usl_infomap.py, ``--cluster-backend infomap``):

    python -m reid_gan_torch.cli.train_usl --dataset market1501 --data-dir ./data \\
        --eps 0.4 [--device cuda]

Each epoch re-clusters the train set (extraction, kNN, Jaccard, DBSCAN, the
centroid bank), trains ``--iters`` P×K steps, and every ``--eval-step``
epochs evaluates and writes ``checkpoint.pth.tar`` (and
``model_best.pth.tar``, which ``cli/test.py --resume-torch`` reads). Runs on
the card unless ``--device cpu`` is given. Not ported yet: ``--resume`` of a
flax msgpack checkpoint (ROADMAP A: msgpack checkpoints) and ``--fp16`` (ROADMAP A: `--fp16`).
"""

import argparse
import os.path as osp
import sys
import time

import torch

from ..config import dump_config, parse_config
from ..data.datasets import create as create_dataset
from ..data.loader import DataLoader, Preprocessor
from ..device import resolve_device
from ..engine.evaluators import Evaluator, FeatureExtractor
from ..engine.trainers import ClusterContrastTrainer
from ..engine.usl import cluster_epoch, make_train_loader
from ..models import create as create_model
from ..utils import Logger, Timer
from ..utils.serialization import load_checkpoint, save_checkpoint

SECTIONS = ("data", "model", "optim", "cluster", "train")


def main(argv=None):
    """Parse the flags (JAX's, plus ``--device``), tee stdout to
    ``<logs-dir>/log.txt``, write ``train_opt.txt``, load the dataset and
    run the loop. Returns the best mAP."""
    argv = sys.argv[1:] if argv is None else argv
    extra = argparse.ArgumentParser(allow_abbrev=False)
    extra.add_argument("--device", default="cuda",
                       help="torch device; 'cpu' runs the plain versions of "
                            "the kernels")
    ns, rest = extra.parse_known_args(argv)
    cfg = parse_config(rest, sections=SECTIONS)
    device = resolve_device(ns.device)
    if cfg.train.fp16:
        raise NotImplementedError(
            "--fp16 (bf16 parameters) is not ported yet "
            "(ROADMAP A: `--fp16`)")
    if cfg.train.resume.endswith(".msgpack"):
        raise NotImplementedError(
            "--resume of a flax msgpack checkpoint is not ported yet "
            "(ROADMAP A: msgpack checkpoints); resume from the port's checkpoint.pth.tar")
    logger = Logger(osp.join(cfg.train.logs_dir, "log.txt"))
    sys.stdout = logger
    try:
        dump_config(cfg, cfg.train.logs_dir, sections=SECTIONS)
        print("==> Config written; starting USL training")
        dataset = create_dataset(cfg.data.dataset, cfg.data.data_dir, verbose=True)
        return run(cfg, dataset, device)
    finally:
        sys.stdout = logger.console
        logger.close()


def _checkpoint(model, epoch, best_map):
    return {"state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "epoch": epoch, "best_mAP": best_map}


def run(cfg, dataset, device=None, image_cache=None, on_cluster=None):
    """The epoch loop and the final best-model eval (train_usl.py:86-159)
    on ``dataset`` (``.train``, ``.query``, ``.gallery`` lists of
    ``(fname, pid, camid)``), on ``device`` (default: the card).
    ``image_cache`` goes to every ``Preprocessor`` the loop builds (default:
    the shared decode cache); ``on_cluster`` to every ``cluster_epoch``.
    Returns the best mAP, or the eval's (cmc, mAP) with ``--evaluate``."""
    device = resolve_device(device)
    start = time.monotonic()
    cache = "default" if image_cache is None else image_cache
    # TF32 convolutions as in cli/test.py; every distance product stays fp32
    torch.backends.cudnn.allow_tf32 = True
    torch.manual_seed(cfg.train.seed)
    model = create_model(cfg.model.arch, num_features=cfg.model.features,
                         norm=cfg.model.norm, dropout=cfg.model.dropout,
                         pooling_type=cfg.model.pooling_type)
    start_epoch = 0
    if cfg.train.resume:
        ckpt = load_checkpoint(cfg.train.resume)
        model.load_state_dict(ckpt["state_dict"])
        start_epoch = int(ckpt["epoch"])
        print(f"=> Resumed from epoch {start_epoch} "
              f"(best mAP {float(ckpt['best_mAP']):.1%})")

    extractor = FeatureExtractor(model, height=cfg.data.height, width=cfg.data.width,
                                 batch_size=cfg.data.batch_size, device=device)
    evaluator = Evaluator(extractor)
    test_pre = Preprocessor(list(dataset.query) + list(dataset.gallery), mode="reid",
                            height=cfg.data.height, width=cfg.data.width, cache=cache)
    test_loader = DataLoader(test_pre, batch_size=cfg.data.batch_size,
                             drop_last=False, num_workers=cfg.data.workers)

    if cfg.train.evaluate:
        return evaluator.evaluate(test_loader, dataset.query, dataset.gallery,
                                  cmc_flag=True)

    trainer = ClusterContrastTrainer(
        model, height=cfg.data.height, width=cfg.data.width, temp=cfg.cluster.temp,
        momentum=cfg.cluster.momentum, use_hard=cfg.cluster.use_hard,
        lr=cfg.optim.lr, weight_decay=cfg.optim.weight_decay,
        step_size=cfg.optim.step_size, iters_per_epoch=cfg.train.iters,
        num_instances=cfg.data.num_instances, device=device)

    epochs = 1 if cfg.train.debug else cfg.train.epochs
    iters = 8 if cfg.train.debug else cfg.train.iters
    state = None
    best_map = 0.0
    k_pad = cfg.cluster.max_clusters or None
    logs_dir = cfg.train.logs_dir

    for epoch in range(start_epoch, epochs):
        memory, pseudo_dataset, _ = cluster_epoch(extractor, list(dataset.train), cfg,
                                                  k_pad=k_pad, cache=cache,
                                                  on_cluster=on_cluster)
        k_pad = memory.features.shape[0]  # sticky: the bank keeps its shape
        state = trainer.init_state(memory) if state is None else \
            trainer.set_memory(state, memory)

        loader = make_train_loader(pseudo_dataset, cfg.data.height, cfg.data.width,
                                   cfg.data.batch_size, cfg.data.num_instances,
                                   workers=cfg.data.workers, iters=iters,
                                   seed=cfg.train.seed + epoch, cache=cache)
        with Timer("train"):
            state, _ = trainer.train(state, epoch, loader, train_iters=iters,
                                     print_freq=cfg.train.print_freq,
                                     base_seed=cfg.train.seed)
        loader.close()

        if (epoch + 1) % cfg.train.eval_step == 0 or epoch == epochs - 1:
            with Timer("eval"):
                mAP = evaluator.evaluate(test_loader, dataset.query, dataset.gallery,
                                         cmc_flag=False)
            is_best = mAP > best_map
            best_map = max(mAP, best_map)
            save_checkpoint(_checkpoint(model, epoch + 1, best_map), is_best,
                            osp.join(logs_dir, "checkpoint.pth.tar"))
            print(f"\n * Finished epoch {epoch:3d}  model mAP: {mAP:5.1%} "
                  f" best: {best_map:5.1%}{' *' if is_best else ''}\n")

    # the final full-CMC eval with the best checkpoint (parity:
    # ...infomap.py:518-521 'Test with the best model')
    best_path = osp.join(logs_dir, "model_best.pth.tar")
    if osp.isfile(best_path) and state is not None:
        print("==> Test with the best model:")
        model.load_state_dict(load_checkpoint(best_path)["state_dict"])
        evaluator.evaluate(test_loader, dataset.query, dataset.gallery, cmc_flag=True)

    dt = time.monotonic() - start
    print(f"Total running time: {dt / 3600:.0f}h {dt % 3600 / 60:.0f}m {dt % 60:.0f}s")
    return best_map


if __name__ == "__main__":
    main()
