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
``.pth.tar`` or the JAX package's flax ``.msgpack`` (the Siamese net's
variables, fdgan_baseline.py:51), strictly. Runs on the card unless
``--device cpu`` is given. ``--dataset cuhk03`` and ``--dataset json`` read
an open-reid tree (``meta.json``, ``splits.json``, ``images/``), whose image
names resolve under its ``images/``; cuhk03 is scored under its own CMC
protocol.

Several cards (fdgan_baseline.py:34-39): with more than one card visible
and no ``--device cpu``, ``main`` runs one process a card over all of them
(``parallel.launch``): each rank decodes its slice of each pair batch and
of each eval batch, the steps and the evaluation are those of one device
on the whole batch (``engine/fdgan.py``), and only rank 0 prints and writes
``log.txt``, ``opt.txt`` and the checkpoints. The mesh size must divide
the batch size. ``main(argv, mesh=False)`` keeps one card. The ranks
draw from this process's order of each id's names (``run_main``).
"""

import argparse
import os.path as osp
import sys

import torch

from ..config import dump_config, parse_config
from ..data.datasets import create as create_dataset
from ..data.loader import DataLoader, Preprocessor, check_pair_batch
from ..data.sampler import RandomPairSampler
from ..device import resolve_device
from ..engine.evaluators import FeatureExtractor
from ..engine.fdgan import CascadeEvaluator, SiameseTrainer
from ..models import siamese_baseline
from ..parallel.mesh import (
    is_main,
    launch,
    local_device_count,
    main_first,
    main_prints,
    mesh_device,
    replicate,
    wants_mesh,
)
from ..utils import Logger
from ..utils.serialization import resume_checkpoint, save_checkpoint

SECTIONS = ("data", "model", "optim", "train")


def main(argv=None, mesh=None, pid_imgs=None):
    """Parse the flags (JAX's, plus ``--device``), tee stdout to
    ``<logs-dir>/log.txt``, write ``opt.txt``, load the dataset and train.
    Returns the best mAP (the evaluation's (top-1, mAP) with
    ``--evaluate``). ``mesh``: None spans every card when more than one is
    visible, False keeps one, a ``Mesh`` is this rank's (the module's
    docstring). ``pid_imgs``: see ``run_main``."""
    argv = sys.argv[1:] if argv is None else argv
    extra = argparse.ArgumentParser(allow_abbrev=False)
    extra.add_argument("--device", default="cuda",
                       help="torch device; 'cpu' runs the plain versions of "
                            "the kernels")
    ns, rest = extra.parse_known_args(argv)
    cfg = parse_config(rest, sections=SECTIONS)
    return run_main(cfg, resolve_device(ns.device), mesh, argv, _main_on_rank, run,
                    pid_imgs)


def _main_on_rank(mesh, argv, pid_imgs):
    return main(argv, mesh=mesh, pid_imgs=pid_imgs)


def run_main(cfg, device, mesh, argv, on_rank, run_fn, pid_imgs=None):
    """The two FD-GAN CLIs' ``main`` after parsing: ``launch`` one rank a
    card (``on_rank(mesh, argv, pid_imgs)``) where ``wants_mesh``, else tee
    stdout to ``<logs-dir>/log.txt`` and write ``opt.txt`` (rank 0), load
    the dataset (rank 0 first) and return ``run_fn(cfg, dataset, device,
    mesh=mesh)``. A mesh size that does not divide the batch size raises
    ``ValueError`` before any work.

    ``pid_imgs`` (pid → image names, lists) replaces the dataset's own. The
    ``fdgan_pose`` loader draws each target by its position in
    ``list(pid_imgs[pid])``, and a dataset's sets list their names in an
    order that follows the process's string hashing, which a spawned rank
    seeds anew. So the launch passes this process's lists to every rank,
    and each rank draws what this process would draw."""
    if wants_mesh(device, mesh):
        check_pair_batch(cfg.data.batch_size, local_device_count())
        names = getattr(create_dataset(cfg.data.dataset, cfg.data.data_dir, verbose=False),
                        "pid_imgs", None)
        order = None if names is None else {pid: list(v) for pid, v in names.items()}
        return launch(on_rank, local_device_count(), args=(argv, order))
    mesh = mesh or None
    if mesh is not None:
        check_pair_batch(cfg.data.batch_size, mesh.world_size)
    logger = Logger(osp.join(cfg.train.logs_dir, "log.txt")) if is_main(mesh) else None
    if logger is not None:
        sys.stdout = logger
    try:
        with main_prints(mesh):
            if is_main(mesh):
                dump_config(cfg, cfg.train.logs_dir, "opt.txt")
            dataset = main_first(mesh, lambda: create_dataset(
                cfg.data.dataset, cfg.data.data_dir, verbose=is_main(mesh)))
        if pid_imgs is not None:
            dataset.pid_imgs = pid_imgs
        return run_fn(cfg, dataset, None if mesh else device, mesh=mesh)
    finally:
        if logger is not None:
            sys.stdout = logger.console
            logger.close()


def make_cascade_evaluator(model, cfg, device, mesh=None):
    """The two-stage evaluator over a Siamese net: its base's features in
    fp32 (the JAX CLI's ``dtype=jnp.float32``), its head as the verifier;
    with ``mesh``, sharded over it."""
    ex = FeatureExtractor(model.base_model, height=cfg.data.height, width=cfg.data.width,
                          batch_size=cfg.data.batch_size, device=device,
                          dtype=torch.float32, mesh=mesh)
    return CascadeEvaluator(ex, model.embed_model)


def run(cfg, dataset, device=None, image_cache=None, depth=50, mesh=None):
    """Stage I (fdgan_baseline.py:28-111) on ``dataset`` (``.train``,
    ``.query``, ``.gallery`` lists of ``(fname, pid, camid)``, the names
    relative to ``.images_dir`` where it has one), on ``device``
    (default: the card). ``image_cache`` goes to every ``Preprocessor``
    (default: the shared decode cache). With ``mesh`` (a ready ``Mesh``, on
    every rank) the run is sharded over it and only rank 0 prints and
    writes. Returns the best mAP, or the evaluation's (top-1, mAP) with
    ``--evaluate``."""
    with main_prints(mesh):
        return _run(cfg, dataset, mesh_device(mesh, device), image_cache, depth, mesh)


def _run(cfg, dataset, device, image_cache, depth, mesh):
    # TF32 convolutions as in the training CLIs; every other product stays fp32
    torch.backends.cudnn.allow_tf32 = True
    if cfg.train.debug:
        depth = 18
    cache = "default" if image_cache is None else image_cache
    root = getattr(dataset, "images_dir", None)   # the JSON datasets' names are relative
    torch.manual_seed(cfg.train.seed)
    model = siamese_baseline(depth=depth)
    if cfg.train.resume:
        resume_checkpoint(cfg.train.resume, model)
    model = replicate(mesh, model.to(device, memory_format=torch.channels_last))
    h, w = cfg.data.height, cfg.data.width
    query, gallery = list(dataset.query), list(dataset.gallery)
    test_loader = DataLoader(Preprocessor(query + gallery, root=root, mode="reid",
                                          height=h, width=w, cache=cache),
                             batch_size=cfg.data.batch_size, drop_last=False,
                             num_workers=cfg.data.workers, shard=mesh)
    rerank_topk = min(20 if cfg.train.debug else 100, len(gallery) - 1)
    evaluator = make_cascade_evaluator(model, cfg, device, mesh)

    def evaluate():
        return evaluator.evaluate(test_loader, query, gallery, rerank_topk=rerank_topk,
                                  dataset=cfg.data.dataset)

    if cfg.train.evaluate:
        return evaluate()
    trainer = SiameseTrainer(model, lr=cfg.optim.lr, momentum=cfg.optim.momentum,
                             weight_decay=cfg.optim.weight_decay,
                             step_size=cfg.optim.step_size, device=device,
                             seed=cfg.train.seed, mesh=mesh)
    epochs = 1 if cfg.train.debug else cfg.train.epochs
    best_map = 0.0
    for epoch in range(epochs):
        train = list(dataset.train)
        loader = DataLoader(
            Preprocessor(train, root=root, mode="pair", height=h, width=w,
                         seed=cfg.train.seed + epoch, cache=cache),
            sampler=RandomPairSampler(train, neg_pos_ratio=1, seed=cfg.train.seed + epoch),
            batch_size=cfg.data.batch_size, num_workers=cfg.data.workers, drop_last=True,
            shard=mesh)
        trainer.train(epoch, _limit(loader, 2) if cfg.train.debug else loader,
                      print_freq=cfg.train.print_freq)
        if epoch % cfg.train.eval_step == 0 or epoch == epochs - 1:
            _, mAP = evaluate()
            is_best = mAP > best_map
            best_map = max(mAP, best_map)
            if is_main(mesh):
                save_checkpoint({"state_dict": {k: v.detach().cpu()
                                                for k, v in model.state_dict().items()},
                                 "epoch": epoch + 1, "best_mAP": best_map}, is_best,
                                osp.join(cfg.train.logs_dir, "checkpoint.pth.tar"))
            print(f"\n * Finished epoch {epoch:3d}  mAP: {mAP:5.1%} "
                  f"best: {best_map:5.1%}{' *' if is_best else ''}\n")
    if mesh is not None:
        mesh.barrier()      # rank 0's checkpoints are on disk for every rank
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
