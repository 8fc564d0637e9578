"""Unsupervised cluster-contrast training CLI (port of
``reid_gan_tpu/cli/train_usl.py``; parity: CC/examples/
cluster_contrast_train_usl.py, DBSCAN backend, and
cluster_contrast_train_usl_infomap.py, ``--cluster-backend infomap``):

    python -m reid_gan_torch.cli.train_usl --dataset market1501 --data-dir ./data \\
        --eps 0.4 [--device cuda]

Each epoch re-clusters the train set (extraction, kNN, Jaccard, DBSCAN, the
centroid bank), trains ``--iters`` P×K steps, and every ``--eval-step``
epochs evaluates and writes ``checkpoint.pth.tar`` (and
``model_best.pth.tar``, which ``cli/test.py --resume`` reads). Runs on
the card unless ``--device cpu`` is given. ``--resume`` restores the weights
and the epoch counter from the port's ``.pth.tar`` or the JAX package's flax
``.msgpack`` (train_usl.py:53-62). ``--fp16`` runs the backbone in bf16 as
the JAX package does (``models/precision.py``: bf16 convolutions, fp32
BatchNorm, heads, parameters and optimiser state).

Several cards (train_usl.py:41-44): with more than one card visible and no
``--device cpu``, ``main`` runs one process a card over all of them
(``parallel.launch``, NCCL), a data mesh whose steps, extraction and rank
pass are those of one device on the whole batch (``engine/trainers.py``,
``engine/evaluators.py``); ``main(argv, mesh=False)`` keeps one card, and
``CUDA_VISIBLE_DEVICES`` picks the cards. Only rank 0 prints and writes
``log.txt``, ``train_opt.txt`` and the checkpoints. ``--fp16`` runs under
a mesh as on one card: the global BatchNorms widen their bf16 input as
``models/precision.py``'s do, and the parameters and their averaged
gradients stay fp32.
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
from ..parallel.mesh import (
    broadcast_object,
    is_main,
    launch,
    local_device_count,
    main_first,
    main_prints,
    mesh_device,
    replicate,
    wants_mesh,
)
from ..utils import Logger, Timer
from ..utils.serialization import load_checkpoint, resume_checkpoint, save_checkpoint

SECTIONS = ("data", "model", "optim", "cluster", "train")


def main(argv=None, mesh=None):
    """Parse the flags (JAX's, plus ``--device``), tee stdout to
    ``<logs-dir>/log.txt``, write ``train_opt.txt``, load the dataset and
    run the loop. Returns the best mAP. ``mesh``: None spans every card
    when more than one is visible, False keeps one, a ``Mesh`` is this
    rank's (the module's docstring)."""
    argv = sys.argv[1:] if argv is None else argv
    extra = argparse.ArgumentParser(allow_abbrev=False)
    extra.add_argument("--device", default="cuda",
                       help="torch device; 'cpu' runs the plain versions of "
                            "the kernels")
    ns, rest = extra.parse_known_args(argv)
    cfg = parse_config(rest, sections=SECTIONS)
    device = resolve_device(ns.device)
    if wants_mesh(device, mesh):
        return launch(_main_on_rank, local_device_count(), args=(argv,))
    mesh = mesh or None
    logger = Logger(osp.join(cfg.train.logs_dir, "log.txt")) if is_main(mesh) else None
    if logger is not None:
        sys.stdout = logger
    try:
        with main_prints(mesh):
            if is_main(mesh):
                dump_config(cfg, cfg.train.logs_dir)
            print("==> Config written; starting USL training")
            dataset = main_first(mesh, lambda: create_dataset(
                cfg.data.dataset, cfg.data.data_dir, verbose=is_main(mesh)))
        return run(cfg, dataset, None if mesh else device, mesh=mesh)
    finally:
        if logger is not None:
            sys.stdout = logger.console
            logger.close()


def _main_on_rank(mesh, argv):
    return main(argv, mesh=mesh)


def load_best(model, best_path, mesh=None):
    """Load ``best_path`` into ``model`` where rank 0 finds it, on every
    rank (rank 0's weights, ``replicate``). Returns whether it was found."""
    found = broadcast_object(mesh, osp.isfile(best_path))
    if found:
        if is_main(mesh):
            model.load_state_dict(load_checkpoint(best_path)["state_dict"])
        replicate(mesh, model)
    return found


def _checkpoint(model, epoch, best_map):
    return {"state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "epoch": epoch, "best_mAP": best_map}


def run(cfg, dataset, device=None, image_cache=None, on_cluster=None, mesh=None):
    """The epoch loop and the final best-model eval (train_usl.py:86-159)
    on ``dataset`` (``.train``, ``.query``, ``.gallery`` lists of
    ``(fname, pid, camid)``), on ``device`` (default: the card).
    ``image_cache`` goes to every ``Preprocessor`` the loop builds (default:
    the shared decode cache); ``on_cluster`` to every ``cluster_epoch``.
    With ``mesh`` (a ready ``Mesh``, on every rank) the loop runs on the
    rank's card over the mesh; only rank 0 prints and writes files.
    Returns the best mAP, or the eval's (cmc, mAP) with ``--evaluate``."""
    with main_prints(mesh):
        return _run(cfg, dataset, mesh_device(mesh, device), image_cache, on_cluster,
                    mesh)


def _run(cfg, dataset, device, image_cache, on_cluster, mesh):
    start = time.monotonic()
    cache = "default" if image_cache is None else image_cache
    # TF32 convolutions as in cli/test.py; every distance product stays fp32
    torch.backends.cudnn.allow_tf32 = True
    torch.manual_seed(cfg.train.seed)
    model = create_model(cfg.model.arch, num_features=cfg.model.features,
                         norm=cfg.model.norm, dropout=cfg.model.dropout,
                         pooling_type=cfg.model.pooling_type,
                         dtype=torch.bfloat16 if cfg.train.fp16 else None)
    start_epoch = 0
    if cfg.train.resume:
        start_epoch, best = resume_checkpoint(cfg.train.resume, model)
        print(f"=> Resumed from epoch {start_epoch} (best mAP {best:.1%})")

    extractor = FeatureExtractor(model, height=cfg.data.height, width=cfg.data.width,
                                 batch_size=cfg.data.batch_size, device=device,
                                 mesh=mesh)
    replicate(mesh, model)           # rank 0's weights, on the rank's card
    evaluator = Evaluator(extractor)
    test_pre = Preprocessor(list(dataset.query) + list(dataset.gallery), mode="reid",
                            height=cfg.data.height, width=cfg.data.width, cache=cache)
    test_loader = DataLoader(test_pre, batch_size=cfg.data.batch_size,
                             drop_last=False, num_workers=cfg.data.workers, shard=mesh)

    if cfg.train.evaluate:
        return evaluator.evaluate(test_loader, dataset.query, dataset.gallery,
                                  cmc_flag=True)

    trainer = ClusterContrastTrainer(
        model, height=cfg.data.height, width=cfg.data.width, temp=cfg.cluster.temp,
        momentum=cfg.cluster.momentum, use_hard=cfg.cluster.use_hard,
        lr=cfg.optim.lr, weight_decay=cfg.optim.weight_decay,
        step_size=cfg.optim.step_size, iters_per_epoch=cfg.train.iters,
        num_instances=cfg.data.num_instances, device=device, mesh=mesh)

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
                                   seed=cfg.train.seed + epoch, cache=cache,
                                   shard=mesh)
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
            if is_main(mesh):
                save_checkpoint(_checkpoint(model, epoch + 1, best_map), is_best,
                                osp.join(logs_dir, "checkpoint.pth.tar"))
            print(f"\n * Finished epoch {epoch:3d}  model mAP: {mAP:5.1%} "
                  f" best: {best_map:5.1%}{' *' if is_best else ''}\n")

    # the final full-CMC eval with the best checkpoint (parity:
    # ...infomap.py:518-521 'Test with the best model')
    if state is not None and load_best(model, osp.join(logs_dir, "model_best.pth.tar"),
                                       mesh):
        print("==> Test with the best model:")
        evaluator.evaluate(test_loader, dataset.query, dataset.gallery, cmc_flag=True)

    dt = time.monotonic() - start
    print(f"Total running time: {dt / 3600:.0f}h {dt % 3600 / 60:.0f}m {dt % 60:.0f}s")
    return best_map


if __name__ == "__main__":
    main()
