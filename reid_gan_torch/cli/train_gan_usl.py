"""Joint GAN + unsupervised re-ID training CLI (port of
``reid_gan_tpu/cli/train_gan_usl.py``; parity: CC/examples/
cluster_contrast_gan_train_usl_infomap.py). Two recipes: the live joint
command ``--model AE --model-gen Pose``, and the AE hard-mix command
``--model AE --model-gen AE --no-gan-train``, usually after the GAN warm-up
(``cli/train_gan_warmup``) with ``--continue-train``:

    python -m reid_gan_torch.cli.train_gan_usl --dataset market1501 \\
        --data-dir ./data --model AE --model-gen Pose --cluster-backend infomap \\
        [--device cuda]
    python -m reid_gan_torch.cli.train_gan_usl --dataset market1501 \\
        --data-dir ./data --model AE --model-gen AE --no-gan-train --continue-train

Per epoch: re-clustering and the bank (as ``cli/train_usl``), then the
mode: ``train_reid`` (the USL step) for the first ``--warmup-epo`` epochs,
then ``train_all`` (the joint step, ``engine/gan_trainers.py``), or with
``--no-gan-train`` ``train`` (the hard-mix step, G frozen); every
``--eval-step`` epochs eval and ``checkpoint.pth.tar``; after a joint
``train_all`` epoch the GAN nets' ``latest_net_{G,D}.pth`` and ``iter.txt``
under ``<save-dir>/<name>``, the linear learning-rate decay of G and D, and
the epoch's losses in ``loss_log.txt``. ``--continue-train`` reloads the nets
and the epoch counter. Runs on the card unless ``--device cpu`` is given.
``train_all`` needs the pose generator and ``train`` the AE generator;
another pairing raises ``ValueError``.

Not ported yet, and raising with their ROADMAP items:
``--cluster-with-gan-features`` (the confidence weights and the GAN-feature
clustering), ``--bipath`` and ``--learnable-memory`` (the bip and
learnable-memory modes), ``--fp16`` and ``--resume`` of a flax msgpack
checkpoint.
"""

import argparse
import os.path as osp
import sys
import time

import numpy as np
import torch

from ..config import dump_config, parse_config
from ..data.datasets import create as create_dataset
from ..data.loader import DataLoader, Preprocessor
from ..device import resolve_device
from ..engine.evaluators import Evaluator, FeatureExtractor
from ..engine.gan_trainers import ClusterContrastWithGANTrainer
from ..engine.usl import cluster_epoch, make_train_loader
from ..models import create as create_model
from ..models.dual_gan.models import create_model as create_gan
from ..utils import Logger, Timer
from ..utils.serialization import (
    load_checkpoint,
    load_networks,
    save_checkpoint,
    save_networks,
)
from ..utils.visualizer import Visualizer
from .train_usl import _checkpoint

SECTIONS = ("data", "model", "optim", "cluster", "train", "gan")


def _refuse_unported(cfg):
    unported = (
        (cfg.gan.cluster_with_gan_features,
         "--cluster-with-gan-features (compute_conf_weight and the GAN-feature "
         "clustering) is not ported yet (ROADMAP A: GAN-feature clustering)"),
        (cfg.gan.bipath, "--bipath (the train_all_bip mode) is not ported yet "
                         "(ROADMAP A: bip and learnable-memory modes)"),
        (cfg.gan.learnable_memory, "--learnable-memory (the train_all_with_memory "
                                   "mode) is not ported yet "
                                   "(ROADMAP A: bip and learnable-memory modes)"),
        (cfg.train.fp16, "--fp16 (bf16 parameters) is not ported yet "
                         "(ROADMAP A: `--fp16`)"),
        (cfg.train.resume.endswith(".msgpack"),
         "--resume of a flax msgpack checkpoint is not ported yet "
         "(ROADMAP A: msgpack checkpoints); "
         "resume from the port's checkpoint.pth.tar"),
    )
    for bad, msg in unported:
        if bad:
            raise NotImplementedError(msg)


def _check_generator(cfg):
    """The joint modes' generators: ``train_all`` renders from the encoder's
    GAN map and pose maps (the pose generator), ``train`` encodes and decodes
    the GAN images (the AE generator). The JAX step fails on the other
    pairings too (in ``synthesize_p`` and ``synthesize_fc``)."""
    gen = cfg.gan.model_gen
    if cfg.gan.gan_train and gen == "AE":
        raise ValueError("--model-gen AE with the GAN trained jointly: the "
                         "'train_all' mode renders from pose maps and needs "
                         "--model-gen Pose; the AE generator runs the hard-mix "
                         "'train' mode (--no-gan-train)")
    if not cfg.gan.gan_train and gen != "AE":
        raise ValueError(f"--no-gan-train runs the hard-mix 'train' mode, which "
                         f"encodes and decodes the GAN images: it needs "
                         f"--model-gen AE, not {gen}")


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
    _refuse_unported(cfg)
    _check_generator(cfg)
    logger = Logger(osp.join(cfg.train.logs_dir, "log.txt"))
    sys.stdout = logger
    try:
        dump_config(cfg, cfg.train.logs_dir, sections=SECTIONS)
        dataset = create_dataset(cfg.data.dataset, cfg.data.data_dir, verbose=True)
        return run(cfg, dataset, device)
    finally:
        sys.stdout = logger.console
        logger.close()


def run(cfg, dataset, device=None, image_cache=None):
    """The epoch loop and the final best-model eval (train_gan_usl.py:
    83-279) on ``dataset`` (``.train``, ``.query``, ``.gallery`` lists of
    ``(fname, pid, camid)``, and ``.train_pose_dir``, the keypoint CSV, where
    it has one), on ``device`` (default: the card). ``image_cache`` goes to
    every ``Preprocessor`` the loop builds (default: the shared decode
    cache). Returns the best mAP."""
    _refuse_unported(cfg)
    _check_generator(cfg)
    device = resolve_device(device)
    start = time.monotonic()
    cache = "default" if image_cache is None else image_cache
    pose_file = getattr(dataset, "train_pose_dir", None)
    # TF32 convolutions as in cli/train_usl; every other product stays fp32
    torch.backends.cudnn.allow_tf32 = True
    torch.manual_seed(cfg.train.seed)

    feat_dim = 512 if any(d in cfg.model.arch for d in ("18", "34")) else 2048
    gan = create_gan(cfg.gan, gan_height=cfg.data.gan_height,
                     gan_width=cfg.data.gan_width, reid_feat_dim=feat_dim,
                     device=device)
    save_dir = osp.join(cfg.gan.save_dir, cfg.gan.name)
    iter_path = osp.join(save_dir, "iter.txt")
    start_epoch = 0
    if cfg.gan.continue_train:
        # the GAN nets and the epoch counter (...infomap.py:249-259)
        load_networks({"G": gan.net_G, "D": gan.net_D}, save_dir, cfg.gan.which_epoch)
        if osp.isfile(iter_path):
            start_epoch = int(np.loadtxt(iter_path, delimiter=",",
                                         dtype=int).reshape(-1)[0])
            print(f"Resuming from epoch {start_epoch}")
    gan_state = gan.init_state()

    model = create_model(cfg.model.arch, norm=cfg.model.norm,
                         pooling_type=cfg.model.pooling_type)
    if cfg.train.resume:
        ckpt = load_checkpoint(cfg.train.resume)
        model.load_state_dict(ckpt["state_dict"])
        start_epoch = max(start_epoch, int(ckpt["epoch"]))

    extractor = FeatureExtractor(model, height=cfg.data.height, width=cfg.data.width,
                                 batch_size=cfg.data.batch_size, device=device)
    evaluator = Evaluator(extractor)
    test_pre = Preprocessor(list(dataset.query) + list(dataset.gallery), mode="reid",
                            height=cfg.data.height, width=cfg.data.width, cache=cache)
    test_loader = DataLoader(test_pre, batch_size=cfg.data.batch_size,
                             drop_last=False, num_workers=cfg.data.workers)
    trainer = ClusterContrastWithGANTrainer(
        model, gan, height=cfg.data.height, width=cfg.data.width,
        temp=cfg.cluster.temp, momentum=cfg.cluster.momentum,
        use_hard=cfg.cluster.use_hard, lr=cfg.optim.lr,
        weight_decay=cfg.optim.weight_decay, step_size=cfg.optim.step_size,
        iters_per_epoch=cfg.train.iters, num_instances=cfg.data.num_instances,
        device=device)
    visualizer = Visualizer(cfg.train.logs_dir, name=cfg.gan.name)

    epochs = 1 if cfg.train.debug else cfg.train.epochs
    iters = 8 if cfg.train.debug else cfg.train.iters
    state = None
    best_map = 0.0
    k_pad = cfg.cluster.max_clusters or None
    logs_dir = cfg.train.logs_dir

    for epoch in range(start_epoch, epochs):
        memory, pseudo_dataset, _ = cluster_epoch(
            extractor, list(dataset.train), cfg, k_pad=k_pad, cache=cache)
        k_pad = memory.features.shape[0]  # sticky: the bank keeps its shape
        state = trainer.init_state(memory, gan_state) if state is None else \
            trainer.set_memory(state, memory)

        # the mode (...infomap.py:450-466): the USL step while warming up,
        # then the joint or the hard-mix step on the with_gan loader
        joint = (epoch + 1) > cfg.gan.warmup_epo
        mode = ("train_all" if cfg.gan.gan_train else "train") if joint \
            else "train_reid"
        pre_kw = dict(mode="with_gan", gan_height=cfg.data.gan_height,
                      gan_width=cfg.data.gan_width, pose_file=pose_file,
                      flip_all=True) if joint else {}
        loader = make_train_loader(pseudo_dataset, cfg.data.height, cfg.data.width,
                                   cfg.data.batch_size, cfg.data.num_instances,
                                   workers=cfg.data.workers, iters=iters,
                                   seed=cfg.train.seed + epoch, cache=cache, **pre_kw)
        with Timer("train"):
            state, errs = trainer.run_epoch(state, epoch, loader, mode=mode,
                                            train_iters=iters,
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

        if mode == "train_all":
            save_networks({"G": gan.net_G, "D": gan.net_D}, save_dir, "latest")
            np.savetxt(iter_path, [(epoch + 1, 0)], delimiter=",", fmt="%d")
            # LambdaLR linear decay after niter epochs (train_gan_usl.py:253-257)
            niter = max(1, epochs // 2)
            mult = 1.0 - max(0, epoch + 2 - niter) / float(epochs - niter + 1)
            state = state._replace(gan=gan.set_epoch_lr(state.gan, max(mult, 0.0)))
            visualizer.print_current_errors(epoch, iters, errs)

    # the final full-CMC eval with the best checkpoint (...infomap.py:518-521)
    best_path = osp.join(logs_dir, "model_best.pth.tar")
    if osp.isfile(best_path) and state is not None:
        print("==> Test with the best model:")
        model.load_state_dict(load_checkpoint(best_path)["state_dict"])
        evaluator.evaluate(test_loader, dataset.query, dataset.gallery, cmc_flag=True)

    dt = time.monotonic() - start
    print("==> Training finished; best mAP {:5.1%}".format(best_map))
    print(f"Total running time: {dt / 3600:.0f}h {dt % 3600 / 60:.0f}m {dt % 60:.0f}s")
    return best_map


if __name__ == "__main__":
    main()
