"""Standalone GAN pre-training CLI, the warm-up of the AE hard-mix recipe
(port of ``reid_gan_tpu/cli/train_gan_warmup.py``; parity: CC/run_code.sh:
7-17 and CC/clustercontrast/trainers.py:273-335):

    python -m reid_gan_torch.cli.train_gan_warmup --dataset market1501 \\
        --data-dir ./data --model AE --model-gen AE [--device cuda]

Trains the AE generator and the spectral-norm discriminator on the GAN
images of the train set alone (the ``only_gan`` loader, shuffled, batch
``--batch-size``), one D→G iteration per batch through
``GANTrainer.train_gan``, for ``--epochs`` passes over the set (``--debug``:
1 epoch of 4 iterations). After each epoch the mean losses go to
``loss_log.txt`` and the nets to ``<save-dir>/<name>/latest_net_{G,D}.pth``,
which ``cli/train_gan_usl --continue-train`` loads. ``--continue-train``
here starts from them too. Runs on the card unless ``--device cpu`` is
given. ``--model-gen Pose`` raises ``ValueError`` (the joint trainer drives
the pose generator); ``--fp16`` is not ported yet
(ROADMAP A: `--fp16`).
"""

import argparse
import os.path as osp
import sys

import torch

from ..config import dump_config, parse_config
from ..data import IterLoader
from ..data.datasets import create as create_dataset
from ..data.loader import DataLoader, Preprocessor
from ..device import resolve_device
from ..engine.gan_trainers import GANTrainer
from ..models.dual_gan.models import create_model as create_gan
from ..utils import Logger
from ..utils.serialization import load_networks, save_networks
from ..utils.visualizer import Visualizer

SECTIONS = ("data", "model", "optim", "cluster", "train", "gan")


def _check(cfg):
    if cfg.train.fp16:
        raise NotImplementedError("--fp16 (bf16 parameters) is not ported yet "
                                  "(ROADMAP A: `--fp16`)")
    if cfg.gan.model_gen == "Pose":
        raise ValueError("the GAN warm-up's standalone step trains the AE "
                         "generator (--model-gen AE); the joint trainer drives "
                         "the pose generator")


def main(argv=None):
    """Parse the flags (JAX's, plus ``--device``), tee stdout to
    ``<logs-dir>/log.txt``, write ``train_opt.txt``, load the dataset and
    run the warm-up. Returns the engine's state."""
    argv = sys.argv[1:] if argv is None else argv
    extra = argparse.ArgumentParser(allow_abbrev=False)
    extra.add_argument("--device", default="cuda",
                       help="torch device; 'cpu' runs the plain versions of "
                            "the kernels")
    ns, rest = extra.parse_known_args(argv)
    cfg = parse_config(rest, sections=SECTIONS)
    device = resolve_device(ns.device)
    _check(cfg)
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
    """The warm-up (train_gan_warmup.py:32-77) on ``dataset`` (``.train``, a
    list of ``(fname, pid, camid)``, and ``.train_pose_dir`` where it has
    one), on ``device`` (default: the card). ``image_cache`` goes to the
    ``Preprocessor`` (default: the shared decode cache). Returns the
    engine's state (``AEState``: the nets, trained in place, and their
    optimizers)."""
    _check(cfg)
    device = resolve_device(device)
    # TF32 convolutions as in the training CLIs; every other product stays fp32
    torch.backends.cudnn.allow_tf32 = True
    torch.manual_seed(cfg.train.seed)
    gan = create_gan(cfg.gan, gan_height=cfg.data.gan_height,
                     gan_width=cfg.data.gan_width, device=device)
    gan_state = gan.init_state()
    save_dir = osp.join(cfg.gan.save_dir, cfg.gan.name)
    if cfg.gan.continue_train:
        load_networks({"G": gan.net_G, "D": gan.net_D}, save_dir, cfg.gan.which_epoch)

    # the AE generator takes no keypoints; the pose generators' warm-up is
    # not ported yet (ROADMAP A: other generators and DPTN)
    pre = Preprocessor(list(dataset.train), mode="only_gan",
                       gan_height=cfg.data.gan_height, gan_width=cfg.data.gan_width,
                       cache="default" if image_cache is None else image_cache)
    loader = DataLoader(pre, batch_size=cfg.data.batch_size, shuffle=True,
                        num_workers=cfg.data.workers, drop_last=True,
                        seed=cfg.train.seed)
    it = IterLoader(loader)
    it.new_epoch()
    trainer = GANTrainer(gan, print_freq=cfg.train.print_freq, device=device)
    visualizer = Visualizer(cfg.train.logs_dir, name=cfg.gan.name)

    epochs = 1 if cfg.train.debug else cfg.train.epochs
    iters = 4 if cfg.train.debug else (len(loader) or cfg.train.iters)
    try:
        for epoch in range(epochs):
            gan_state, errs = trainer.train_gan(gan_state, epoch, it,
                                                train_iters=iters,
                                                base_seed=cfg.train.seed)
            visualizer.print_current_errors(epoch, iters, errs)
            save_networks({"G": gan.net_G, "D": gan.net_D}, save_dir, "latest")
    finally:
        it.close()
    return gan_state


if __name__ == "__main__":
    main()
