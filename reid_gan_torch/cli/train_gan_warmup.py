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
here starts from them too, or from the JAX package's
``{which_epoch}_net_{G,D}.msgpack`` (train_gan_warmup.py:49-53). ``--fp16``
runs G and D in bf16 as the JAX package does (``models/precision.py``). ``--use-vgg`` adds the VGG19 perceptual loss to
the G step, with the torchvision-layout weights of ``--vgg-weights`` or
random taps. Runs on the card unless ``--device cpu`` is given.

Several cards (train_gan_warmup.py:37-42,66): with more than one card
visible and no ``--device cpu``, ``main`` runs one process a card over all
of them, a data mesh (``GANTrainer``: the ``only_gan`` batches sharded, G's
and D's BatchNorms over the whole batch, their gradients averaged before
each Adam step); ``main(argv, mesh=False)`` keeps one card. Only rank 0
prints and writes the logs and ``latest_net_{G,D}.pth``. ``--fp16`` runs
under a mesh too.

The standalone step drives the AE generator: the other generators raise
``ValueError`` before any work, where the JAX CLI fails in its first step
(ROADMAP C, reference side): ``Pose``, ``DEC`` and ``FD`` are not stepped
standalone, and ``PoseAE`` and ``--model DPTN`` need pose maps, which the
``only_gan`` batches do not carry (they carry keypoints).
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
from ..parallel.mesh import (
    is_main,
    launch,
    local_device_count,
    main_first,
    main_prints,
    mesh_device,
    wants_mesh,
)
from ..utils import Logger
from ..utils.serialization import load_networks, save_networks
from ..utils.visualizer import Visualizer

SECTIONS = ("data", "model", "optim", "cluster", "train", "gan")


def _check(cfg):
    gen = cfg.gan.model_gen
    if cfg.gan.model == "DPTN" or gen == "PoseAE":
        what = "--model DPTN" if cfg.gan.model == "DPTN" else "--model-gen PoseAE"
        raise ValueError(f"{what} steps on pose maps, and the warm-up's only_gan "
                         f"batches carry keypoints, not pose maps: the GAN warm-up "
                         f"trains the AE generator (--model-gen AE)")
    if gen == "Pose":
        raise ValueError("the GAN warm-up's standalone step trains the AE "
                         "generator (--model-gen AE); the joint trainer drives "
                         "the pose generator")
    if gen != "AE":
        raise ValueError(f"optimize_parameters supports AE/PoseAE; {gen} is driven "
                         f"by the joint trainer: the GAN warm-up trains the AE "
                         f"generator (--model-gen AE)")


def main(argv=None, mesh=None):
    """Parse the flags (JAX's, plus ``--device``), tee stdout to
    ``<logs-dir>/log.txt``, write ``train_opt.txt``, load the dataset and
    run the warm-up. Returns the engine's state, or, spanning several cards,
    the number of steps rank 0 took. ``mesh``: None spans every card when
    more than one is visible, False keeps one, a ``Mesh`` is this rank's
    (the module's docstring)."""
    argv = sys.argv[1:] if argv is None else argv
    extra = argparse.ArgumentParser(allow_abbrev=False)
    extra.add_argument("--device", default="cuda",
                       help="torch device; 'cpu' runs the plain versions of "
                            "the kernels")
    ns, rest = extra.parse_known_args(argv)
    cfg = parse_config(rest, sections=SECTIONS)
    device = resolve_device(ns.device)
    _check(cfg)
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
            dataset = main_first(mesh, lambda: create_dataset(
                cfg.data.dataset, cfg.data.data_dir, verbose=is_main(mesh)))
        return run(cfg, dataset, None if mesh else device, mesh=mesh)
    finally:
        if logger is not None:
            sys.stdout = logger.console
            logger.close()


def _main_on_rank(mesh, argv):
    # the nets stay on the ranks' cards: rank 0's step count goes back
    return main(argv, mesh=mesh).step


def run(cfg, dataset, device=None, image_cache=None, mesh=None):
    """The warm-up (train_gan_warmup.py:32-77) on ``dataset`` (``.train``, a
    list of ``(fname, pid, camid)``, and ``.train_pose_dir`` where it has
    one), on ``device`` (default: the card). ``image_cache`` goes to the
    ``Preprocessor`` (default: the shared decode cache). With ``mesh`` (a
    ready ``Mesh``, on every rank) it runs on the rank's card over the mesh;
    only rank 0 prints and writes files. Returns the engine's state
    (``AEState``: the nets, trained in place, and their optimizers)."""
    _check(cfg)
    with main_prints(mesh):
        return _run(cfg, dataset, mesh_device(mesh, device), image_cache, mesh)


def _run(cfg, dataset, device, image_cache, mesh):
    # TF32 convolutions as in the training CLIs; every other product stays fp32
    torch.backends.cudnn.allow_tf32 = True
    torch.manual_seed(cfg.train.seed)
    gan = create_gan(cfg.gan, gan_height=cfg.data.gan_height,
                     gan_width=cfg.data.gan_width, seed=cfg.train.seed, device=device,
                     dtype=torch.bfloat16 if cfg.train.fp16 else None)
    gan_state = gan.init_state()
    save_dir = osp.join(cfg.gan.save_dir, cfg.gan.name)
    if cfg.gan.continue_train:
        load_networks({"G": gan.net_G, "D": gan.net_D}, save_dir, cfg.gan.which_epoch)

    # the AE generator takes no keypoints (``_check`` refuses the generators
    # that would need their pose maps)
    pre = Preprocessor(list(dataset.train), mode="only_gan",
                       gan_height=cfg.data.gan_height, gan_width=cfg.data.gan_width,
                       cache="default" if image_cache is None else image_cache)
    loader = DataLoader(pre, batch_size=cfg.data.batch_size, shuffle=True,
                        num_workers=cfg.data.workers, drop_last=True,
                        seed=cfg.train.seed, shard=mesh)
    it = IterLoader(loader)
    it.new_epoch()
    trainer = GANTrainer(gan, print_freq=cfg.train.print_freq, device=device, mesh=mesh)
    visualizer = Visualizer(cfg.train.logs_dir, name=cfg.gan.name) \
        if is_main(mesh) else None

    epochs = 1 if cfg.train.debug else cfg.train.epochs
    iters = 4 if cfg.train.debug else (len(loader) or cfg.train.iters)
    try:
        for epoch in range(epochs):
            gan_state, errs = trainer.train_gan(gan_state, epoch, it,
                                                train_iters=iters,
                                                base_seed=cfg.train.seed)
            if is_main(mesh):
                visualizer.print_current_errors(epoch, iters, errs)
                save_networks({"G": gan.net_G, "D": gan.net_D}, save_dir, "latest")
    finally:
        it.close()
    return gan_state


if __name__ == "__main__":
    main()
