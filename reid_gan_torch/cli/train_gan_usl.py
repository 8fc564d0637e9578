"""Joint GAN + unsupervised re-ID training CLI (port of
``reid_gan_tpu/cli/train_gan_usl.py``; parity: CC/examples/
cluster_contrast_gan_train_usl_infomap.py). The live joint command
``--model AE --model-gen Pose``, and the AE hard-mix command ``--model AE
--model-gen AE --no-gan-train``, usually after the GAN warm-up
(``cli/train_gan_warmup``) with ``--continue-train`` (the bip and
learnable-memory commands are below):

    python -m reid_gan_torch.cli.train_gan_usl --dataset market1501 \\
        --data-dir ./data --model AE --model-gen Pose --cluster-backend infomap \\
        [--device cuda]
    python -m reid_gan_torch.cli.train_gan_usl --dataset market1501 \\
        --data-dir ./data --model AE --model-gen AE --no-gan-train --continue-train

Per epoch: re-clustering and the bank (as ``cli/train_usl``), then the
mode: ``train_reid`` (the USL step) for the first ``--warmup-epo`` epochs,
then, with the GAN trained, ``train_all_bip`` with ``--bipath``, else
``train_all_with_memory`` with ``--learnable-memory`` (trainable clusters
rebuilt each epoch from the bank, stepped with ``--cluster-lr``), else
``train_all`` (the joint steps, ``engine/gan_trainers.py``), or with
``--no-gan-train`` ``train`` (the hard-mix step, G frozen); every
``--eval-step`` epochs eval and ``checkpoint.pth.tar``; after each epoch of a
mode that trains the GAN, the GAN nets' ``latest_net_{G,D}.pth`` and
``iter.txt`` under ``<save-dir>/<name>``, the linear learning-rate decay of G
and D, and the epoch's losses in ``loss_log.txt``. ``--continue-train``
reloads the nets and the epoch counter. Runs on the card unless ``--device
cpu`` is given. ``train_all`` and ``train_all_with_memory`` need the pose
generator, ``train_all_bip`` the AE generator and a ``resnet_bip*`` encoder,
``train`` the AE generator; another pairing, and ``--model DPTN`` (whose
engine has none of the modes' synthesis), raises ``ValueError``:

    python -m reid_gan_torch.cli.train_gan_usl --dataset market1501 \\
        --data-dir ./data --arch resnet_bip50 --model AE --model-gen AE --bipath
    python -m reid_gan_torch.cli.train_gan_usl --dataset market1501 \\
        --data-dir ./data --model AE --model-gen Pose --learnable-memory

``--use-vgg`` adds the VGG19 perceptual
loss of the fake against the GAN image to the joint step's G loss, with the
torchvision-layout weights of ``--vgg-weights`` or random taps.

``--cluster-with-gan-features``: every extraction (the clustering pass and
the evals) also pools the encoder's GAN map (kernel K11), the bank gets a
GAN half of the clusters' mean GAN features, folded each step beside the
main one (K7), and from the epoch after ``--warmup-epo`` on the joint loss
weighs each sample by ``compute_conf_weight`` (K9, K10). As in the JAX
loop, the weights are computed under ``--no-gan-train``, ``--bipath`` and
``--learnable-memory`` too, where those modes' steps do not read them.

``--resume`` restores the encoder and the epoch counter (the later of its
and ``iter.txt``'s) from the port's ``.pth.tar`` or the JAX package's flax
``.msgpack``; ``--continue-train`` loads each GAN net from
``{which_epoch}_net_{G,D}.pth`` or the JAX package's ``.msgpack``
(train_gan_usl.py:106-133). ``--fp16`` runs the encoder's backbone and the
GAN nets in bf16 as the JAX package does (``models/precision.py``), in every
mode; VGG19 stays fp32.

Several cards (train_gan_usl.py:88-93): with more than one card visible and
no ``--device cpu``, ``main`` runs one process a card over all of them, a
data mesh for every mode (``train_reid``, ``train_all`` with either GAN
loss, the hard-mix ``train`` of ``--no-gan-train``, ``train_all_bip`` and
``train_all_with_memory``; ``engine/gan_trainers.py``); ``main(argv,
mesh=False)`` keeps one card. Only rank 0 prints and writes the logs, the
checkpoints, ``latest_net_{G,D}.pth`` and ``iter.txt``. ``--fp16`` runs
under a mesh in every mode.
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
from ..ops.cluster_memory import init_gradient_memory
from ..ops.pose import batch_cords_to_map
from ..ops.transforms import gan_input_transform
from ..parallel.mesh import (
    broadcast_object,
    is_main,
    launch,
    local_device_count,
    main_first,
    main_prints,
    mesh_device,
    wants_mesh,
)
from ..utils import Logger, Timer
from ..utils.serialization import (
    load_networks,
    resume_checkpoint,
    save_checkpoint,
    save_networks,
)
from ..utils.visualizer import Visualizer
from .train_usl import _checkpoint, load_best

SECTIONS = ("data", "model", "optim", "cluster", "train", "gan")


def reconstruction_losses(gan, pseudo_dataset, memory, cfg, pose_file=None,
                          cache="default"):
    """Each pseudo-labelled image's reconstruction loss (``get_L1_loss``,
    train_gan_usl.py:37-75; parity: ...infomap.py:384-428): the pose
    generator renders the image's cluster centroid, broadcast to the GAN
    map's (h/8, w/8), in the image's own pose (kernel K10 on its keypoints
    from ``pose_file``); the AE generator reconstructs the image; both
    against the GAN input (K9). G runs in eval mode on ``memory``'s device
    over an ``only_gan`` loader. Returns a (len(pseudo_dataset),) float32
    host array in the dataset's order."""
    gh, gw = cfg.data.gan_height, cfg.data.gan_width
    pre = Preprocessor(pseudo_dataset, mode="only_gan", gan_height=gh, gan_width=gw,
                       pose_file=pose_file, cache=cache)
    loader = DataLoader(pre, batch_size=cfg.data.batch_size, drop_last=False,
                        num_workers=cfg.data.workers)
    dev = memory.features.device
    dtype = next(gan.net_G.parameters()).dtype
    rec = np.zeros(len(pseudo_dataset), np.float32)
    with torch.no_grad():
        for batch in loader:
            xs = gan_input_transform(torch.from_numpy(np.ascontiguousarray(batch["Xs"]))
                                     .to(dev), gh, gw).to(dtype)
            if gan.model_gen == "Pose":
                feats = memory.features[torch.from_numpy(np.asarray(batch["pid"])).to(dev)]
                fmap = feats[:, :, None, None].expand(-1, -1, gh // 8, gw // 8)
                ps = batch_cords_to_map(
                    torch.from_numpy(np.asarray(batch["keypoints"], np.float32)).to(dev),
                    torch.from_numpy(np.asarray(batch["old_size"], np.float32)).to(dev),
                    gh, gw)
                fake = gan.synthesize_p(fmap.to(dtype), ps.to(dtype))
            else:
                fake = gan.apply_G(xs)
            rec[np.asarray(batch["index"])] = gan.get_L1_loss(fake, xs).cpu().numpy()
    return rec


def compute_conf_weight(gan, pseudo_dataset, memory, cfg, pose_file=None,
                        cache="default"):
    """The per-sample confidence weights of the joint loss (train_gan_usl.py:
    37-80): 1, and 0 for the ``len(pseudo_dataset) // num_instances``
    samples G reconstructs worst (``reconstruction_losses``)."""
    t0 = time.time()
    rec = reconstruction_losses(gan, pseudo_dataset, memory, cfg, pose_file, cache)
    conf = np.ones(len(rec), np.float32)
    conf[np.argsort(-rec)[:len(rec) // cfg.data.num_instances]] = 0.0
    print(f"calculate confidence weight cost time: {time.time() - t0:.1f}")
    return conf


def _check_generator(cfg):
    """The joint modes' generators and encoders: ``train_all`` and
    ``train_all_with_memory`` render from a feature map and pose maps (the
    pose generator), ``train_all_bip`` reconstructs the GAN images (the AE
    generator; JAX's ``apply_G(G, xs)``, gan_trainers.py:423, passes no
    pose) from a bi-path encoder's two branches (``fuse=False``, which only
    ``ResNetBip`` takes, :413-416), ``train`` encodes and decodes the GAN
    images (the AE generator). The JAX step fails on the other pairings (in
    ``synthesize_p``, ``apply_G``, ``synthesize_fc`` or the encoder's call),
    and on the DPTN engine, which has none of them (ROADMAP C, reference
    side)."""
    gen, arch = cfg.gan.model_gen, cfg.model.arch
    if cfg.gan.model == "DPTN":
        raise ValueError("--model DPTN: the joint modes render through the AE "
                         "engine's synthesize_p / synthesize_fc and "
                         "get_loss_G_train, which the DPTN engine does not have; "
                         "use --model AE")
    if not cfg.gan.gan_train:
        if gen != "AE":
            raise ValueError(f"--no-gan-train runs the hard-mix 'train' mode, which "
                             f"encodes and decodes the GAN images: it needs "
                             f"--model-gen AE, not {gen}")
        return
    if cfg.gan.bipath:
        if gen != "AE":
            raise ValueError(f"--bipath with --model-gen {gen}: the 'train_all_bip' "
                             f"mode reconstructs the GAN images with one input and "
                             f"needs --model-gen AE")
        if not arch.startswith("resnet_bip") or arch.startswith("resnet_bipd"):
            raise ValueError(f"--bipath with --arch {arch}: the 'train_all_bip' mode "
                             f"reads both branches of a bi-path encoder (fuse=False) "
                             f"and needs a resnet_bip* arch such as resnet_bip50")
        if cfg.gan.cluster_with_gan_features:
            raise ValueError("--bipath with --cluster-with-gan-features: the "
                             "extraction's test_all forward (the pooled GAN map) is "
                             "not in the bi-path encoder, on which the JAX extractor "
                             "fails too (evaluators.py:49, resnet_variants.py:55)")
    elif gen != "Pose":
        mode = "train_all_with_memory" if cfg.gan.learnable_memory else "train_all"
        raise ValueError(f"--model-gen {gen} with the GAN trained jointly: the "
                         f"'{mode}' mode renders from pose maps and needs "
                         f"--model-gen Pose; the AE generator runs the hard-mix "
                         f"'train' mode (--no-gan-train) or --bipath")


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
    _check_generator(cfg)
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
    return main(argv, mesh=mesh)


def _joint_mode(cfg):
    """The mode of the epochs after the warm-up (...infomap.py:450-466)."""
    if not cfg.gan.gan_train:
        return "train"
    return "train_all_bip" if cfg.gan.bipath else \
        "train_all_with_memory" if cfg.gan.learnable_memory else "train_all"


def run(cfg, dataset, device=None, image_cache=None, mesh=None):
    """The epoch loop and the final best-model eval (train_gan_usl.py:
    83-279) on ``dataset`` (``.train``, ``.query``, ``.gallery`` lists of
    ``(fname, pid, camid)``, and ``.train_pose_dir``, the keypoint CSV, where
    it has one), on ``device`` (default: the card). ``image_cache`` goes to
    every ``Preprocessor`` the loop builds (default: the shared decode
    cache). With ``mesh`` (a ready ``Mesh``, on every rank) the loop runs on
    the rank's card over the mesh; only rank 0 prints and writes files.
    Returns the best mAP."""
    _check_generator(cfg)
    with main_prints(mesh):
        return _run(cfg, dataset, mesh_device(mesh, device), image_cache, mesh)


def _run(cfg, dataset, device, image_cache, mesh):
    start = time.monotonic()
    cache = "default" if image_cache is None else image_cache
    pose_file = getattr(dataset, "train_pose_dir", None)
    # TF32 convolutions as in cli/train_usl; every other product stays fp32
    torch.backends.cudnn.allow_tf32 = True
    torch.manual_seed(cfg.train.seed)

    feat_dim = 512 if any(d in cfg.model.arch for d in ("18", "34")) else 2048
    dtype = torch.bfloat16 if cfg.train.fp16 else None
    gan = create_gan(cfg.gan, gan_height=cfg.data.gan_height,
                     gan_width=cfg.data.gan_width, reid_feat_dim=feat_dim,
                     seed=cfg.train.seed, device=device, dtype=dtype)
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
                         pooling_type=cfg.model.pooling_type, dtype=dtype)
    if cfg.train.resume:
        start_epoch = max(start_epoch, resume_checkpoint(cfg.train.resume, model)[0])

    extractor = FeatureExtractor(model, height=cfg.data.height, width=cfg.data.width,
                                 batch_size=cfg.data.batch_size, device=device,
                                 extra_features=cfg.gan.cluster_with_gan_features,
                                 mesh=mesh)
    evaluator = Evaluator(extractor)
    test_pre = Preprocessor(list(dataset.query) + list(dataset.gallery), mode="reid",
                            height=cfg.data.height, width=cfg.data.width, cache=cache)
    test_loader = DataLoader(test_pre, batch_size=cfg.data.batch_size,
                             drop_last=False, num_workers=cfg.data.workers, shard=mesh)
    # the trainer replicates the encoder, G and D at its first init_state
    trainer = ClusterContrastWithGANTrainer(
        model, gan, height=cfg.data.height, width=cfg.data.width,
        temp=cfg.cluster.temp, momentum=cfg.cluster.momentum,
        use_hard=cfg.cluster.use_hard, lr=cfg.optim.lr,
        weight_decay=cfg.optim.weight_decay, step_size=cfg.optim.step_size,
        iters_per_epoch=cfg.train.iters, num_instances=cfg.data.num_instances,
        device=device, mesh=mesh)
    visualizer = Visualizer(cfg.train.logs_dir, name=cfg.gan.name) \
        if is_main(mesh) else None

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
        # one epoch after the GAN joins, so G has trained before it scores
        # (train_gan_usl.py:182-185; config.py's gating note)
        conf_weight = None
        if cfg.gan.cluster_with_gan_features and epoch > cfg.gan.warmup_epo:
            with Timer("conf"):   # on rank 0, then broadcast
                conf_weight = broadcast_object(mesh, compute_conf_weight(
                    gan, pseudo_dataset, memory, cfg, pose_file, cache)
                    if is_main(mesh) else None)

        # the mode (...infomap.py:450-466; train_gan_usl.py:187-228): the USL
        # step while warming up, then a joint or the hard-mix step on the
        # with_gan loader
        joint = (epoch + 1) > cfg.gan.warmup_epo
        mode = _joint_mode(cfg) if joint else "train_reid"
        pre_kw = dict(mode="with_gan", gan_height=cfg.data.gan_height,
                      gan_width=cfg.data.gan_width, pose_file=pose_file,
                      flip_all=True) if joint else {}
        loader = make_train_loader(pseudo_dataset, cfg.data.height, cfg.data.width,
                                   cfg.data.batch_size, cfg.data.num_instances,
                                   workers=cfg.data.workers, iters=iters,
                                   seed=cfg.train.seed + epoch, cache=cache,
                                   shard=mesh, **pre_kw)
        # trainable clusters from this epoch's bank (train_gan_usl.py:212-221)
        gmem = init_gradient_memory(memory.features, k_pad=k_pad, device=device)._replace(
            num_valid=memory.num_valid) if mode == "train_all_with_memory" else None
        with Timer("train"):
            out = trainer.run_epoch(state, epoch, loader, mode=mode, train_iters=iters,
                                    print_freq=cfg.train.print_freq,
                                    base_seed=cfg.train.seed, conf_weight=conf_weight,
                                    gmem=gmem, cluster_lr=cfg.gan.cluster_lr)
        state, errs = (out[0], out[2]) if gmem is not None else out
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

        if joint and cfg.gan.gan_train:     # train_gan_usl.py:249-258
            if is_main(mesh):
                save_networks({"G": gan.net_G, "D": gan.net_D}, save_dir, "latest")
                np.savetxt(iter_path, [(epoch + 1, 0)], delimiter=",", fmt="%d")
                visualizer.print_current_errors(epoch, iters, errs)
            # LambdaLR linear decay after niter epochs (train_gan_usl.py:253-257)
            niter = max(1, epochs // 2)
            mult = 1.0 - max(0, epoch + 2 - niter) / float(epochs - niter + 1)
            state = state._replace(gan=gan.set_epoch_lr(state.gan, max(mult, 0.0)))

    # the final full-CMC eval with the best checkpoint (...infomap.py:518-521)
    if state is not None and load_best(model, osp.join(logs_dir, "model_best.pth.tar"),
                                       mesh):
        print("==> Test with the best model:")
        evaluator.evaluate(test_loader, dataset.query, dataset.gallery, cmc_flag=True)

    dt = time.monotonic() - start
    print("==> Training finished; best mAP {:5.1%}".format(best_map))
    print(f"Total running time: {dt / 3600:.0f}h {dt % 3600 / 60:.0f}m {dt % 60:.0f}s")
    return best_map


if __name__ == "__main__":
    main()
