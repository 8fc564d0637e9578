"""FD-GAN stages II and III, the adversarial training (port of
``reid_gan_tpu/cli/fdgan_train.py``; parity: FD/train.py, the pose-pair
loader, ``FDGANModel`` one step a batch, the per-epoch lr decay, the per-net
saves; the stage by ``--stage 1|2``):

    python -m reid_gan_torch.cli.fdgan_train --dataset market1501 --data-dir ./data \\
        --stage 1 --netE-pretrain logs/baseline/model_best.pth.tar [--device cuda]
    python -m reid_gan_torch.cli.fdgan_train ... --stage 2 \\
        --netE-pretrain ckpt/experiment/best_net_E.pth --netG-pretrain ... \\
        --netDi-pretrain ... --netDp-pretrain ...

Stage 1 (paper stage II) loads E from the stage-I checkpoint of
``cli/fdgan_baseline`` and Di from it with the verifier's positive row;
stage 2 (paper stage III) loads each net from its stage-1 file. Each step
renders the pose maps (kernel K13) and augments the origins and targets
(K14). After each epoch the losses go to ``loss_log.txt``, the fake to
``images/``, and every ``--save-step`` epochs (and after the last) the nets
to ``<save-dir>/<name>/latest_net_{E,G,Di,Dp}.pth``. Stage 2 also evaluates
every ``--eval-step`` epochs on the val split (query/gallery when there is
none) with ``CascadeEvaluator`` over E, saves ``best_net_*`` on a new best
mAP and, after the run, tests the best E (FD/train.py:96-116). ``--debug``:
ResNet-18 nets, one epoch of 2 iterations. Runs on the card unless
``--device cpu`` is given.

Several cards (fdgan_train.py:73-78): with more than one card visible and
no ``--device cpu``, ``main`` runs one process a card over all of them
(``parallel.launch``): every rank loads the pretrained nets, decodes its
slice of each pair batch and of each eval batch, and the steps and the
evaluations are those of one device on the whole batch
(``models/fdgan/model.py``); the printed losses are the whole batch's, and
only rank 0 prints and writes ``log.txt``, ``opt.txt``, the images, the
loss log and the nets. The mesh size must divide the batch size. Every
rank draws each target as this process would: the launch passes its order
of each id's names (``fdgan_baseline.run_main``).
``main(argv, mesh=False)`` keeps one card.
"""

import argparse
import os.path as osp
import sys
import time

import torch

from ..config import parse_config
from ..data.loader import DataLoader, Preprocessor
from ..data.sampler import RandomPairSampler
from ..device import resolve_device
from ..models.fdgan.model import FDGANModel
from ..parallel.mesh import is_main, main_prints, mesh_device, replicate
from ..utils import AverageMeter
from ..utils.serialization import load_networks, save_networks
from ..utils.visualizer import Visualizer
from .fdgan_baseline import _limit, make_cascade_evaluator, run_main

SECTIONS = ("data", "model", "optim", "train", "gan", "fdgan")


def main(argv=None, mesh=None, pid_imgs=None):
    """Parse the flags (JAX's, plus ``--device``), tee stdout to
    ``<logs-dir>/log.txt``, write ``opt.txt``, load the dataset and train.
    Returns the engine where this process trains (one card, or this rank
    of ``mesh``); None where it spawns a rank a card, whose engines stay on
    their cards. ``mesh``:
    None spans every card when more than one is visible, False keeps one, a
    ``Mesh`` is this rank's (the module's docstring). ``pid_imgs``: the
    pid → image names lists the ``fdgan_pose`` targets are drawn from in
    place of the dataset's sets (``fdgan_baseline.run_main``; a launch
    passes its own to its ranks)."""
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
    main(argv, mesh=mesh, pid_imgs=pid_imgs)


def run(cfg, dataset, device=None, image_cache=None, mesh=None):
    """Stages II/III (fdgan_train.py:65-203) on ``dataset`` (``.train``,
    ``.query``, ``.gallery``, ``.pid_imgs`` and ``.poses_dir``, the landmark
    files; the image names relative to ``.images_dir`` where it has one), on
    ``device`` (default: the card). ``image_cache`` goes to every
    ``Preprocessor`` (default: the shared decode cache). With ``mesh`` (a
    ready ``Mesh``, on every rank) the run is sharded over it and only rank
    0 prints and writes. Returns the engine."""
    with main_prints(mesh):
        return _run(cfg, dataset, mesh_device(mesh, device), image_cache, mesh)


def _run(cfg, dataset, device, image_cache, mesh):
    # TF32 convolutions as in the training CLIs; every other product stays fp32
    torch.backends.cudnn.allow_tf32 = True
    cache = "default" if image_cache is None else image_cache
    h, w = cfg.data.height, cfg.data.width
    torch.manual_seed(cfg.train.seed)
    model = FDGANModel(cfg.fdgan, height=h, width=w, depth=18 if cfg.train.debug else 50,
                       device=device, seed=cfg.train.seed, mesh=mesh)
    save_dir = osp.join(cfg.gan.save_dir, cfg.gan.name)
    if cfg.gan.continue_train:
        load_networks(model.nets(), save_dir, cfg.gan.which_epoch)
        for net in model.nets().values():
            replicate(mesh, net)
    train = list(dataset.train)
    root = getattr(dataset, "images_dir", None)   # the JSON datasets' names are relative
    pre = Preprocessor(train, root=root, mode="fdgan_pose", height=h, width=w,
                       pid_imgs=dataset.pid_imgs, pose_root=getattr(dataset, "poses_dir", None),
                       seed=cfg.train.seed, cache=cache)
    visualizer = Visualizer(cfg.train.logs_dir, name=cfg.gan.name) if is_main(mesh) \
        else None

    # stage 2: periodic validation with best tracking (FD/train.py:96-103);
    # datasets without a val split validate on query/gallery
    evaluator = val_loader = None
    best_map = 0.0
    query, gallery = list(dataset.query), list(dataset.gallery)

    def reid_loader(items):
        return DataLoader(Preprocessor(items, root=root, mode="reid", height=h, width=w,
                                       cache=cache),
                          batch_size=cfg.data.batch_size, drop_last=False,
                          num_workers=cfg.data.workers, shard=mesh)

    if cfg.fdgan.stage != 1:
        evaluator = make_cascade_evaluator(model.net_E, cfg, device, mesh)
        val = list(getattr(dataset, "val", None) or [])
        val_query, val_gallery = (val, val) if val else (query, gallery)
        val_loader = reid_loader(sorted(set(val_query) | set(val_gallery)))
        if not cfg.train.debug:
            print("Test with baseline model:")
            evaluator.evaluate(reid_loader(query + gallery), query, gallery,
                               rerank_topk=min(75, len(gallery) - 1),
                               dataset=cfg.data.dataset)

    epochs = 1 if cfg.train.debug else cfg.fdgan.niter + cfg.fdgan.niter_decay
    nets = model.nets()
    for epoch in range(epochs):
        model.set_epoch_lr(epoch)
        meters, buf = {}, []

        def drain():
            if buf:
                names = list(buf[0])
                # the whole batch's losses: one reduction a print window
                vals = model.global_errors({k: torch.stack([e[k].double() for e in buf])
                                            for k in names})
                vals = torch.stack([vals[k] for k in names], 1).cpu().numpy()
                for row in vals:
                    for k, v in zip(names, row):
                        meters.setdefault(k, AverageMeter()).update(float(v))
                buf.clear()

        t0 = time.time()
        loader = DataLoader(pre, sampler=RandomPairSampler(train, neg_pos_ratio=1,
                                                           seed=cfg.train.seed + epoch),
                            batch_size=cfg.data.batch_size, num_workers=cfg.data.workers,
                            drop_last=True, shard=mesh)
        i = -1
        for i, (b1, b2) in enumerate(_limit(loader, 2) if cfg.train.debug else loader):
            errors, fake = model.optimize_step(b1, b2)
            buf.append(errors)
            if (i + 1) % cfg.gan.display_freq == 0 and visualizer is not None:
                visualizer.display_current_results(
                    {"fake": fake[0].permute(1, 2, 0).float().cpu().numpy()}, epoch)
            if (i + 1) % cfg.train.print_freq == 0:
                drain()
                msg = "  ".join(f"{k}: {m.avg:.3f}" for k, m in meters.items())
                print(f"Epoch {epoch} [{i + 1}]  {msg}  ({time.time() - t0:.1f}s)")
        drain()
        print(f"End of epoch {epoch} \t Time Taken: {time.time() - t0:.0f} sec")
        if visualizer is not None:
            if i >= 0:       # a set smaller than one batch runs no step
                visualizer.display_current_results(
                    {"fake": fake[0].permute(1, 2, 0).float().cpu().numpy()}, epoch)
            visualizer.print_current_errors(epoch, i + 1,
                                            {k: m.avg for k, m in meters.items()},
                                            t=time.time() - t0)
        if is_main(mesh) and ((epoch + 1) % cfg.fdgan.save_step == 0 or epoch == epochs - 1):
            save_networks(nets, save_dir, "latest")
        if val_loader is not None and (epoch + 1) % cfg.fdgan.eval_step == 0:
            mAP = evaluator.evaluate(val_loader, val_query, val_gallery,
                                     rerank_topk=min(75, len(val_gallery) - 1), top1=False)
            is_best = mAP > best_map
            best_map = max(mAP, best_map)
            if is_best and is_main(mesh):
                save_networks(nets, save_dir, "best")
            print(f"\n * Finished epoch {epoch:3d}  mAP: {mAP:5.1%}  "
                  f"best: {best_map:5.1%}{' *' if is_best else ''}\n")

    if val_loader is not None and not cfg.train.debug and best_map > 0.0:
        print("Test with best model:")
        if is_main(mesh):
            load_networks({"E": model.net_E}, save_dir, "best")
        replicate(mesh, model.net_E)
        evaluator.evaluate(reid_loader(query + gallery), query, gallery,
                           rerank_topk=min(100, len(gallery) - 1), dataset=cfg.data.dataset)
    if mesh is not None:
        mesh.barrier()      # rank 0's nets are on disk for every rank
    return model


if __name__ == "__main__":
    main()
