"""Synthetic end-to-end JOINT GAN + re-ID validation of the PyTorch/CUDA
port, on the card (the port's copy of ``scripts/validate_synthetic_joint.py``).

Runs the port's flagship ``cli/train_gan_usl`` loop (clustering → memory →
``train_all``: joint InfoNCE + Pose-GAN adversarial step, after one
encoder-only warm-up epoch) for 6 epochs of 30 steps on the synthetic set
(24 ids x 3 cameras x 8 images) at the JAX script's flags, and requires (a)
best mAP > 0.5 and (b) the per-net checkpoint ``latest_net_G.pth`` (the
port's format) under ``<root>/ckpt/experiment``.

The card's machine has no Pillow, so the set's images stay in memory as
drawn (``SyntheticDataset(in_memory=True)``: every other file is written)
and reach the loader through ``NamedImages``, resized as the decode cache
resizes a decoded JPEG; the images are the arrays before JPEG coding.

    python scripts/torch_validate_synthetic_joint.py /tmp/joint_check [--device cpu] [FLAG ...]

Trailing flags override the run's (a toy size on the CPU).
"""

import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

FLAGS = ["--dataset", "synthetic", "--arch", "resnet18", "--height", "128",
         "--width", "64", "--gan-height", "64", "--gan-width", "32",
         "--batch-size", "32", "--num-instances", "4", "--epochs", "6", "--iters", "30",
         "--eps", "0.6", "--k1", "10", "--k2", "3", "--model", "AE", "--model-gen", "Pose",
         "--warmup-epo", "1", "--eval-step", "2", "--workers", "2"]
# larger than the unit-test default
SET = {"num_ids": 24, "num_cams": 3, "imgs_per_id": 8}


def verdict(best, nets_dir):
    """The script's checks on the best mAP and the nets' directory."""
    from reid_gan_torch.utils.validation import require

    require(best > 0.5, f"joint loop failed to learn (mAP={best})")
    require(osp.exists(osp.join(nets_dir, "latest_net_G.pth")),
            f"no latest_net_G.pth under {nets_dir}")


def main(root, device="cuda", flags=()):
    """Run the loop on ``device`` under ``root`` (the set, ``logs/``,
    ``ckpt/``), with ``flags`` after the script's, and check it. Returns ``{"best": best mAP, "maps": each eval's mAP}``;
    raises ``AssertionError`` when the check fails."""
    from reid_gan_torch.cli import train_gan_usl
    from reid_gan_torch.config import parse_config
    from reid_gan_torch.data.datasets import create
    from reid_gan_torch.data.in_memory import NamedImages
    from reid_gan_torch.utils.validation import run_logged

    ds = create("synthetic", root, in_memory=True, **SET)
    cfg = parse_config(FLAGS + ["--data-dir", root, "--logs-dir", osp.join(root, "logs"),
                                "--save-dir", osp.join(root, "ckpt")] + list(flags),
                       sections=train_gan_usl.SECTIONS)
    best, maps = run_logged(cfg.train.logs_dir, train_gan_usl.run, cfg, ds, device,
                            image_cache=NamedImages(ds.images))
    print(f"trajectory: {['%.3f' % m for m in maps]}")
    print(f"FINAL best mAP: {best:.3f}")
    verdict(best, osp.join(cfg.gan.save_dir, cfg.gan.name))
    print("JOINT VALIDATION PASSED")
    return {"best": best, "maps": maps}


if __name__ == "__main__":
    import argparse
    import os

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", nargs="?", default="/tmp/joint_check")
    ap.add_argument("--device", default="cuda")
    args, rest = ap.parse_known_args()
    os.makedirs(args.root, exist_ok=True)
    main(args.root, args.device, rest)
