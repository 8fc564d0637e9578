"""Synthetic end-to-end USL validation of the PyTorch/CUDA port, on the card
(the port's copy of ``scripts/validate_synthetic_usl.py``).

The synthetic set's identities are color-separable, so a working USL loop
must push mAP well above chance within a few epochs. This runs the port's
real ``cli/train_usl`` loop (clustering → memory → InfoNCE epochs → eval)
on 24 ids x 3 cameras x 8 images at the JAX script's flags, and requires
best mAP > 0.5.

The card's machine has no Pillow, so the set's images stay in memory as
drawn (``SyntheticDataset(in_memory=True)``: every other file is written)
and reach the loader through ``NamedImages``, resized as the decode cache
resizes a decoded JPEG; the images are the arrays before JPEG coding.

    python scripts/torch_validate_synthetic_usl.py /tmp/usl_check [--device cpu] [FLAG ...]

Trailing flags override the run's (a toy size on the CPU).
"""

import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

FLAGS = ["--dataset", "synthetic", "--arch", "resnet18", "--height", "128",
         "--width", "64", "--batch-size", "64", "--num-instances", "4",
         "--epochs", "10", "--iters", "40", "--eps", "0.6", "--k1", "10", "--k2", "3",
         "--lr", "3.5e-4", "--eval-step", "2", "--workers", "2"]
# larger than the unit-test default
SET = {"num_ids": 24, "num_cams": 3, "imgs_per_id": 8}


def verdict(best):
    """The script's check on the best mAP."""
    from reid_gan_torch.utils.validation import require

    require(best > 0.5, f"USL loop failed to learn separable ids (mAP={best})")


def main(root, device="cuda", flags=(), dataset_kw=None):
    """Run the loop on ``device`` under ``root`` (the set, ``logs/``), with
    ``flags`` after the script's and the set's sizes ``dataset_kw`` (default
    ``SET``), and check it. Returns ``{"best": best mAP, "maps": each eval's mAP}``;
    raises ``AssertionError`` when the check fails."""
    from reid_gan_torch.cli import train_usl
    from reid_gan_torch.config import parse_config
    from reid_gan_torch.data.datasets import create
    from reid_gan_torch.data.in_memory import NamedImages
    from reid_gan_torch.utils.validation import run_logged

    ds = create("synthetic", root, in_memory=True, **(dataset_kw or SET))
    cfg = parse_config(FLAGS + ["--data-dir", root, "--logs-dir", osp.join(root, "logs")]
                       + list(flags), sections=train_usl.SECTIONS)
    best, maps = run_logged(cfg.train.logs_dir, train_usl.run, cfg, ds, device,
                            image_cache=NamedImages(ds.images))
    print(f"trajectory: {['%.3f' % m for m in maps]}")
    print(f"FINAL best mAP: {best:.3f}")
    verdict(best)
    print("VALIDATION PASSED")
    return {"best": best, "maps": maps}


if __name__ == "__main__":
    import argparse
    import os

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", nargs="?", default="/tmp/usl_check")
    ap.add_argument("--device", default="cuda")
    args, rest = ap.parse_known_args()
    os.makedirs(args.root, exist_ok=True)
    main(args.root, args.device, rest)
