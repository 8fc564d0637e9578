"""Market-scale regression check of the PyTorch/CUDA port, on the card (the
port's copy of ``scripts/validate_hard_synthetic.py``).

Two checks, after the reference's own Market-1501 run
(CC/examples/logs/log.txt):

1. **Jaccard build time**: the reference computes the k-reciprocal Jaccard
   distance for N=12,936 train images in about 23 s on GPU+faiss
   (log.txt:18). The port's (kernel K8's kNN, then the threaded host C++
   k-reciprocal sets and min-sum) must take less, on 12,936 random unit
   rows of 2,048 (k1 30, k2 6).
2. **Learning trajectory**: USL under ``--fp16`` on the hard synthetic set
   (overlapping appearance clusters, camera nuisance and imbalance; 500 ids
   x 26 images, palette 64, 128x64: about 13k images, the Market train
   set's scale) must climb as the reference climbs on Market
   (53.8→76.9→85.5→87.0, log.txt:469-2289): first-epoch mAP < 0.6, best ≥
   first + 0.10, best > 0.5.

The JAX script writes this set, then lets ``cli/train_usl.main`` build its
own from the flags, which is the class's default 48 ids x 24 at 64x32. This
copy trains on the set it draws. The images stay in memory as drawn
(``HardSyntheticDataset(in_memory=True)``; the card's machine has no Pillow)
and reach the loader through ``NamedImages``: the arrays before JPEG coding.

    python scripts/torch_validate_hard_synthetic.py /tmp/hard_check [--device cpu] [FLAG ...]

Trailing flags override the run's (a toy size on the CPU).
"""

import os.path as osp
import sys
import time

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

NUM_IDS = 500
IMGS_PER_ID = 26          # ≈13k images, the Market-1501 train-set scale
H, W = 128, 64
N_JACCARD = 12936
JACCARD_BUDGET_S = 23.0   # reference: 23 s at N=12,936 (log.txt:18)
FLAGS = ["--dataset", "synthetic_hard", "--arch", "resnet18", "--height", str(H),
         "--width", str(W), "--batch-size", "64", "--num-instances", "4",
         "--epochs", "6", "--iters", "100", "--eps", "0.6", "--k1", "30", "--k2", "6",
         "--momentum", "0.1", "--fp16", "--eval-step", "1", "--workers", "4"]
SET = {"num_ids": NUM_IDS, "imgs_per_id": IMGS_PER_ID, "height": H, "width": W,
       "palette": 64}


def check_jaccard(n, device="cuda"):
    """Seconds of one Jaccard build over ``n`` random unit rows, after a
    warm-up build at 512 rows (the kernels' and the host library's
    loading)."""
    import numpy as np

    from reid_gan_torch.ops.jaccard import compute_jaccard_distance

    rng = np.random.RandomState(0)
    feats = rng.randn(n, 2048).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    compute_jaccard_distance(feats[:512], k1=30, k2=6, device=device)
    t0 = time.perf_counter()
    compute_jaccard_distance(feats, k1=30, k2=6, device=device)
    dt = time.perf_counter() - t0
    print(f"Jaccard build at N={n}: {dt:.1f} s (reference 23 s)")
    return dt


def verdict_jaccard(dt):
    """The check on the Jaccard build's seconds."""
    from reid_gan_torch.utils.validation import require

    require(dt < JACCARD_BUDGET_S,
            f"Jaccard build {dt:.1f}s exceeds the reference's {JACCARD_BUDGET_S}s")


def verdict_trajectory(maps, best):
    """The checks on the per-epoch mAPs and the best."""
    from reid_gan_torch.utils.validation import require

    require(len(maps) > 0, "no epoch was evaluated")
    require(maps[0] < 0.6, f"first-epoch mAP {maps[0]:.3f} — set too easy")
    require(best >= maps[0] + 0.10, "no climb — learning dynamics broken")
    require(best > 0.5, f"failed to learn (best mAP {best:.3f})")


def main(root, device="cuda", flags=()):
    """The Jaccard check, then the loop on ``device`` under ``root`` (the
    set, ``logs/``), with ``flags`` after the script's. Returns
    ``{"jaccard_s", "best", "maps"}``; raises ``AssertionError`` when a
    check fails."""
    from reid_gan_torch.cli import train_usl
    from reid_gan_torch.config import parse_config
    from reid_gan_torch.data.datasets import create
    from reid_gan_torch.data.in_memory import NamedImages
    from reid_gan_torch.utils.validation import run_logged

    dt = check_jaccard(N_JACCARD, device)
    verdict_jaccard(dt)

    t0 = time.perf_counter()
    ds = create("synthetic_hard", root, in_memory=True, **SET)
    print(f"hard synthetic set drawn in {time.perf_counter() - t0:.1f} s: "
          f"{len(ds.train)} train, {len(ds.query)} query, {len(ds.gallery)} gallery")
    cfg = parse_config(FLAGS + ["--data-dir", root, "--logs-dir", osp.join(root, "logs")]
                       + list(flags), sections=train_usl.SECTIONS)
    best, maps = run_logged(cfg.train.logs_dir, train_usl.run, cfg, ds, device,
                            image_cache=NamedImages(ds.images))
    print(f"trajectory: {['%.3f' % m for m in maps]}  best={best:.3f}")
    verdict_trajectory(maps, best)
    print(f"VALIDATION PASSED (jaccard {dt:.1f}s, best mAP {best:.3f})")
    return {"jaccard_s": dt, "best": best, "maps": maps}


if __name__ == "__main__":
    import argparse
    import os

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", nargs="?", default="/tmp/hard_check")
    ap.add_argument("--device", default="cuda")
    args, rest = ap.parse_known_args()
    os.makedirs(args.root, exist_ok=True)
    main(args.root, args.device, rest)
