"""Checkpoints in the CC reference layout (parity:
CC/clustercontrast/utils/serialization.py:24-49): ``{"state_dict", "epoch",
"best_mAP"}`` saved with ``torch.save`` as ``checkpoint.pth.tar`` and copied
to ``model_best.pth.tar``, the file ``cli/test.py --resume-torch`` reads.
The JAX package writes flax msgpack instead
(``reid_gan_tpu/utils/serialization.py:31-60``); reading one here is not
ported (ROADMAP A8).
"""

import os
import shutil

import torch

from .osutils import mkdir_if_missing


def save_checkpoint(state, is_best=False, fpath="checkpoint.pth.tar"):
    """Write ``state`` to ``fpath`` (through a temporary file, so a crash
    never leaves half a checkpoint) and copy it to ``model_best.pth.tar``
    beside it when ``is_best``."""
    mkdir_if_missing(os.path.dirname(fpath) or ".")
    tmp = fpath + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, fpath)
    if is_best:
        shutil.copy(fpath, os.path.join(os.path.dirname(fpath), "model_best.pth.tar"))


def load_checkpoint(fpath):
    """The dict ``save_checkpoint`` wrote, tensors on the CPU."""
    if not os.path.isfile(fpath):
        raise ValueError(f"=> No checkpoint found at '{fpath}'")
    state = torch.load(fpath, map_location="cpu", weights_only=True)
    print(f"=> Loaded checkpoint '{fpath}'")
    return state
