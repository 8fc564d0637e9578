"""Checkpoints in the CC reference layout (parity:
CC/clustercontrast/utils/serialization.py:24-49): ``{"state_dict", "epoch",
"best_mAP"}`` saved with ``torch.save`` as ``checkpoint.pth.tar`` and copied
to ``model_best.pth.tar``, the file ``cli/test.py --resume-torch`` reads;
and the GAN nets' per-net layout ``{which_epoch}_net_{name}.pth`` (parity:
CC/dual_gan/models/base_model.py:94-161). The JAX package writes flax
msgpack instead (``reid_gan_tpu/utils/serialization.py:31-60,94-115``);
reading one here is not ported (ROADMAP A8).
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


def save_networks(nets, save_dir, which_epoch):
    """Each net's ``state_dict`` (on the CPU) to
    ``<save_dir>/{which_epoch}_net_{name}.pth`` (serialization.py:94-100)."""
    mkdir_if_missing(save_dir)
    for name, net in nets.items():
        sd = {k: v.detach().cpu() for k, v in net.state_dict().items()}
        save_checkpoint(sd, fpath=os.path.join(save_dir, f"{which_epoch}_net_{name}.pth"))


def load_networks(nets, save_dir, which_epoch):
    """Load each net's file into it in place; a missing file is skipped with
    a message and the net keeps its weights (serialization.py:103-114)."""
    for name, net in nets.items():
        fpath = os.path.join(save_dir, f"{which_epoch}_net_{name}.pth")
        if not os.path.isfile(fpath):
            print(f"load_networks: no checkpoint for net '{name}' at {fpath}; "
                  "keeping init")
            continue
        net.load_state_dict(load_checkpoint(fpath))
    return nets
