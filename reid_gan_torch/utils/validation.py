"""Shared pieces of the port's learning and scale checks
(``scripts/torch_validate_*.py``): a CLI's ``run`` with its stdout teed to
``log.txt``, the per-epoch mAPs read back from that log, and the checks'
failure."""

import os.path as osp
import re
import sys

from .logging import Logger

# the per-eval line of cli/train_usl.py and cli/train_gan_usl.py
_EPOCH_MAP = re.compile(r"model mAP: *([\d.]+)%")


def epoch_maps(text):
    """The mAPs of the ``* Finished epoch ... model mAP: x%`` lines of a
    training log, as fractions, in order."""
    return [float(v) / 100.0 for v in _EPOCH_MAP.findall(text)]


def run_logged(logs_dir, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` (a CLI's ``run``) with stdout teed to
    ``<logs_dir>/log.txt``, as the CLI's ``main`` tees its run. Returns
    what ``fn`` returned and the per-epoch mAPs of the log."""
    path = osp.join(logs_dir, "log.txt")
    logger = Logger(path)
    sys.stdout = logger
    try:
        out = fn(*args, **kwargs)
    finally:
        sys.stdout = logger.console
        logger.close()
    with open(path) as f:
        return out, epoch_maps(f.read())


def require(ok, message):
    """A check of a validation: raises ``AssertionError(message)`` unless
    ``ok`` (kept under ``python -O``, unlike ``assert``)."""
    if not ok:
        raise AssertionError(message)
