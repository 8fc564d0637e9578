"""Cross-cutting utilities (copies of the JAX package's JAX-free helpers)."""

import numpy as np

from .logging import Logger
from .meters import AverageMeter, Timer
from .osutils import mkdir_if_missing


def to_numpy(x):
    """Tensor / array / scalar / sequence → numpy (tensors are detached and
    moved to the host)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


__all__ = ["AverageMeter", "Logger", "Timer", "mkdir_if_missing", "to_numpy"]
