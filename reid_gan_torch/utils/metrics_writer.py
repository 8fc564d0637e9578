"""Structured training-metrics writer (port of
``reid_gan_tpu/utils/metrics_writer.py``): in place of the reference's wandb
dependency and TensorBoard ``SummaryWriter`` (...infomap.py:213-219,278), a
JSONL stream, one line per log call, plus TensorBoard through
``torch.utils.tensorboard`` where it imports."""

import json
import os.path as osp
import time

from .osutils import mkdir_if_missing


class MetricsWriter:
    """Appends ``{"t": wall time, "step": step, name: value, ...}`` lines to
    ``<log_dir>/metrics.jsonl``; with ``use_tensorboard`` and
    ``torch.utils.tensorboard`` importable, also each scalar under
    ``<log_dir>/tb``."""

    def __init__(self, log_dir, name="run", use_tensorboard=True):
        mkdir_if_missing(log_dir)
        self.path = osp.join(log_dir, "metrics.jsonl")
        self._fh = open(self.path, "a")
        self.tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(osp.join(log_dir, "tb"), comment=name)
            except Exception:
                self.tb = None

    def log(self, metrics, step=None):
        """``metrics``: a flat dict of scalars (``wandb.log``'s argument)."""
        rec = {"t": time.time()}
        if step is not None:
            rec["step"] = int(step)
        for k, v in metrics.items():
            rec[k] = float(v)
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self.tb is not None and step is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(k, float(v), int(step))

    def add_scalar(self, tag, value, step):
        """``SummaryWriter.add_scalar`` (trainers.py:103-107)."""
        self.log({tag: value}, step=step)

    def close(self):
        self._fh.close()
        if self.tb is not None:
            self.tb.close()
