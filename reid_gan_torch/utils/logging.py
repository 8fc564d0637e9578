"""Stdout-tee logger (copy of ``reid_gan_tpu/utils/logging.py``; parity:
CC/clustercontrast/utils/logging.py:9-39)."""

import os
import sys

from .osutils import mkdir_if_missing


class Logger:
    """Tee stdout to a file, fsyncing on flush:

        sys.stdout = Logger(osp.join(log_dir, 'log.txt'))
    """

    def __init__(self, fpath=None):
        self.console = sys.stdout
        self.file = None
        if fpath is not None:
            mkdir_if_missing(os.path.dirname(fpath) or ".")
            # line-buffered: the log must be tail-able while training runs
            self.file = open(fpath, "w", buffering=1)

    def __del__(self):
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    def write(self, msg):
        self.console.write(msg)
        if self.file is not None:
            self.file.write(msg)

    def flush(self):
        self.console.flush()
        if self.file is not None:
            self.file.flush()
            os.fsync(self.file.fileno())

    def close(self):
        self.console.flush()
        if self.file is not None:
            self.file.close()
            self.file = None
