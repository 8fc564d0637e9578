"""Training visualizer: the loss log of the joint CLI (port of
``reid_gan_tpu/utils/visualizer.py``'s ``Visualizer.print_current_errors``;
parity: CC/dual_gan/gan_visualizer.py print_current_errors). The image
grids and the HTML gallery are not ported yet (ROADMAP A8)."""

import os.path as osp
import time

from .osutils import mkdir_if_missing


class Visualizer:
    def __init__(self, log_dir, name="experiment"):
        self.dir = log_dir
        self.name = name
        mkdir_if_missing(log_dir)
        self.loss_log = osp.join(log_dir, "loss_log.txt")
        with open(self.loss_log, "a") as f:
            f.write(f"================ Training Loss ({time.strftime('%c')}) "
                    f"================\n")

    def print_current_errors(self, epoch, i, errors, t=0.0):
        """Print one line of losses and append it to ``loss_log.txt``."""
        msg = f"(epoch: {epoch}, iters: {i}, time: {t:.3f}) " + " ".join(
            f"{k}: {float(v):.3f}" for k, v in errors.items())
        print(msg)
        with open(self.loss_log, "a") as f:
            f.write(msg + "\n")
