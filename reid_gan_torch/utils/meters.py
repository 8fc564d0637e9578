"""Step-time / loss meters (parity: FD/reid/utils/meters.py,
CC/clustercontrast/utils/infomap_utils.py:15-28)."""

import time


class AverageMeter:
    """Running average of a scalar series."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class Timer:
    """Context-manager wall-clock timer printing
    ``[Time] <name> consumes <s> s`` on exit (copy of
    ``reid_gan_tpu/utils/meters.py:26``). Every span also adds its seconds
    to ``Timer.spans[name]``, which a caller clears and reads to split a run
    into its phases."""

    spans = {}

    def __init__(self, name="task", verbose=True):
        self.name = name
        self.verbose = verbose
        self.elapsed = 0.0

    def __enter__(self):
        self.start = time.time()
        return self

    def __exit__(self, *args):
        self.elapsed = time.time() - self.start
        Timer.spans[self.name] = Timer.spans.get(self.name, 0.0) + self.elapsed
        if self.verbose:
            print(f"[Time] {self.name} consumes {self.elapsed:.4f} s")
        return False
