"""Data pipeline: dataset scanners, samplers, host loader, synthetic factory."""


class IterLoader:
    """Infinite, epoch-agnostic iterator of fixed length over a loader (copy
    of ``reid_gan_tpu/data/__init__.py``; parity: CC/clustercontrast/utils/
    data/__init__.py:13-27)."""

    def __init__(self, loader, length=None):
        self.loader = loader
        self.length = length
        self.iter = None

    def __len__(self):
        if self.length is not None:
            return self.length
        return len(self.loader)

    def new_epoch(self):
        self.iter = iter(self.loader)

    def next(self):
        try:
            return next(self.iter)
        except (StopIteration, TypeError):
            self.iter = iter(self.loader)
            return next(self.iter)

    def close(self):
        """Shut down the underlying loader's producer thread (generator
        ``close()`` runs its finally: stop event + pool shutdown + join), so
        no worker touches dataset files after the caller moves on."""
        if self.iter is not None and hasattr(self.iter, "close"):
            self.iter.close()
        self.iter = None
