"""Host loader scaling of the PyTorch/CUDA port (the port's copy of
``scripts/bench_loader_scaling.py``, with ``bench_loader``, its copy of
``bench.py``'s): batches assembled a second by the port's loader
(``reid_gan_torch/data/loader.py``) across worker counts, with the decode
cache cold (the first pass fills it), warm (every epoch after the first)
and off (streaming).

The loader is one producer thread and a thread pool. With the cache warm,
the set is packed once and each batch is one gather, so the worker count
stops mattering; streaming, every item is read and resized on a worker.

Two sources feed it:

- ``jpeg`` (the default): the JPEG files of the synthetic set, decoded by
  Pillow, as the JAX script measures. Without Pillow this raises
  ``ImportError``; it never falls back to the other source.
- ``memory``: the set's drawn images held in memory (the card's machine has
  no Pillow). A "decode" is the resize of the drawn array, bit for bit as
  Pillow resizes (``data/in_memory.pil_bilinear``); the cache keeps it as
  it keeps a decoded file.

The loader touches no device. ``--device`` says only where the run is
meant to be (the card's machine by default), as in the other speed
scripts; without a card it raises unless it is ``cpu``.

    python scripts/torch_bench_loader_scaling.py [--source memory] [--device cpu]

The last line is the rates as JSON: {"source", "cached", "cold",
"streaming"}, each worker count → img/s.
"""

import json
import os.path as osp
import sys
import time

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

SOURCES = ("jpeg", "memory")
WORKERS = (1, 2, 4, 8)
# the last in-memory set drawn, with its root and sizes: as the JPEG source
# writes its set under a root once and later calls read the same files
_memory_set = None


class _MemoryFiles:
    """The loader's process-wide decode cache (``data/loader.py``'s
    ``_default_cache``) over a set held in memory: a miss resizes the drawn
    image where a decode would read the JPEG, and the cache keeps what it
    keeps of a decoded file (nothing when it is a ``_NullCache``)."""

    def __init__(self, images, cache):
        self.images, self.cache = images, cache
        self.budget = cache.budget

    def _resize(self, fpath, height, width):
        import numpy as np

        from reid_gan_torch.data.in_memory import pil_bilinear

        img = self.images[osp.basename(fpath)]
        return pil_bilinear(img, height, width), np.asarray(img.shape[:2], np.float32)

    def get(self, fpath, height, width):
        return self.cache.get(fpath, height, width, decode=self._resize)


def bench_loader(batch=64, num_workers=4, iters=40, root=None, source="jpeg",
                 num_ids=64, num_cams=3, imgs_per_id=8, height=256, width=128):
    """The loader's img/s (items read, resized and collated) in the joint
    training's ``with_gan`` mode (the re-ID image, the GAN image at half
    the size, the keypoints), on the synthetic set of ``num_ids`` x
    ``num_cams`` x ``imgs_per_id`` images at half of (height, width), P×K
    batches of 4 instances, after one untimed batch (bench.py:227-263).

    ``root``: reuse a set (the JPEG files under it, or the ``memory`` set
    drawn for it), so that repeated calls share the process-wide decode
    cache; default a throwaway set. ``source``: ``jpeg`` or ``memory``
    (the module's docstring)."""
    import contextlib
    import tempfile

    global _memory_set

    from reid_gan_torch.data import IterLoader
    from reid_gan_torch.data import loader as loader_mod
    from reid_gan_torch.data.datasets import create as create_dataset
    from reid_gan_torch.data.loader import DataLoader, Preprocessor
    from reid_gan_torch.data.sampler import RandomMultipleGallerySampler

    if source not in SOURCES:
        raise ValueError(f"source must be one of {SOURCES}, got {source!r}")
    if source == "jpeg":
        import PIL  # noqa: F401  (the JPEG source needs it; no fallback)

    ctx = (tempfile.TemporaryDirectory() if root is None
           else contextlib.nullcontext(root))
    with ctx as root:
        kw = dict(num_ids=num_ids, num_cams=num_cams, imgs_per_id=imgs_per_id,
                  height=height // 2, width=width // 2)
        if source == "jpeg":
            ds, cache = create_dataset("synthetic", root, **kw), "default"
        else:
            key = (root, tuple(sorted(kw.items())))
            if _memory_set is None or _memory_set[0] != key:
                _memory_set = key, create_dataset("synthetic", root, in_memory=True, **kw)
            ds = _memory_set[1]
            cache = _MemoryFiles(ds.images, loader_mod.default_image_cache())
        pre = Preprocessor(list(ds.train), mode="with_gan", height=height, width=width,
                           gan_height=height // 2, gan_width=width // 2,
                           pose_file=getattr(ds, "train_pose_dir", None),
                           flip_all=True, cache=cache)
        sampler = RandomMultipleGallerySampler(ds.train, num_instances=4)
        loader = IterLoader(DataLoader(pre, sampler=sampler, batch_size=batch,
                                       num_workers=num_workers), length=iters)
        loader.new_epoch()
        loader.next()                      # spin up the pool + prefetch
        t0 = time.perf_counter()
        for _ in range(iters):
            loader.next()
        dt = time.perf_counter() - t0
        loader.close()   # join workers BEFORE the tempdir (and its files) go
    return batch * iters / dt


def main(source="jpeg", device="cuda", workers=WORKERS, **sizes):
    """The cold, cached and streaming rates at each worker count, on one
    set for every call (``sizes``: ``bench_loader``'s batch, iters and set
    sizes). Prints a line a worker count; returns the rates."""
    import tempfile

    from reid_gan_torch.data import loader as loader_mod
    from reid_gan_torch.device import resolve_device

    resolve_device(device)
    print(f"loader source: {source}", flush=True)
    results = {"source": source, "cached": {}, "cold": {}, "streaming": {}}
    with tempfile.TemporaryDirectory() as root:
        # ONE set for every call: the cold pass fills the cache, the cached
        # pass reuses those entries (keyed by (path, h, w))
        for n in workers:
            loader_mod._default_cache = loader_mod.ImageCache(4 << 30)
            cold = bench_loader(num_workers=n, root=root, source=source, **sizes)
            cached = bench_loader(num_workers=n, root=root, source=source, **sizes)
            loader_mod._default_cache = loader_mod._NullCache()
            streaming = bench_loader(num_workers=n, root=root, source=source, **sizes)
            results["cached"][n] = round(cached, 1)
            results["cold"][n] = round(cold, 1)
            results["streaming"][n] = round(streaming, 1)
            print(f"workers={n}: streaming {streaming:7.1f} img/s   "
                  f"cached {cached:7.1f} img/s   (cold first epoch "
                  f"{cold:.1f})", flush=True)
        loader_mod._default_cache = None                 # the lazy default again
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", choices=SOURCES, default="jpeg")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.source, args.device)
