"""Host-side data loading for re-ID: decode + resize on CPU threads;
normalisation and augmentation run on the card (``ops/transforms.py``,
kernels K1 and K4).

Copy of the ``reid`` mode of ``reid_gan_tpu/data/loader.py``: items are
``(img, fname, pid, camid, index)`` with ``img`` a uint8 HWC array already at
the target size (CC/clustercontrast/utils/data/preprocessor.py:108-122).
Pillow is imported inside the decode function, so a caller that feeds
in-memory uint8 batches never needs it.
"""

import os
import os.path as osp
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def _decode(fpath, height, width):
    """Decode to RGB uint8 HWC with a bilinear resize (RectScale)."""
    from PIL import Image

    with Image.open(fpath) as im:
        rgb = im.convert("RGB")
        if height is not None:
            rgb = rgb.resize((width, height), Image.BILINEAR)
        arr = np.asarray(rgb, np.uint8)
    arr.setflags(write=False)
    return arr


class ImageCache:
    """Decoded-uint8 RAM cache: each JPEG is decoded + resized once per run.
    Insertions stop at ``budget_bytes``; lookups stay O(1) either way. A
    racing double-decode is benign, the budget counter is lock-guarded."""

    def __init__(self, budget_bytes=4 << 30):
        self.budget = int(budget_bytes)
        self.used = 0
        self._lock = threading.Lock()
        self._table = {}

    def __len__(self):
        return len(self._table)

    def get(self, fpath, height, width):
        key = (fpath, height, width)
        hit = self._table.get(key)
        if hit is not None:
            return hit
        val = _decode(fpath, height, width)
        nbytes = val.nbytes + 64
        with self._lock:
            if self.used + nbytes <= self.budget:
                self._table[key] = val
                self.used += nbytes
        return val


class _NullCache:
    budget = 0

    def __len__(self):
        return 0

    def get(self, fpath, height, width):
        return _decode(fpath, height, width)


_default_cache = None
_default_cache_lock = threading.Lock()


def default_image_cache():
    """The process-wide cache every Preprocessor shares by default, so the
    clustering extraction, the P×K loader and the test loader decode each
    image once per run (loader.py:98-111). Budget from
    ``REID_IMAGE_CACHE_MB`` (default 4096; 0 disables caching)."""
    global _default_cache
    with _default_cache_lock:
        if _default_cache is None:
            mb = float(os.environ.get("REID_IMAGE_CACHE_MB", "4096"))
            _default_cache = ImageCache(int(mb * (1 << 20))) if mb > 0 \
                else _NullCache()
        return _default_cache


class Preprocessor:
    """Per-index item factory returning plain numpy dicts (``reid`` mode).
    ``cache``: ``"default"`` (the shared ``default_image_cache()``), None (no
    caching) or an object with ``get(fpath, height, width)`` and ``budget``."""

    def __init__(self, dataset, root=None, mode="reid", height=256, width=128,
                 cache="default"):
        if mode != "reid":
            raise ValueError(f"unsupported mode {mode!r}: the port's loader "
                             "serves the eval path ('reid') only")
        self.dataset = dataset
        self.root = root
        self.mode = mode
        self.height, self.width = height, width
        self.cache = default_image_cache() if cache == "default" else \
            (cache if cache is not None else _NullCache())
        self._packed = None

    def __len__(self):
        return len(self.dataset)

    def _path(self, fname):
        return osp.join(self.root, fname) if self.root is not None else fname

    def _read(self, fname):
        return self.cache.get(self._path(fname), self.height, self.width)

    def batchable(self):
        """True when the decoded set fits the cache budget twice (the cache
        and the packed copy are both resident), so a batch is one gather."""
        need = len(self.dataset) * self.height * self.width * 3
        return 2 * need <= getattr(self.cache, "budget", 0)

    def _pack(self):
        n = len(self.dataset)
        fnames = [self.dataset[i][0] for i in range(n)]
        with ThreadPoolExecutor(max_workers=8) as pool:   # PIL drops the GIL
            imgs = list(pool.map(self._read, fnames))
        self._packed = {
            "fname": fnames,
            "pid": np.asarray([self.dataset[i][1] for i in range(n)]),
            "camid": np.asarray([self.dataset[i][2] for i in range(n)]),
            "img": np.stack(imgs),
        }

    def get_batch(self, indices):
        """Collated batch via vectorised gathers; field-for-field identical
        to the per-item path."""
        if self._packed is None:
            self._pack()
        p = self._packed
        idx = np.asarray(indices)
        return {"img": p["img"][idx], "fname": [p["fname"][i] for i in idx],
                "pid": p["pid"][idx], "camid": p["camid"][idx], "index": idx}

    def __getitem__(self, index):
        fname, pid, camid = self.dataset[index]
        return {"img": self._read(fname), "fname": fname, "pid": pid,
                "camid": camid, "index": index}


def _collate(items):
    """Stack a list of dicts into a dict of arrays (lists for strings)."""
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], str):
            out[key] = vals
        elif isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        else:
            out[key] = np.asarray(vals)
    return out


class _WorkerFailure:
    """Queue sentinel carrying a producer-side exception to the consumer."""

    def __init__(self, exc):
        self.exc = exc


class DataLoader:
    """Threaded prefetching batch loader over the indices of ``sampler``
    (e.g. ``sampler.RandomMultipleGallerySampler``), or over the dataset in
    order when there is none, as ``reid_gan_tpu/data/loader.py:366-400``.

    Decodes items with a thread pool and keeps ``prefetch`` collated batches
    ready. Decode errors are re-raised in the consumer; abandoning the
    iterator mid-epoch stops the producer thread and joins it.
    """

    def __init__(self, preprocessor, sampler=None, batch_size=64, num_workers=4,
                 drop_last=True, prefetch=2):
        self.pre = preprocessor
        self.sampler = sampler
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch

    def _indices(self):
        if self.sampler is not None:
            return list(self.sampler)
        return list(range(len(self.pre)))

    def __len__(self):
        n = len(self._indices()) if self.sampler is not None else len(self.pre)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        indices = self._indices()
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        q = queue.Queue(maxsize=self.prefetch)
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        stop = threading.Event()

        def _put(item):
            # blocking put that gives up once the consumer abandons the epoch
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        packed = self.pre.batchable()

        def produce():
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    if packed:
                        batch = self.pre.get_batch(b)
                    else:
                        batch = _collate(list(pool.map(self.pre.__getitem__, b)))
                    if not _put(batch):
                        return
            except BaseException as exc:  # re-raised in the consumer
                _put(_WorkerFailure(exc))

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            for _ in range(len(batches)):
                batch = q.get()
                if isinstance(batch, _WorkerFailure):
                    raise batch.exc
                yield batch
        finally:
            stop.set()
            pool.shutdown(wait=False, cancel_futures=True)
            t.join(timeout=10)
