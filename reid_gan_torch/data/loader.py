"""Host-side data loading: decode + resize on CPU threads; normalisation,
augmentation and pose rendering run on the card (``ops/transforms.py``,
``ops/pose.py``: kernels K1, K4, K9, K10).

Copy of the ``reid``, ``with_gan`` and ``only_gan`` modes of
``reid_gan_tpu/data/loader.py`` (CC/clustercontrast/utils/data/
preprocessor.py:108-191):
- ``reid``: ``(img, fname, pid, camid, index)`` with ``img`` a uint8 HWC
  array already at the target size;
- ``with_gan``: the reid item plus the GAN image ``Xs`` staged at the GAN
  size, its original ``old_size`` (height, width), the 18 pose keypoints of
  the annotation CSV (−1 where missing; all missing without a CSV, which
  the AE generator does not read), ``gt_label``, ``Xs_path`` and the flip
  draws ``flip``/``gan_flip``, which are carried and never applied, as in
  the JAX step (engine/gan_trainers.py:512-520);
- ``only_gan``: the GAN fields alone, with ``pid`` and ``index`` and
  ``gan_flip`` False (the GAN warm-up's loader);
- ``pair`` and ``fdgan_pose`` (loader.py:275-279,316-342; FD/reid/utils/
  data/preprocessor.py:63-131): an index pair from ``RandomPairSampler``
  gives two items, collated into two batches. A ``pair`` item is the reid
  item; an ``fdgan_pose`` item is ``img``, ``pid``, ``camid``, ``fname``
  and a random other image of the same pid as ``target``, its landmarks
  (``load_landmark_txt``, scaled to the frame) and a ``flip`` draw, from
  ``seed``'s stream in the JAX loader's order.
Pillow is imported inside the decode function, so a caller that feeds
in-memory uint8 batches never needs it.
"""

import json
import os
import os.path as osp
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

NUM_KEYPOINTS = 18


def _decode(fpath, height, width):
    """Decode to RGB uint8 HWC with a bilinear resize (RectScale); also the
    original (H, W), which the GAN path needs to rescale the keypoints
    (loader.py:42-52)."""
    from PIL import Image

    with Image.open(fpath) as im:
        old_size = (im.height, im.width)
        rgb = im.convert("RGB")
        if height is not None:
            rgb = rgb.resize((width, height), Image.BILINEAR)
        arr = np.asarray(rgb, np.uint8)
    arr.setflags(write=False)
    return arr, np.asarray(old_size, np.float32)


class ImageCache:
    """Decoded-uint8 RAM cache: each JPEG is decoded + resized once per run.
    ``get`` returns ``(image, old_size)``. Insertions stop at
    ``budget_bytes``; lookups stay O(1) either way. A racing double-decode is
    benign, the budget counter is lock-guarded."""

    def __init__(self, budget_bytes=4 << 30):
        self.budget = int(budget_bytes)
        self.used = 0
        self._lock = threading.Lock()
        self._table = {}

    def __len__(self):
        return len(self._table)

    def get(self, fpath, height, width, decode=None):
        """``decode`` (default: the JPEG decode) fills a miss."""
        key = (fpath, height, width)
        hit = self._table.get(key)
        if hit is not None:
            return hit
        val = (decode or _decode)(fpath, height, width)
        nbytes = val[0].nbytes + val[1].nbytes + 64
        with self._lock:
            if self.used + nbytes <= self.budget:
                self._table[key] = val
                self.used += nbytes
        return val


class _NullCache:
    budget = 0

    def __len__(self):
        return 0

    def get(self, fpath, height, width, decode=None):
        return (decode or _decode)(fpath, height, width)


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


class PoseAnnotations:
    """Keypoint CSV (``name:keypoints_y:keypoints_x`` with json-list columns)
    → dict name → (K, 2) float32 array of (y, x), −1 = missing
    (loader.py:114-138; CC/clustercontrast/utils/data/preprocessor.py:77-78,
    193-199)."""

    def __init__(self, csv_path):
        self.table = {}
        with open(csv_path) as f:
            header = f.readline().strip().split(":")
            iy, ix = header.index("keypoints_y"), header.index("keypoints_x")
            iname = header.index("name")
            for line in f:
                parts = line.strip().split(":")
                if len(parts) < 3:
                    continue
                ys = json.loads(parts[iy])
                xs = json.loads(parts[ix])
                self.table[parts[iname]] = np.stack(
                    [np.asarray(ys, np.float32), np.asarray(xs, np.float32)], axis=1)

    def __contains__(self, name):
        return name in self.table

    def __getitem__(self, name):
        return self.table[name]


def load_landmark_txt(path, scale_h=1.0, scale_w=1.0):
    """FD-GAN landmark file: one ``y x`` pair a line, scaled and truncated to
    int, negatives → −1 (loader.py:141-155)."""
    pts = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            h0, w0 = line.split()[:2]
            h0 = int(float(h0) * scale_h)
            w0 = int(float(w0) * scale_w)
            pts.append([h0 if h0 >= 0 else -1, w0 if w0 >= 0 else -1])
    return np.asarray(pts, np.float32)


_MODES = ("reid", "with_gan", "only_gan", "pair", "fdgan_pose")
PAIR_MODES = ("pair", "fdgan_pose")


class Preprocessor:
    """Per-index item factory returning plain numpy dicts (``reid``,
    ``with_gan``, ``only_gan``, ``pair`` and ``fdgan_pose`` modes; the two
    pair modes take an index pair). ``pid_imgs``: pid → image basenames and
    ``pose_root``: the landmark directory, of ``fdgan_pose``.
    ``cache``: ``"default"`` (the shared
    ``default_image_cache()``), None (no caching) or an object with
    ``get(fpath, height, width)`` → ``(image, old_size)`` and ``budget``.
    ``pose_file``: the keypoint CSV of the ``with_gan`` mode (without it
    every joint is missing). ``flip_all``: draw a flip per item from
    ``seed``'s stream, carried in the batch and never applied."""

    def __init__(self, dataset, root=None, mode="reid", height=256, width=128,
                 gan_height=128, gan_width=64, pose_file=None, flip_all=False,
                 seed=None, cache="default", pose_root=None, pid_imgs=None):
        if mode not in _MODES:
            raise ValueError(f"unsupported mode {mode!r}: the port's loader serves "
                             f"{', '.join(_MODES)}")
        self.dataset = dataset
        self.root = root
        self.mode = mode
        self.height, self.width = height, width
        self.gan_height, self.gan_width = gan_height, gan_width
        self.annotations = PoseAnnotations(pose_file) if pose_file else None
        self.pose_root = pose_root
        self.pid_imgs = pid_imgs
        self.flip_all = flip_all
        self.rng = np.random.RandomState(seed)
        self.cache = default_image_cache() if cache == "default" else \
            (cache if cache is not None else _NullCache())
        self._packed = None

    def __len__(self):
        return len(self.dataset)

    def _path(self, fname):
        return osp.join(self.root, fname) if self.root is not None else fname

    def _read(self, fname):
        return self.cache.get(self._path(fname), self.height, self.width)[0]

    def _read_gan(self, fname):
        return self.cache.get(self._path(fname), self.gan_height, self.gan_width)

    def _keypoints(self, base):
        if self.annotations is not None and base in self.annotations:
            return self.annotations[base]
        return np.full((NUM_KEYPOINTS, 2), -1, np.float32)

    def batchable(self):
        """True when the decoded set fits the cache budget twice (the cache
        and the packed copy are both resident), so a batch is one gather.
        The pair modes are served item by item."""
        if self.mode in PAIR_MODES:
            return False
        need = 0
        if self.mode != "only_gan":
            need += len(self.dataset) * self.height * self.width * 3
        if self.mode != "reid":
            need += len(self.dataset) * self.gan_height * self.gan_width * 3
        return 2 * need <= getattr(self.cache, "budget", 0)

    def _pack(self):
        n = len(self.dataset)
        fnames = [self.dataset[i][0] for i in range(n)]
        with ThreadPoolExecutor(max_workers=8) as pool:   # PIL drops the GIL
            imgs = list(pool.map(self._read, fnames)) \
                if self.mode != "only_gan" else None
            gan = list(pool.map(self._read_gan, fnames)) \
                if self.mode != "reid" else None
        self._packed = {
            "fname": fnames,
            "pid": np.asarray([self.dataset[i][1] for i in range(n)]),
            "camid": np.asarray([self.dataset[i][2] for i in range(n)]),
        }
        if imgs is not None:
            self._packed["img"] = np.stack(imgs)
        if gan is not None:
            bases = [osp.basename(f) for f in fnames]
            self._packed.update(
                Xs=np.stack([a for a, _ in gan]),
                old_size=np.stack([o for _, o in gan]),
                Xs_path=bases,
                gt_label=np.asarray([int(b.split("_", 1)[0]) for b in bases]),
                keypoints=np.stack([self._keypoints(b) for b in bases]))

    def get_batch(self, indices, rows=slice(None)):
        """Collated batch via vectorised gathers; field-for-field identical
        to the per-item path. ``rows`` (a slice or positions, which may
        repeat) keeps those rows of the batch, with the whole batch's flip
        draws (a data mesh rank's share)."""
        if self._packed is None:
            self._pack()
        p = self._packed
        idx = np.asarray(indices)
        flips = self.rng.rand(len(idx)) < 0.5 if self.draws_flips() else \
            np.zeros(len(idx), bool)
        idx, flips = idx[rows], flips[rows]
        if self.mode == "only_gan":
            out = {"pid": p["pid"][idx], "index": idx}
        else:
            out = {"img": p["img"][idx], "fname": [p["fname"][i] for i in idx],
                   "pid": p["pid"][idx], "camid": p["camid"][idx], "index": idx}
            if self.mode == "with_gan":
                out["flip"] = flips
        if self.mode != "reid":
            out.update(Xs=p["Xs"][idx], old_size=p["old_size"][idx],
                       keypoints=p["keypoints"][idx], gt_label=p["gt_label"][idx],
                       gan_flip=flips, Xs_path=[p["Xs_path"][i] for i in idx])
        return out

    def draws_flips(self):
        """Whether each item draws a flip from ``rng``."""
        return self.mode == "with_gan" and self.flip_all

    def _gan_item(self, fname, flip):
        base = osp.basename(fname)
        xs, old_size = self._read_gan(fname)
        return {"Xs": xs, "Xs_path": base, "gt_label": int(base.split("_", 1)[0]),
                "gan_flip": flip, "old_size": old_size,
                "keypoints": self._keypoints(base)}

    def pair_draws(self, pair):
        """The draws of a pair item from ``rng``, in the item's order: for
        each index of an ``fdgan_pose`` pair the target's name (a random
        other image of its pid, itself when it is the pid's only one) and
        then its flip (loader.py:316-342); None for a ``pair`` item, which
        draws nothing."""
        if self.mode != "fdgan_pose":
            return None
        out = []
        for index in pair:
            fname, pid, _ = self.dataset[index]
            pid_query = list(self.pid_imgs[pid])
            base = osp.basename(fname)
            if base in pid_query and len(pid_query) > 1:
                pid_query.remove(base)
            pname = osp.splitext(pid_query[self.rng.randint(len(pid_query))])[0]
            out.append((pname, bool(self.rng.rand() < 0.5)))
        return out

    def pair_item(self, pair, draws):
        """The two items of ``pair`` with the draws ``pair_draws`` gave it:
        an ``fdgan_pose`` item is each index's image, the target, the
        target's landmarks scaled to the frame, and the flip."""
        if self.mode == "pair":
            return [self._item(i) for i in pair]
        items = []
        for index, (pname, flip) in zip(pair, draws):
            fname, pid, camid = self.dataset[index]
            gt = osp.join(osp.dirname(fname), pname + ".jpg") if osp.dirname(fname) \
                else pname + ".jpg"
            target, gt_size = self.cache.get(self._path(gt), self.height, self.width)
            landmark = load_landmark_txt(osp.join(self.pose_root, pname + ".txt"),
                                         self.height / float(gt_size[0]),
                                         self.width / float(gt_size[1]))
            items.append({"img": self._read(fname), "pid": pid, "camid": camid,
                          "fname": fname, "target": target, "landmark": landmark,
                          "flip": flip})
        return items

    def __getitem__(self, index):
        if self.mode in PAIR_MODES:   # one pair alone (``DataLoader`` draws a batch first)
            return self.pair_item(index, self.pair_draws(index))
        return self._item(index)

    def _item(self, index):
        fname, pid, camid = self.dataset[index]
        if self.mode == "only_gan":
            item = self._gan_item(fname, False)
            item.update(pid=pid, index=index)
            return item
        item = {"img": self._read(fname), "fname": fname, "pid": pid,
                "camid": camid, "index": index}
        if self.mode == "with_gan":
            flip = bool(self.rng.rand() < 0.5) if self.draws_flips() else False
            item["flip"] = flip
            item.update(self._gan_item(fname, flip))
        return item


def check_pair_batch(batch_size, world_size):
    """A pair batch splits over the mesh without padding, or raises
    ``ValueError`` naming both numbers."""
    if batch_size % world_size:
        raise ValueError(f"a pair batch of {batch_size} does not split over a mesh of "
                         f"{world_size} ranks; give a batch size that {world_size} "
                         f"divides")


def _collate(items):
    """Stack a list of dicts into a dict of arrays (lists for strings); a
    list of pairs into a pair of batches."""
    if isinstance(items[0], list):
        return [_collate([it[k] for it in items]) for k in range(len(items[0]))]
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
    order when there is none, or shuffled anew each pass from ``seed``'s
    stream with ``shuffle``, as ``reid_gan_tpu/data/loader.py:366-400``.

    Decodes items with a thread pool and keeps ``prefetch`` collated batches
    ready. Decode errors are re-raised in the consumer; abandoning the
    iterator mid-epoch stops the producer thread and joins it.

    With ``shard`` (a ``parallel.Mesh``), every rank walks the same batches
    (the sampler runs alike on each from the same seed) and decodes only its
    contiguous slice of each: a batch of n indices is padded to a multiple
    of the mesh size by repeating its last index, and rank r takes rows
    [r·s, (r+1)·s) of it, s = ceil(n / size), as ``shard_batch`` places them.
    The decoded fields hold those s rows; the index fields (``fname``,
    ``pid``, ``camid``, ``index``) hold the whole batch's n, which every rank
    needs for the bank fold and the feature keys. The ``with_gan`` flips are
    the whole batch's draws, each rank taking its rows'.

    The pair modes (FD-GAN's stages) shard as JAX's ``shard_batch`` places
    each of the two batches: rank r decodes pairs [r·s, (r+1)·s), s = n /
    size, and every field of both batches holds those s rows. A pair batch
    is never padded (that would change the loss): a mesh size that does not
    divide ``batch_size`` raises ``ValueError`` here, and so does a last
    batch it does not divide. In the pair modes every process, with or
    without a shard, makes the whole batch's ``rng`` draws
    (``Preprocessor.pair_draws``) in the batch's order on the producing
    thread before its workers decode its rows, so the batches and ``rng``
    do not depend on ``num_workers`` and every rank's ``rng`` ends where a
    run of one process over the whole batch leaves it.
    """

    def __init__(self, preprocessor, sampler=None, batch_size=64, num_workers=4,
                 drop_last=True, shuffle=False, prefetch=2, seed=None, shard=None):
        if shard is not None and preprocessor.mode in PAIR_MODES:
            check_pair_batch(batch_size, shard.world_size)
        self.pre = preprocessor
        self.shard = shard
        self.sampler = sampler
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.prefetch = prefetch
        self.rng = np.random.RandomState(seed)

    def _indices(self):
        if self.sampler is not None:
            return list(self.sampler)
        idx = np.arange(len(self.pre))
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx.tolist()

    def __len__(self):
        n = len(self._indices()) if self.sampler is not None else len(self.pre)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _pair_batch(self, b, pool):
        """The pairs of ``b`` this process decodes (all of them without a
        shard), with the whole batch's draws made in order first."""
        mine = slice(None)
        if self.shard is not None:
            size, rank = self.shard.world_size, self.shard.rank
            check_pair_batch(len(b), size)
            s = len(b) // size
            mine = slice(rank * s, (rank + 1) * s)
        draws = [self.pre.pair_draws(pair) for pair in b]
        return _collate(list(pool.map(self.pre.pair_item, b[mine], draws[mine])))

    def _shard_batch(self, b, pool):
        """This rank's decoded rows of the batch of indices ``b`` and the
        whole batch's index fields (the class docstring)."""
        size, rank = self.shard.world_size, self.shard.rank
        s = -(-len(b) // size)
        padded = list(b) + [b[-1]] * (s * size - len(b))
        if self.pre.batchable():
            rows = np.minimum(np.arange(rank * s, (rank + 1) * s), len(b) - 1)
            batch = self.pre.get_batch(b, rows)
        else:
            # skip the flip draws of the other ranks' rows, so that each rank
            # draws its rows' share of the whole batch's (padding rows draw
            # their own)
            draws = self.pre.draws_flips()
            if draws:
                self.pre.rng.rand(min(rank * s, len(b)))
            batch = _collate(list(pool.map(self.pre.__getitem__,
                                           padded[rank * s:(rank + 1) * s])))
            if draws:
                self.pre.rng.rand(max(0, len(b) - (rank + 1) * s))
        ds = self.pre.dataset
        whole = {"fname": [ds[i][0] for i in b],
                 "pid": np.asarray([ds[i][1] for i in b]),
                 "camid": np.asarray([ds[i][2] for i in b]),
                 "index": np.asarray(b)}
        batch.update((k, v) for k, v in whole.items() if k in batch)
        return batch

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
        pairs = self.pre.mode in PAIR_MODES

        def produce():
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    if pairs:
                        batch = self._pair_batch(b, pool)
                    elif self.shard is not None:
                        batch = self._shard_batch(b, pool)
                    elif packed:
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
