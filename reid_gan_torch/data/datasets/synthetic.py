"""Synthetic dataset factory — the test fixture the reference lacks
(SURVEY.md §4.3): random images with Market-style filenames, plus synthetic
pose annotations in BOTH reference formats (keypoint CSV for the CC GAN
branch, per-image landmark ``.txt`` for FD-GAN), so every entry-point config
can run a debug epoch without real data.
"""

import functools
import json
import os
import os.path as osp

import numpy as np

from .base import BaseImageDataset
from .dir_datasets import scan_dir

NUM_KEYPOINTS = 18


def _random_keypoints(rng, h, w):
    """Plausible person keypoints: ~roughly vertical chain with jitter; a few
    randomly missing (-1)."""
    ys = np.linspace(0.1 * h, 0.9 * h, NUM_KEYPOINTS) + rng.randn(NUM_KEYPOINTS) * h * 0.03
    xs = w / 2 + rng.randn(NUM_KEYPOINTS) * w * 0.15
    ys = np.clip(ys, 0, h - 1).astype(int)
    xs = np.clip(xs, 0, w - 1).astype(int)
    missing = rng.rand(NUM_KEYPOINTS) < 0.1
    ys[missing] = -1
    xs[missing] = -1
    return ys, xs


@functools.lru_cache(maxsize=None)
def _patterns(h, w, phase):
    """The hard set's id-phase 2x2 checker texture and its vignette, (h, w,
    1) each, read-only (a few of them per set, shared by its images)."""
    yy, xx = np.mgrid[0:h, 0:w]
    checker = (((yy // 2 + xx // 2 + phase) % 2) * 24.0 - 12.0)
    cy, cx = h / 2.0, w / 2.0
    vig = 1.0 - 0.35 * (((yy - cy) / cy) ** 2 + ((xx - cx) / cx) ** 2) / 2
    out = checker[:, :, None], vig[:, :, None]
    for a in out:
        a.setflags(write=False)
    return out


class _SyntheticTree(BaseImageDataset):
    """The Market-style tree both synthetic sets write and read under
    ``dataset_dir``: the three split dirs of ``{pid}_c{cam}s1_{i}_00.jpg``
    images, the two keypoint CSVs and ``poses/``. A subclass's ``draw``
    yields ``(split, name, image, ys, xs)`` from its ``RandomState`` in the
    order the JAX package draws them (each image, then its keypoints);
    ``_write`` turns them into files.

    ``in_memory``: every file but the images is written, each time; the
    images stay in ``self.images`` (name → the drawn uint8 HWC array, which
    the writer would encode as JPEG at ``quality``), the splits list the
    drawn names, and no ``.complete`` marks the tree, whose images are not
    on disk. Otherwise ``self.images`` is None and the images are JPEG files
    (Pillow)."""

    quality = 90
    label = "Synthetic"

    def _load(self, dataset_dir, draws, in_memory, verbose):
        self.dataset_dir = dataset_dir
        self.train_dir = osp.join(dataset_dir, "bounding_box_train")
        self.query_dir = osp.join(dataset_dir, "query")
        self.gallery_dir = osp.join(dataset_dir, "bounding_box_test")
        self.train_pose_dir = osp.join(dataset_dir, "market-annotation-train.csv")
        self.test_pose_dir = osp.join(dataset_dir, "market-annotation-test.csv")
        self.poses_dir = osp.join(dataset_dir, "poses")
        self.images = {} if in_memory else None
        names = {}
        if in_memory or not osp.exists(osp.join(dataset_dir, ".complete")):
            names = self._write(draws(), self.images)

        self.train = scan_dir(self.train_dir, relabel=True, names=names.get("train"))
        self.query = scan_dir(self.query_dir, relabel=False, names=names.get("query"))
        self.gallery = scan_dir(self.gallery_dir, relabel=False,
                                names=names.get("gallery"))
        if verbose:
            print(f"=> {self.label} loaded")
            self.print_dataset_statistics(self.train, self.query, self.gallery)
        self.num_train_pids, self.num_train_imgs, self.num_train_cams = (
            self.get_imagedata_info(self.train))
        self.pid_imgs = {}
        for fname, pid, _ in self.train:
            self.pid_imgs.setdefault(pid, set()).add(osp.basename(fname))

    def _write(self, draws, images=None):
        """Write the tree of ``draws``, the images into ``images`` (a dict)
        where given, else as JPEGs. Returns each split's names."""
        dirs = {"train": self.train_dir, "query": self.query_dir,
                "gallery": self.gallery_dir}
        for d in list(dirs.values()) + [self.poses_dir]:
            os.makedirs(d, exist_ok=True)
        names = {split: [] for split in dirs}
        rows = {"train": [], "test": []}
        for split, name, img, ys, xs in draws:
            if images is None:
                from PIL import Image

                Image.fromarray(img).save(osp.join(dirs[split], name), quality=self.quality)
            else:
                images[name] = img
            names[split].append(name)
            rows["train" if split == "train" else "test"].append(
                f"{name}:{json.dumps(ys.tolist())}:{json.dumps(xs.tolist())}")
            with open(osp.join(self.poses_dir, osp.splitext(name)[0] + ".txt"), "w") as f:
                for y, x in zip(ys, xs):
                    f.write(f"{y} {x}\n")
        header = "name:keypoints_y:keypoints_x"
        for path, split in ((self.train_pose_dir, "train"), (self.test_pose_dir, "test")):
            with open(path, "w") as f:
                f.write("\n".join([header] + rows[split]) + "\n")
        if images is None:
            with open(osp.join(self.dataset_dir, ".complete"), "w") as f:
                f.write("ok\n")
        return names


class SyntheticDataset(_SyntheticTree):
    """Writes a small Market-style tree under ``root/synthetic`` on first use
    (every use with ``in_memory``, ``_SyntheticTree``):

    - bounding_box_train/query/bounding_box_test with ``{pid}_c{cam}_{i}.jpg``
    - ``market-annotation-train.csv`` / ``-test.csv`` (``name:keypoints_y:keypoints_x``
      json-list columns, the pandas format of
      CC/clustercontrast/utils/data/preprocessor.py:77-78,193-199)
    - ``poses/{name}.txt`` FD-GAN landmark files (``y x`` per line,
      FD/reid/utils/data/preprocessor.py:100-112)
    """

    def __init__(self, root, num_ids=8, num_cams=3, imgs_per_id=4,
                 height=64, width=32, seed=0, verbose=False, in_memory=False, **kwargs):
        self.height, self.width = height, width
        self._load(osp.join(root, "synthetic"), lambda: self.draw(
            num_ids, num_cams, imgs_per_id, height, width, seed), in_memory, verbose)

    @staticmethod
    def draw(num_ids, num_cams, imgs_per_id, h, w, seed):
        """Trivially separable: per-id base color, mild noise."""
        rng = np.random.RandomState(seed)
        # per-identity base color so features are somewhat id-clusterable
        base = rng.randint(0, 255, (num_ids, 3))
        for pid in range(1, num_ids + 1):
            for cam in range(1, num_cams + 1):
                for i in range(imgs_per_id):
                    img = (base[pid - 1][None, None] +
                           rng.randint(-40, 40, (h, w, 3))).clip(0, 255).astype(np.uint8)
                    name = f"{pid:04d}_c{cam}s1_{i:06d}_00.jpg"
                    if cam == 1 and i == 0:
                        split = "query"
                    elif cam == num_cams and i == 0:
                        split = "gallery"
                    else:
                        split = "train"
                    ys, xs = _random_keypoints(rng, h, w)
                    yield split, name, img, ys, xs


class HardSyntheticDataset(_SyntheticTree):
    """A regression benchmark that can FAIL (VERDICT r1 item 4).

    The plain SyntheticDataset is trivially separable (per-id base color →
    mAP 1.0 in a few epochs, so momentum/use_hard/conf-weight regressions are
    invisible). Here identity is carried by *structure*, not color:

    - **Overlapping appearance clusters**: ids share base colors from a small
      palette (``num_ids // palette_share`` ids per color), so first-epoch
      DBSCAN/Infomap on an untrained encoder merges/splits identities —
      imperfect pseudo-labels, like real Market-1501 epochs 0-5
      (reference trajectory 53.8→87.0, CC/examples/logs/log.txt:469-2289).
    - **Id-coding pattern**: two horizontal stripes whose positions and a
      2×2-checker phase encode the id; a convnet must learn spatial layout.
    - **Camera nuisance**: strong per-camera channel gain/offset + vignette,
      so raw color statistics cluster by camera, not id.
    - **Camera imbalance**: images distributed over cameras by a geometric
      profile (cam 0 dominates), as in real surveillance data.

    Query = first image of each id on every odd camera; gallery = first on
    every even camera; the rest train. Same Market-style tree + pose
    annotations as SyntheticDataset, so every CLI runs on it unchanged.
    """

    quality = 92
    label = "HardSynthetic"

    def __init__(self, root, num_ids=48, num_cams=6, imgs_per_id=24,
                 height=64, width=32, palette=8, seed=0, verbose=False,
                 in_memory=False, **kwargs):
        self.height, self.width = height, width
        self._load(osp.join(root, f"synthetic_hard_{num_ids}x{imgs_per_id}"),
                   lambda: self.draw(num_ids, num_cams, imgs_per_id, height, width,
                                     palette, seed), in_memory, verbose)

    @staticmethod
    def _id_image(h, w, base, stripe1, stripe2, phase):
        """An id's image before any camera (float32): its palette colour,
        its two stripes and its checker phase."""
        img = np.broadcast_to(base[None, None], (h, w, 3)).astype(np.float32)
        # id-coding stripes (position is the identity signal)
        s = max(2, h // 8)
        c1 = 255.0 - base
        img = img.copy()
        img[stripe1:stripe1 + s] = 0.7 * c1 + 0.3 * img[stripe1:stripe1 + s]
        img[stripe2:stripe2 + s] = 0.5 * c1[::-1] + 0.5 * img[stripe2:stripe2 + s]
        img += _patterns(h, w, phase)[0]
        return img

    @staticmethod
    def _render(img, vig, cam_gain, cam_off, shifts, noise):
        """An id's images (n, h, w, 3) uint8 from its image ``img``, each on
        its camera (``cam_gain``, ``cam_off``: (n, 3)): channel gain and
        offset, vignette, a vertical jitter of ``shifts`` rows (``np.roll``),
        noise (``noise``: (n, h, w, 3) standard normal draws)."""
        n, h = len(shifts), img.shape[0]
        x = img[None] * cam_gain[:, None, None] + cam_off[:, None, None]
        x *= vig
        x = x[np.arange(n)[:, None], (np.arange(h)[None] - shifts[:, None]) % h]
        x += noise * 10.0
        return x.clip(0, 255).astype(np.uint8)

    @classmethod
    def draw(cls, num_ids, num_cams, imgs_per_id, h, w, palette, seed):
        rng = np.random.RandomState(seed)
        colors = rng.randint(40, 215, (palette, 3)).astype(np.float32)
        s = max(2, h // 8)
        # id code: shared palette color + unique (stripe1, stripe2, phase)
        stripe_slots = np.arange(2, h - 2 * s - 2, s)
        # per-camera photometric signature (strong, so cameras confound color)
        cam_gain = 0.75 + rng.rand(num_cams, 3) * 0.5
        cam_off = rng.randn(num_cams, 3) * 15.0
        # geometric camera imbalance
        weights = 0.5 ** np.arange(num_cams)
        weights /= weights.sum()
        # unique (stripe1, stripe2, phase) code per id WITHIN a color group —
        # random draws could collide, silently capping achievable mAP
        codes = [(a, b, p) for a in stripe_slots for b in stripe_slots
                 if a != b for p in (0, 1)]
        per_group = -(-num_ids // palette)
        assert len(codes) >= per_group, "too few stripe codes for num_ids"
        group_codes = {}
        for g in range(palette):
            order = rng.permutation(len(codes))[:per_group]
            group_codes[g] = [codes[o] for o in order]
        for pid in range(1, num_ids + 1):
            base = colors[(pid - 1) % palette]
            st1, st2, phase = group_codes[(pid - 1) % palette][
                (pid - 1) // palette]
            cams = rng.choice(num_cams, imgs_per_id, p=weights)
            # guarantee eval coverage: at least one image on cam 0 and cam 1
            cams[0], cams[1] = 0, 1
            # each image's draws in turn: its jitter, its noise, its keypoints
            shifts, noise, keypoints = [], [], []
            for _ in cams:
                shifts.append(rng.randint(-2, 3))
                noise.append(rng.randn(h, w, 3))
                keypoints.append(_random_keypoints(rng, h, w))
            imgs = cls._render(cls._id_image(h, w, base, st1, st2, phase),
                               _patterns(h, w, phase)[1], cam_gain[cams], cam_off[cams],
                               np.asarray(shifts), np.stack(noise))
            seen = set()
            for i, cam in enumerate(cams):
                name = f"{pid:04d}_c{cam + 1}s1_{i:06d}_00.jpg"
                first = cam not in seen
                seen.add(cam)
                if first and cam % 2 == 1:
                    split = "query"
                elif first and cam % 2 == 0:
                    split = "gallery"
                else:
                    split = "train"
                yield (split, name, imgs[i]) + keypoints[i]
