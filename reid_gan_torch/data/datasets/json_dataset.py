"""The open-reid JSON-split dataset format FD-GAN reads: ``meta.json`` +
``splits.json`` + ``images/`` + ``poses/`` (copy of
``reid_gan_tpu/data/datasets/json_dataset.py``; parity:
FD/reid/utils/data/dataset.py:8-100, FD/reid/datasets/cuhk03.py).

``meta.json`` lists each identity's images by camera, by names relative to
``images/``; a loader reads them with ``root=dataset.images_dir``.
"""

import json
import os.path as osp

from .base import BaseImageDataset


def _pluck(identities, indices, relabel=False):
    """Flatten the nested identities[pid][cam] → [fname...] structure into
    (fname, pid, camid) triples, the pid relabelled to its index in
    ``indices`` with ``relabel`` (FD/reid/utils/data/dataset.py:8-30)."""
    ret = []
    for index, pid in enumerate(indices):
        for camid, cam_images in enumerate(identities[pid]):
            for fname in cam_images:
                ret.append((fname, index if relabel else pid, camid))
    return ret


class JsonDataset(BaseImageDataset):
    """FD-GAN's dataset: the JSON metadata, the train/val/trainval/query/
    gallery splits of split ``split_id``, and ``pid_imgs``, each trainval
    pid → its image names, from which the pose loader picks a same-identity
    target (FD/reid/utils/data/dataset.py:53-94). ``num_val``: the last
    trainval ids held out as val, a count or, as a float, a fraction."""

    def __init__(self, root, split_id=0, num_val=100, verbose=True, **kwargs):
        self.root = root
        self.split_id = split_id
        self.load(num_val, verbose=verbose)

    @property
    def images_dir(self):
        return osp.join(self.root, "images")

    @property
    def poses_dir(self):
        # FD/reid/utils/data/dataset.py:49-51
        return osp.join(self.root, "poses")

    def load(self, num_val=100, verbose=True):
        with open(osp.join(self.root, "splits.json")) as f:
            splits = json.load(f)
        if self.split_id >= len(splits):
            raise ValueError(f"split_id exceeds total splits {len(splits)}")
        self.split = splits[self.split_id]

        trainval_pids = sorted(self.split["trainval"])
        num = len(trainval_pids)
        if isinstance(num_val, float):
            num_val = int(round(num * num_val))
        if num_val >= num or num_val < 0:
            raise ValueError(f"num_val exceeds total identities {num}")
        train_pids = sorted(trainval_pids[:-num_val]) if num_val else trainval_pids
        val_pids = sorted(trainval_pids[-num_val:]) if num_val else []

        with open(osp.join(self.root, "meta.json")) as f:
            self.meta = json.load(f)
        identities = self.meta["identities"]
        self.train = _pluck(identities, train_pids, relabel=True)
        self.val = _pluck(identities, val_pids, relabel=True)
        self.trainval = _pluck(identities, trainval_pids, relabel=True)
        self.query = _pluck(identities, self.split["query"])
        self.gallery = _pluck(identities, self.split["gallery"])
        self.num_train_ids = len(train_pids)
        self.num_val_ids = len(val_pids)
        self.num_trainval_ids = len(trainval_pids)

        # pid → image names, for the pose loader's same-id targets
        # (FD/baseline.py get_data builds this as pid_imgs)
        self.pid_imgs = {}
        for fname, pid, _ in self.trainval:
            self.pid_imgs.setdefault(pid, set()).add(fname)

        if verbose:
            print(self.__class__.__name__, "json dataset loaded")
            print("  subset   | # ids | # images")
            print("  ---------------------------")
            print(f"  train    | {self.num_train_ids:5d} | {len(self.train):8d}")
            print(f"  val      | {self.num_val_ids:5d} | {len(self.val):8d}")
            print(f"  trainval | {self.num_trainval_ids:5d} | {len(self.trainval):8d}")
            print(f"  query    | {len(self.split['query']):5d} | {len(self.query):8d}")
            print(f"  gallery  | {len(self.split['gallery']):5d} | {len(self.gallery):8d}")


class CUHK03(JsonDataset):
    """CUHK03 in the open-reid JSON layout (parity: FD/reid/datasets/
    cuhk03.py: the integrity check, then ``load(num_val)``). No converter
    ships: the prepared ``meta.json``/``splits.json``/``images/`` tree is
    expected. FD-GAN's evaluators score it under the cuhk03 CMC protocol
    (single gallery shot, separate camera set) for ``dataset='cuhk03'``."""

    def __init__(self, root, split_id=0, num_val=100, verbose=True, **kwargs):
        if not self._check_integrity(root):
            raise RuntimeError(
                "CUHK03 dataset not found or corrupted at %r. Prepare the "
                "open-reid layout (meta.json + splits.json + images/) first."
                % root)
        super().__init__(root, split_id=split_id, num_val=num_val,
                         verbose=verbose, **kwargs)

    @staticmethod
    def _check_integrity(root):
        return (osp.isfile(osp.join(root, "meta.json"))
                and osp.isfile(osp.join(root, "splits.json"))
                and osp.isdir(osp.join(root, "images")))
