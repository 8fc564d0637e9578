"""Directory-scanning datasets: Market-1501, DukeMTMC-reID, MSMT17, PersonX,
VeRi — all use the ``{pid}_c{camid}...jpg`` filename convention with
bounding_box_train / query / bounding_box_test subdirs
(parity: CC/clustercontrast/datasets/*.py; Market pose CSVs per
market1501.py:28-29).
"""

import glob
import os.path as osp
import re

from .base import BaseImageDataset

_PATTERN = re.compile(r"([-\d]+)_c(\d+)")


def scan_dir(dir_path, relabel=False, ext="jpg", names=None):
    """Glob a split dir into a sorted list of (abs_path, pid, camid);
    pid −1 (junk) is dropped; camids are 0-based
    (CC/clustercontrast/datasets/market1501.py:60-84). ``names``: the
    split's file names in place of the directory's (a set whose images are
    held in memory)."""
    img_paths = sorted(glob.glob(osp.join(dir_path, f"*.{ext}")) if names is None
                       else (osp.join(dir_path, n) for n in names))
    pid_container = set()
    for p in img_paths:
        m = _PATTERN.search(osp.basename(p))
        if m is None:
            continue
        pid = int(m.group(1))
        if pid == -1:
            continue
        pid_container.add(pid)
    pid2label = {pid: label for label, pid in enumerate(sorted(pid_container))}
    dataset = []
    for p in img_paths:
        m = _PATTERN.search(osp.basename(p))
        if m is None:
            continue
        pid, camid = int(m.group(1)), int(m.group(2))
        if pid == -1:
            continue
        camid -= 1
        if relabel:
            pid = pid2label[pid]
        dataset.append((p, pid, camid))
    return dataset


class _DirDataset(BaseImageDataset):
    dataset_dir = None
    name = None
    ext = "jpg"
    train_sub = "bounding_box_train"
    query_sub = "query"
    gallery_sub = "bounding_box_test"

    def __init__(self, root, verbose=True, **kwargs):
        self.dataset_dir = osp.join(root, self.dataset_dir)
        self.train_dir = osp.join(self.dataset_dir, self.train_sub)
        self.query_dir = osp.join(self.dataset_dir, self.query_sub)
        self.gallery_dir = osp.join(self.dataset_dir, self.gallery_sub)
        for d in (self.dataset_dir, self.train_dir, self.query_dir, self.gallery_dir):
            if not osp.exists(d):
                raise RuntimeError(f"'{d}' is not available")
        self.train = scan_dir(self.train_dir, relabel=True, ext=self.ext)
        self.query = scan_dir(self.query_dir, relabel=False, ext=self.ext)
        self.gallery = scan_dir(self.gallery_dir, relabel=False, ext=self.ext)
        if verbose:
            print(f"=> {self.name} loaded")
            self.print_dataset_statistics(self.train, self.query, self.gallery)
        self.num_train_pids, self.num_train_imgs, self.num_train_cams = (
            self.get_imagedata_info(self.train))
        self.num_query_pids, self.num_query_imgs, self.num_query_cams = (
            self.get_imagedata_info(self.query))
        self.num_gallery_pids, self.num_gallery_imgs, self.num_gallery_cams = (
            self.get_imagedata_info(self.gallery))


class Market1501(_DirDataset):
    """Market-1501: 751 train ids / 12,936 train images
    (CC/clustercontrast/datasets/market1501.py). Carries pose-annotation CSV
    paths for the GAN branch (market1501.py:28-29)."""
    dataset_dir = "Market-1501-v15.09.15"
    name = "Market1501"

    def __init__(self, root, verbose=True, **kwargs):
        super().__init__(root, verbose=verbose, **kwargs)
        self.train_pose_dir = osp.join(self.dataset_dir, "market-annotation-train.csv")
        self.test_pose_dir = osp.join(self.dataset_dir, "market-annotation-test.csv")


class DukeMTMC(_DirDataset):
    dataset_dir = "DukeMTMC-reID"
    name = "DukeMTMC-reID"

    def __init__(self, root, verbose=True, **kwargs):
        super().__init__(root, verbose=verbose, **kwargs)
        self.train_pose_dir = osp.join(self.dataset_dir, "duke-annotation-train.csv")
        self.test_pose_dir = osp.join(self.dataset_dir, "duke-annotation-test.csv")


class MSMT17(_DirDataset):
    dataset_dir = "MSMT17_V1"
    name = "MSMT17_V1"


class PersonX(_DirDataset):
    dataset_dir = "PersonX"
    name = "PersonX"


class VeRi(_DirDataset):
    dataset_dir = "VeRi"
    name = "VeRi"
    train_sub = "image_train"
    query_sub = "image_query"
    gallery_sub = "image_test"
