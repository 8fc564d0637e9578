"""Batch samplers (copies of ``reid_gan_tpu/data/sampler.py``'s
``RandomMultipleGallerySampler``, :46-93, parity: CC/clustercontrast/utils/
data/sampler.py:47-107; and ``RandomPairSampler``, :132-163, parity:
FD/reid/utils/data/sampler.py:24-54). Host-side index generation from a
numpy ``RandomState``, drawn in the same order as the JAX package's
samplers, so the same seed gives the same index stream."""

from collections import defaultdict

import numpy as np


def _no_index(a, b):
    return [i for i, j in enumerate(a) if j != b]


class RandomMultipleGallerySampler:
    """P×K sampler preferring instances of the anchor pid from OTHER cameras;
    falls back to other images of the pid; skips singleton pids. Ignores
    pid < 0 (un-clustered outliers)."""

    def __init__(self, data_source, num_instances=4, seed=None):
        self.data_source = data_source
        self.index_pid = {}
        self.pid_cam = defaultdict(list)
        self.pid_index = defaultdict(list)
        self.num_instances = num_instances
        for index, (_, pid, cam) in enumerate(data_source):
            if pid < 0:
                continue
            self.index_pid[index] = pid
            self.pid_cam[pid].append(cam)
            self.pid_index[pid].append(index)
        self.pids = list(self.pid_index.keys())
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.pids) * self.num_instances

    def __iter__(self):
        ret = []
        for kid in self.rng.permutation(len(self.pids)):
            pid = self.pids[kid]
            i = int(self.rng.choice(self.pid_index[pid]))
            _, i_pid, i_cam = self.data_source[i]
            ret.append(i)
            cams = self.pid_cam[pid]
            index = self.pid_index[pid]
            select_cams = _no_index(cams, i_cam)
            if select_cams:
                replace = len(select_cams) < self.num_instances
                cam_indexes = self.rng.choice(select_cams, size=self.num_instances - 1,
                                              replace=replace)
                ret.extend(index[kk] for kk in cam_indexes)
            else:
                select_indexes = _no_index(index, i)
                if not select_indexes:
                    continue  # singleton pid: only the anchor (ref sampler.py:96-98)
                replace = len(select_indexes) < self.num_instances
                ind_indexes = self.rng.choice(select_indexes, size=self.num_instances - 1,
                                              replace=replace)
                ret.extend(index[kk] for kk in ind_indexes)
        return iter(ret)


class RandomPairSampler:
    """FD-GAN pair sampler: for each anchor, in a random order, one
    (anchor, positive) pair (another image of its pid, or itself for a
    singleton) and ``neg_pos_ratio`` (anchor, negative) pairs."""

    def __init__(self, data_source, neg_pos_ratio=1, seed=None):
        self.num_samples = len(data_source)
        self.neg_pos_ratio = neg_pos_ratio
        self.index_map = {i: pid for i, (_, pid, _) in enumerate(data_source)}
        self.pid_index = defaultdict(list)
        for i, (_, pid, _) in enumerate(data_source):
            self.pid_index[pid].append(i)
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return self.num_samples * (1 + self.neg_pos_ratio)

    def __iter__(self):
        for anchor in self.rng.permutation(self.num_samples):
            anchor = int(anchor)
            pid = self.index_map[anchor]
            yield (anchor, int(self.rng.choice(self.pid_index[pid])))
            for _ in range(self.neg_pos_ratio):
                neg = int(self.rng.randint(self.num_samples))
                while self.index_map[neg] == pid:
                    neg = int(self.rng.randint(self.num_samples))
                yield (anchor, neg)
