"""Batch samplers (copies of ``reid_gan_tpu/data/sampler.py``'s
``RandomIdentitySampler``, :22-43, parity: CC/clustercontrast/utils/data/
sampler.py:20-44; ``RandomMultipleGallerySampler``, :46-93, parity:
sampler.py:47-107; ``RandomMultipleGallerySamplerNoCam``, :96-113, parity:
sampler.py:110-155; ``ShardedSampler``, :116-129, the host-sharding
replacement of sampler.py:157-265; and ``RandomPairSampler``, :132-163,
parity: FD/reid/utils/data/sampler.py:24-54). Host-side index generation
from a numpy ``RandomState``, drawn in the same order as the JAX package's
samplers, so the same seed gives the same index stream."""

from collections import defaultdict

import numpy as np


def _no_index(a, b):
    return [i for i, j in enumerate(a) if j != b]


class RandomIdentitySampler:
    """For each pid, in a random order, ``num_instances`` of its samples
    (drawn with replacement where it has fewer)."""

    def __init__(self, data_source, num_instances, seed=None):
        self.index_dic = defaultdict(list)
        for index, (_, pid, _) in enumerate(data_source):
            self.index_dic[pid].append(index)
        self.pids = list(self.index_dic.keys())
        self.num_instances = num_instances
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.pids) * self.num_instances

    def __iter__(self):
        ret = []
        for i in self.rng.permutation(len(self.pids)):
            t = self.index_dic[self.pids[i]]
            replace = len(t) < self.num_instances
            ret.extend(self.rng.choice(t, size=self.num_instances, replace=replace))
        return iter(ret)


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


class RandomMultipleGallerySamplerNoCam(RandomMultipleGallerySampler):
    """The P×K sampler without the camera preference: an anchor of the pid,
    then ``num_instances - 1`` of its other images."""

    def __iter__(self):
        ret = []
        for kid in self.rng.permutation(len(self.pids)):
            pid = self.pids[kid]
            i = int(self.rng.choice(self.pid_index[pid]))
            ret.append(i)
            index = self.pid_index[pid]
            select_indexes = _no_index(index, i)
            if not select_indexes:
                continue
            replace = len(select_indexes) < self.num_instances
            ind_indexes = self.rng.choice(select_indexes, size=self.num_instances - 1,
                                          replace=replace)
            ret.extend(index[kk] for kk in ind_indexes)
        return iter(ret)


class ShardedSampler:
    """Every ``num_shards``-th index of ``sampler``, from ``shard`` on: one
    host's share of a data-parallel epoch."""

    def __init__(self, sampler, shard, num_shards):
        self.sampler = sampler
        self.shard = shard
        self.num_shards = num_shards

    def __len__(self):
        return len(self.sampler) // self.num_shards

    def __iter__(self):
        return iter(list(self.sampler)[self.shard::self.num_shards])


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
