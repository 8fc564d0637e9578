"""Cluster-contrast trainer (port of ``reid_gan_tpu/engine/trainers.py``;
parity: CC/clustercontrast/trainers.py:213-270).

One step on the card: uint8 batch → train augmentation (kernel K4) →
``ReIDResNet`` in train mode (cuDNN convolutions and BatchNorm, GeM kernel
K5) → InfoNCE against the memory bank (kernel K6) → backward (K6, K5,
cuDNN) → Adam with coupled weight decay → momentum fold of the detached
``feat`` into the bank (kernel K7), after the optimizer step as
``trainers.py:79-85``. The loop never waits on the card within a print
window: losses stay on the device and are fetched in one transfer every
``print_freq`` steps.

Under a data mesh (``mesh``, one rank a card; JAX ``trainers.py:91-130``)
each rank holds the model, the optimiser and the bank, replicated from rank
0, and takes its contiguous slice of each P×K batch. The augmentation draws
are those of the whole batch from the step's seed, sliced (K4 runs on the
rank's rows); every BatchNorm normalises over the whole batch
(``ops/norm.py``); the loss is the rank's rows' mean and the gradients are
averaged over the ranks before Adam, so the update is one device's on the
whole batch. K7 folds every rank's detached ``feat``, gathered in rank
order (the batch's order), with the whole batch's labels, on every rank,
so the banks stay equal. The logged loss is the mean over the ranks.
"""

import time
from typing import Any, NamedTuple

import numpy as np
import torch

from ..ops.cluster_memory import MemoryState, memory_loss, update_memory
from ..ops.norm import convert_global_bn
from ..ops.transforms import sample_augment_params, train_augment
from ..parallel.mesh import (
    all_gather_rows,
    all_reduce_grads,
    all_reduce_mean,
    mesh_device,
    replicate,
    shard_batch,
)
from ..utils import AverageMeter


class ReIDTrainState(NamedTuple):
    optimizer: torch.optim.Optimizer
    scheduler: Any                 # the per-step learning-rate schedule
    memory: MemoryState
    step: int


def make_optimizer(params, lr=3.5e-4, weight_decay=5e-4, step_size=20,
                   iters_per_epoch=400, gamma=0.1):
    """Adam + L2 weight decay + StepLR(step_size epochs, ×gamma), as
    ``trainers.py:34-49`` (CC/examples/cluster_contrast_train_usl.py: Adam
    3.5e-4, wd 5e-4, StepLR 20). torch's Adam adds the decay to the gradient
    before the moments, as ``optax.add_decayed_weights`` ahead of
    ``scale_by_adam`` does, with the same betas and eps 1e-8. The schedule is
    per optimizer step: lr·gamma^((step // iters_per_epoch) // step_size).
    Only parameters with ``requires_grad`` are optimized (the frozen
    ``feat_bn.bias`` has no counterpart in the JAX tree). Returns
    (optimizer, scheduler); call ``scheduler.step()`` after each update."""
    params = [p for p in params if p.requires_grad]
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: gamma ** ((step // iters_per_epoch) // step_size))
    return opt, sched


def optimizer_params(optimizer):
    return [q for group in optimizer.param_groups for q in group["params"]]


def zero_missing_grads(optimizer):
    """Give a parameter the loss did not reach (a variant's second branch,
    GAN projection or predictor) a zero gradient, as the JAX step does, so
    that Adam's coupled weight decay moves it all the same."""
    for group in optimizer.param_groups:
        for q in group["params"]:
            if q.grad is None:
                q.grad = torch.zeros_like(q)


class ClusterContrastTrainer:
    """USL trainer: a re-clustered memory bank per epoch and a 400-step
    InfoNCE loop (CC/clustercontrast/trainers.py:213-270).

    ``model`` is moved to ``device`` (default: the card; raises if there is
    none) in channels_last memory and trained in place. With ``mesh`` the
    device is the rank's and the model's BatchNorms become global
    (``ops/norm.py``); the steps take the rank's rows of each batch and the
    whole batch's labels (the module's docstring)."""

    def __init__(self, model, height=256, width=128, temp=0.05, momentum=0.2,
                 use_hard=False, lr=3.5e-4, weight_decay=5e-4, step_size=20,
                 iters_per_epoch=400, num_instances=None, device=None, mesh=None):
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        self.model = convert_global_bn(model, mesh).to(self.device,
                                                       memory_format=torch.channels_last)
        self.height, self.width = height, width
        self.temp = temp
        self.momentum = momentum
        self.use_hard = use_hard
        self.num_instances = num_instances
        self.opt_args = dict(lr=lr, weight_decay=weight_decay,
                             step_size=step_size, iters_per_epoch=iters_per_epoch)
        self._gen = torch.Generator(device=self.device)

    def init_state(self, memory):
        """A fresh optimiser over the model and ``memory``; under a mesh the
        model and the bank are rank 0's (``replicate``)."""
        replicate(self.mesh, self.model)
        opt, sched = make_optimizer(self.model.parameters(), **self.opt_args)
        return ReIDTrainState(opt, sched, replicate(self.mesh, memory), 0)

    def set_memory(self, state, memory):
        """Swap in the freshly re-clustered bank at epoch start
        (CC/examples/...usl.py:357-372 rebuilds ClusterMemory per epoch);
        under a mesh, rank 0's."""
        return state._replace(memory=replicate(self.mesh, memory))

    def draws(self, n, seed):
        """The augmentation draws of a batch of ``n`` images from ``seed``."""
        self._gen.manual_seed(seed)
        return sample_augment_params(n, self.height, self.width, self._gen)

    def augment(self, img_u8, seed):
        """The train augmentation of a device uint8 batch, with draws seeded
        by ``seed``; under a mesh ``img_u8`` is the rank's rows and the draws
        are the whole batch's, sliced."""
        n = img_u8.shape[0] * (self.mesh.world_size if self.mesh else 1)
        params = self.draws(n, seed)
        if self.mesh is not None:
            params = shard_batch(self.mesh, params)
        return train_augment(img_u8, params, self.height, self.width)

    def local(self, t):
        """The rank's rows of a whole-batch tensor (``t`` without a mesh)."""
        return t if self.mesh is None else shard_batch(self.mesh, t)

    def gathered(self, t):
        """Every rank's rows of ``t`` in the batch's order (``t`` without a
        mesh)."""
        return all_gather_rows(self.mesh, t)

    def update(self, state, x, targets):
        """Forward, backward, Adam and the bank fold on an augmented batch
        ``x`` (N, 3, H, W); under a mesh ``x`` is the rank's rows and
        ``targets`` the whole batch's. Returns (state, loss on the device)."""
        self.model.train()
        out = self.model(x, with_gan_feat=False)
        losses, _ = memory_loss(out["feat"], self.local(targets), state.memory,
                                temp=self.temp)
        loss = losses.mean()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        zero_missing_grads(state.optimizer)
        all_reduce_grads(self.mesh, optimizer_params(state.optimizer))
        state.optimizer.step()
        state.scheduler.step()
        update_memory(state.memory, self.gathered(out["feat"].detach()), targets,
                      momentum=self.momentum, use_hard=self.use_hard,
                      group_size=self.num_instances)
        return state._replace(step=state.step + 1), \
            all_reduce_mean(self.mesh, loss.detach())

    def step(self, state, img_u8, targets, seed):
        """One train step on a device uint8 batch and int32 targets (under a
        mesh, the rank's rows and the whole batch's targets)."""
        x = self.augment(img_u8, seed)
        param_dtype = next(self.model.parameters()).dtype
        return self.update(state, x.to(param_dtype), targets)

    def train(self, state, epoch, data_loader, train_iters=400, print_freq=10,
              base_seed=0):
        """Run one epoch; returns (state, mean_loss). Step i draws its
        augmentation from seed ``base_seed + epoch * train_iters + i``
        (``trainers.py:130-131``)."""
        batch_time = AverageMeter()
        data_time = AverageMeter()
        losses = AverageMeter()
        loss_buf = []
        end = window_start = time.time()
        for i in range(train_iters):
            batch = data_loader.next()
            data_time.update(time.time() - end)
            img = torch.from_numpy(np.ascontiguousarray(batch["img"])).to(self.device)
            targets = torch.from_numpy(np.asarray(batch["pid"], np.int32)).to(self.device)
            seed = (base_seed + epoch * train_iters + i) & 0x7FFFFFFF
            state, loss = self.step(state, img, targets, seed)
            loss_buf.append(loss)
            end = time.time()
            if (i + 1) % print_freq == 0:
                vals = torch.stack(loss_buf).cpu().numpy()   # one device sync
                loss_buf = []
                for v in vals:
                    losses.update(float(v))
                now = time.time()
                batch_time.update((now - window_start) / print_freq, n=print_freq)
                window_start = end = now
                print(f"Epoch: [{epoch}][{i + 1}/{train_iters}]\t"
                      f"Time {batch_time.val:.3f} ({batch_time.avg:.3f})\t"
                      f"Data {data_time.val:.3f} ({data_time.avg:.3f})\t"
                      f"Loss {losses.val:.3f} ({losses.avg:.3f})")
        for v in torch.stack(loss_buf).cpu().numpy() if loss_buf else []:
            losses.update(float(v))
        return state, losses.avg
