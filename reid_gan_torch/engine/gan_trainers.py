"""Joint GAN + re-ID trainer (port of ``reid_gan_tpu/engine/gan_trainers.py``
``ClusterContrastWithGANTrainer``: ``train_all``, ``train_reid`` and
``run_epoch``; parity: CC/clustercontrast/trainers_b.py:617-814,1087-1138).

One ``train_all`` step on the card:

1. the uint8 batches: the re-ID image through the train augmentation (K4),
   the GAN image through the GAN input transform (K9), the keypoints through
   the pose maps (K10);
2. the encoder's train forward: ``feat`` through GeM (K5) and the
   detached ``gan_feat`` map (K11);
3. the generator on (``gan_feat``, pose maps), in train mode: its BatchNorm
   normalises with batch stats and updates its running stats once a step;
4. the G loss against the discriminator as it stands (the pre-update D), in
   train mode, so its spectral ``u``/``sigma`` advance; the conf-weighted
   InfoNCE against the bank (K6); their sum's backward reaches the encoder
   through ``feat`` only and G through the fake (K6's and K5's backward);
5. the D step on the detached fake, real first, from the ``u`` the G loss
   left, then D's Adam;
6. the encoder's Adam (and its per-step schedule) and G's Adam;
7. the momentum fold of ``feat`` into the bank (K7).

The joint backward runs before the D step's forwards: D's power iteration
and optimizer update its buffers and parameters in place, which would break
the tensors the G loss saved. The D step reads only the detached fake and
D's buffers, so the order leaves the JAX step's math unchanged.

The ``train_reid`` warm-up step is the USL step (``ClusterContrastTrainer``).
The ``train`` (AE hard-mix), ``train_all_bip`` and ``train_all_with_memory``
modes are not ported yet (ROADMAP A6).
"""

import time
from typing import Any, NamedTuple

import numpy as np
import torch

from ..ops.cluster_memory import MemoryState, memory_loss, update_memory
from ..ops.pose import batch_cords_to_map
from ..ops.transforms import gan_input_transform
from ..utils import AverageMeter
from .trainers import ClusterContrastTrainer, make_optimizer

MODES = ("train_all", "train_reid")


class JointState(NamedTuple):
    optimizer: torch.optim.Optimizer   # the encoder's Adam
    scheduler: Any                     # its per-step learning-rate schedule
    memory: MemoryState
    step: int
    gan: Any                           # AEState


class ClusterContrastWithGANTrainer(ClusterContrastTrainer):
    """The joint trainer: ``model`` (a ``ReIDResNet``) and ``gan`` (an
    ``AEModel``) are trained in place on ``device`` (default: the card)."""

    def __init__(self, model, gan, height=256, width=128, temp=0.05, momentum=0.2,
                 use_hard=False, lr=3.5e-4, weight_decay=5e-4, step_size=20,
                 iters_per_epoch=400, num_instances=16, device=None):
        super().__init__(model, height, width, temp, momentum, use_hard, lr,
                         weight_decay, step_size, iters_per_epoch, num_instances,
                         device)
        self.gan = gan
        gan.net_G.to(self.device)
        gan.net_D.to(self.device)
        # a list to collect (phase, CUDA event) pairs at the joint step's
        # phase boundaries, for a device-time split; None records nothing
        self.marks = None

    def _mark(self, phase):
        if self.marks is not None:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append((phase, event))

    def init_state(self, memory, gan_state):
        opt, sched = make_optimizer(self.model.parameters(), **self.opt_args)
        return JointState(opt, sched, memory, 0, gan_state)

    def train_all_step(self, state, batch, seed, conf):
        """One joint step on a batch of device tensors (``img``, ``pid``,
        ``Xs``, ``keypoints``, ``old_size``) with per-sample confidence
        weights ``conf``. Returns (state, losses on the device)."""
        gan, gs = self.gan, state.gan
        targets = batch["pid"]
        enc_dtype = next(self.model.parameters()).dtype
        gan_dtype = next(gan.net_G.parameters()).dtype
        self._mark("start")
        x = self.augment(batch["img"], seed).to(enc_dtype)
        xs = gan_input_transform(batch["Xs"], gan.h, gan.w).to(gan_dtype)
        ps = batch_cords_to_map(batch["keypoints"], batch["old_size"], gan.h,
                                gan.w).to(gan_dtype)
        self._mark("inputs (K4, K9, K10)")

        self.model.train()
        out = self.model(x, with_gan_feat=True)
        f_out = out["feat"]
        self._mark("encoder forward (K5, K11)")
        fake = gan.synthesize_p(out["gan_feat"].to(gan_dtype), ps, train=True)
        self._mark("G forward")
        loss_G = gan.get_loss_G_train(fake, xs)
        self._mark("G loss (D forward)")
        losses_cl, _ = memory_loss(f_out, targets, state.memory, temp=self.temp)
        loss_cl = (losses_cl * conf.to(losses_cl.dtype)).mean()
        loss = loss_cl + loss_G
        self._mark("InfoNCE (K6)")
        state.optimizer.zero_grad(set_to_none=True)
        gs.opt_G.zero_grad(set_to_none=True)
        loss.backward()
        self._mark("joint backward (encoder, G, D input)")

        gs.opt_D.zero_grad(set_to_none=True)
        loss_D = gan.d_loss(xs, fake)
        loss_D.backward()
        gs.opt_D.step()
        self._mark("D step")

        state.optimizer.step()
        state.scheduler.step()
        gs.opt_G.step()
        self._mark("Adam (encoder, G)")
        # the parallel GAN bank (gan_x) is empty on this path: it comes with
        # the GAN-feature clustering (ROADMAP A6)
        update_memory(state.memory, f_out.detach(), targets, momentum=self.momentum,
                      use_hard=self.use_hard, group_size=self.num_instances)
        self._mark("bank fold (K7)")
        state = state._replace(step=state.step + 1,
                               gan=gs._replace(step=gs.step + 1))
        return state, {"loss": loss.detach(), "loss_cl": loss_cl.detach(),
                       "G": loss_G.detach(), "D": loss_D.detach()}

    def _to_device(self, batch, mode):
        dev = self.device
        out = {"img": torch.from_numpy(np.ascontiguousarray(batch["img"])).to(dev),
               "pid": torch.from_numpy(np.asarray(batch["pid"], np.int32)).to(dev)}
        if mode == "train_all":
            out["Xs"] = torch.from_numpy(np.ascontiguousarray(batch["Xs"])).to(dev)
            for k in ("keypoints", "old_size"):
                out[k] = torch.from_numpy(np.asarray(batch[k], np.float32)).to(dev)
        return out

    def run_epoch(self, state, epoch, data_loader, mode="train_all", train_iters=400,
                  print_freq=10, base_seed=0, conf_weight=None):
        """Drive one epoch in ``mode`` (gan_trainers.py:485-561). Step i
        draws from seed ``base_seed + epoch * train_iters + i``.
        ``conf_weight``: optional (N_dataset,) host array of per-sample
        confidence weights, indexed by the batch's ``index``. The losses stay
        on the card and are fetched once a print window. Returns (state,
        the epoch's mean of each loss)."""
        if mode not in MODES:
            raise NotImplementedError(
                f"mode {mode!r} is not ported yet (ROADMAP A6); the port runs "
                f"{MODES}")
        meters = {}
        batch_time, data_time = AverageMeter(), AverageMeter()
        errs_buf = []
        end = window_start = time.time()

        def drain(buf):
            if not buf:
                return
            names = list(buf[0])
            rows = torch.stack([torch.stack([e[k].float() for k in names])
                                for e in buf]).cpu().numpy()   # one sync
            for row in rows:
                for k, v in zip(names, row):
                    meters.setdefault(k, AverageMeter()).update(float(v))

        for i in range(train_iters):
            batch = data_loader.next()
            data_time.update(time.time() - end)
            dev = self._to_device(batch, mode)
            seed = (base_seed + epoch * train_iters + i) & 0x7FFFFFFF
            if mode == "train_all":
                conf = np.ones(len(batch["pid"]), np.float32) if conf_weight is None \
                    else np.asarray(conf_weight[np.asarray(batch["index"])], np.float32)
                state, errs = self.train_all_step(
                    state, dev, seed, torch.from_numpy(conf).to(self.device))
            else:
                state, loss = self.step(state, dev["img"], dev["pid"], seed)
                errs = {"loss": loss}
            errs_buf.append(errs)
            end = time.time()
            if (i + 1) % print_freq == 0:
                drain(errs_buf)
                errs_buf = []
                now = time.time()
                batch_time.update((now - window_start) / print_freq, n=print_freq)
                window_start = end = now
                msg = "\t".join(f"{k} {m.val:.3f} ({m.avg:.3f})"
                                for k, m in meters.items())
                print(f"Epoch: [{epoch}][{i + 1}/{train_iters}]\t"
                      f"Time {batch_time.val:.3f} ({batch_time.avg:.3f})\t"
                      f"Data {data_time.val:.3f} ({data_time.avg:.3f})\t{msg}")
        drain(errs_buf)
        return state, {k: m.avg for k, m in meters.items()}
