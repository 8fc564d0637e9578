"""Joint GAN + re-ID trainers (port of ``reid_gan_tpu/engine/gan_trainers.py``
``ClusterContrastWithGANTrainer``: ``train``, ``train_all``, ``train_reid``
and ``run_epoch``; and ``GANTrainer.train_gan``; parity:
CC/clustercontrast/trainers.py:52-98,273-335, trainers_b.py:617-814,1087-1138).

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

One ``train`` (AE hard-mix) step, G frozen (gan_trainers.py:91-139):

1. the re-ID image through K4 and the GAN image through K9 (no keypoints:
   the AE generator takes none);
2. the encoder's train forward (K5), which folds its BatchNorm stats;
3. under no gradient, G in train mode: its encoder on all GAN images, the
   per-group ``hard_mix`` of those features by the detached ``feat``, its
   decoder on the mixed features (one image per group), so G's BatchNorm
   folds its running stats twice a step while its parameters never move;
4. K12 re-encodes the synthesized images to the re-ID size, and the encoder
   in eval mode (through the running stats step 2 just folded; K2) gives
   their features, the extra negatives;
5. InfoNCE against the bank plus those negatives, each masked for its own
   group (K6), its backward, the encoder's Adam and the bank fold (K7).

The ``train_reid`` warm-up step is the USL step (``ClusterContrastTrainer``).
The ``train_all_bip`` and ``train_all_with_memory`` modes are not ported yet
(ROADMAP A: bip and learnable-memory modes).
"""

import time
from typing import Any, NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.cluster_memory import MemoryState, memory_loss, update_memory
from ..ops.pose import batch_cords_to_map
from ..ops.transforms import diff_transform, gan_input_transform
from ..utils import AverageMeter
from .trainers import ClusterContrastTrainer, make_optimizer

MODES = ("train", "train_all", "train_reid")


def _drain(buf, meters):
    """Fetch a window's losses (dicts of device scalars) in one transfer and
    add them to ``meters``."""
    if not buf:
        return
    names = list(buf[0])
    rows = torch.stack([torch.stack([e[k].float() for k in names])
                        for e in buf]).cpu().numpy()
    for row in rows:
        for k, v in zip(names, row):
            meters.setdefault(k, AverageMeter()).update(float(v))


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

    def train_step(self, state, batch, seed):
        """One hard-mix ``train`` step (the steps in the module's docstring)
        on a batch of device tensors (``img``, ``pid``, ``Xs``). Returns
        (state, {"loss"} on the device)."""
        gan = self.gan
        targets = batch["pid"]
        enc_dtype = next(self.model.parameters()).dtype
        gan_dtype = next(gan.net_G.parameters()).dtype
        self._mark("start")
        x = self.augment(batch["img"], seed).to(enc_dtype)
        xs = gan_input_transform(batch["Xs"], gan.h, gan.w).to(gan_dtype)
        self._mark("inputs (K4, K9)")
        self.model.train()
        f_out = self.model(x, with_gan_feat=False)["feat"]
        self._mark("encoder forward (K5)")
        with torch.no_grad():
            fc_image = gan.synthesize_fc(xs, f_out.detach().to(gan_dtype),
                                         self.num_instances, train=True)
            self._mark("G (encode, hard mix, decode)")
            self.model.eval()
            f_ex = self.model(diff_transform(fc_image, self.height, self.width)
                              .to(enc_dtype))
            self.model.train()
        self._mark("re-encode (K12, K2)")
        losses, _ = memory_loss(f_out, targets, state.memory, temp=self.temp,
                                ex_f=f_ex, group_size=self.num_instances)
        loss = losses.mean()
        self._mark("InfoNCE (K6)")
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self._mark("backward")
        state.optimizer.step()
        state.scheduler.step()
        self._mark("Adam")
        update_memory(state.memory, f_out.detach(), targets, momentum=self.momentum,
                      use_hard=self.use_hard, group_size=self.num_instances)
        self._mark("bank fold (K7)")
        return state._replace(step=state.step + 1), {"loss": loss.detach()}

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
        # the GAN-feature clustering (ROADMAP A: GAN-feature clustering)
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
        if mode in ("train", "train_all"):
            out["Xs"] = torch.from_numpy(np.ascontiguousarray(batch["Xs"])).to(dev)
        if mode == "train_all":
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
                f"mode {mode!r} is not ported yet (ROADMAP A: bip and learnable-memory modes); "
                f"the port runs "
                f"{MODES}")
        meters = {}
        batch_time, data_time = AverageMeter(), AverageMeter()
        errs_buf = []
        end = window_start = time.time()
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
            elif mode == "train":
                state, errs = self.train_step(state, dev, seed)
            else:
                state, loss = self.step(state, dev["img"], dev["pid"], seed)
                errs = {"loss": loss}
            errs_buf.append(errs)
            end = time.time()
            if (i + 1) % print_freq == 0:
                _drain(errs_buf, meters)
                errs_buf = []
                now = time.time()
                batch_time.update((now - window_start) / print_freq, n=print_freq)
                window_start = end = now
                msg = "\t".join(f"{k} {m.val:.3f} ({m.avg:.3f})"
                                for k, m in meters.items())
                print(f"Epoch: [{epoch}][{i + 1}/{train_iters}]\t"
                      f"Time {batch_time.val:.3f} ({batch_time.avg:.3f})\t"
                      f"Data {data_time.val:.3f} ({data_time.avg:.3f})\t{msg}")
        _drain(errs_buf, meters)
        return state, {k: m.avg for k, m in meters.items()}


class GANTrainer:
    """Standalone GAN pre-training, the warm-up before the joint run
    (gan_trainers.py:545-610; parity: CC/clustercontrast/trainers.py:
    273-335): one D→G iteration of ``gan`` (an ``AEModel`` with the AE
    generator) per batch, on ``device`` (default: the card)."""

    def __init__(self, gan, print_freq=100, device=None):
        self.gan = gan
        self.print_freq = print_freq
        self.device = resolve_device(device)
        gan.net_G.to(self.device)
        gan.net_D.to(self.device)
        self._gen = torch.Generator(device=self.device)

    def train_gan(self, gan_state, epoch, gan_loader, train_iters=400, base_seed=0):
        """``train_iters`` iterations on the uint8 ``Xs`` batches of
        ``gan_loader`` (an ``only_gan`` loader). Iteration i seeds its draws
        (the WGAN-GP interpolation) from ``base_seed + epoch · train_iters +
        i``. The losses stay on the card and are fetched once per
        ``print_freq``. Returns (state, the epoch's mean of each loss)."""
        meters, errs_buf = {}, []
        for i in range(train_iters):
            batch = gan_loader.next()
            xs = torch.from_numpy(np.ascontiguousarray(batch["Xs"])).to(self.device)
            self._gen.manual_seed(base_seed + epoch * train_iters + i)
            gan_state, errs, _ = self.gan.optimize_parameters(gan_state, xs, self._gen)
            errs_buf.append(errs)
            if (i + 1) % self.print_freq == 0:
                _drain(errs_buf, meters)
                errs_buf = []
                msg = "  ".join(f"{k}: {m.avg:.3f}" for k, m in meters.items())
                print(f"GAN Epoch: [{epoch}][{i + 1}/{train_iters}]  {msg}")
        _drain(errs_buf, meters)
        return gan_state, {k: m.avg for k, m in meters.items()}
