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
   train mode, so its spectral ``u``/``sigma`` advance, with ``use_vgg`` the
   VGG19 perceptual terms of the fake against the GAN image; the conf-weighted
   InfoNCE against the bank (K6); their sum's backward reaches the encoder
   through ``feat`` only and G through the fake (K6's and K5's backward);
5. the D step on the detached fake, real first, from the ``u`` the G loss
   left, then D's Adam;
6. the encoder's Adam (and its per-step schedule) and G's Adam;
7. the momentum fold of ``feat`` into the bank and, where the bank has a
   GAN half (GAN-feature clustering), of the GAN map's spatial mean into
   it, both in one launch (K7).

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

Under a data mesh (JAX ``gan_trainers.py:63-76,498-560``) every mode runs
on each rank's contiguous slice of the batch (K4 with the whole batch's
draws, sliced; K9, K10 on the rank's rows; K6 with the rank's labels); the
encoder, G and D are replicated from rank 0 and their BatchNorms normalise
over the whole batch (``ops/norm.py``); the encoder's and G's gradients
(and the learnable clusters') are averaged over the ranks after the joint
backward, D's after its own, each before its optimizer step; the banks fold
every rank's rows, gathered in the batch's order, in K7's one launch; the
WGAN-GP penalty's mixing weights are the whole batch's, drawn from the
step's generator on every rank and sliced; the logged losses are the ranks'
means. The hard-mix step's global pieces are computed alike on every rank:
``hard_mix`` picks its rows from the gathered ``feat`` and takes them from
the ranks that own them, G's decoder normalises its G mixed rows (one a
group) as they are, with no collective, and the re-encode runs on those G
images, so every rank holds every extra negative; K6 masks each of the
rank's rows for its global group (``row0``).

One ``train_all_bip`` step (gan_trainers.py:392-466), the bi-path encoder
(``ResNetBip``) and the AE generator:

1. the re-ID image through K4, the GAN image through K9;
2. the encoder's train forward with ``fuse=False``: both branches' ``feat``
   and ``feat2`` (K5 on each);
3. G in train mode reconstructs the GAN image; the G loss against the
   pre-update D; InfoNCE of each branch against the same bank (K6 twice),
   ``loss_cl`` their means' half-sum; the joint backward;
4. the D step on the detached fake, the encoder's and G's Adam;
5. the fold of the unnormalised ``feat + feat2`` into the bank (K7, which
   normalises each row first).

One ``train_all_with_memory`` step (gan_trainers.py:290-390), the pose
generator and trainable clusters (a ``GradientMemoryState``) in place of the
momentum bank, which stays as it is (no K7):

1. K4, K9 and K10 on the inputs;
2. the encoder's train forward (K5);
3. G renders each sample's cluster, L2-normalised and broadcast to the GAN
   map's (h/8, w/8), in the sample's pose, in train mode; the G loss
   against the pre-update D; InfoNCE against the normalised, detached
   clusters (K6); the joint backward reaches the encoder, G and, through G
   only, the clusters;
4. the D step, the encoder's and G's Adam, and the clusters' SGD step on
   the rows the batch touched (``update_gradient_clusters``).
"""

import time
from typing import Any, NamedTuple

import numpy as np
import torch

from ..ops.cluster_memory import (
    MemoryState,
    gradient_memory_loss,
    memory_loss,
    update_gradient_clusters,
    update_memory,
)
from ..ops.norm import convert_global_bn
from ..ops.pose import batch_cords_to_map
from ..ops.transforms import diff_transform, gan_input_transform
from ..parallel.mesh import (
    all_reduce_grads,
    all_reduce_mean,
    all_reduce_means,
    mesh_device,
    replicate,
    shard_batch,
)
from ..utils import AverageMeter
from .trainers import (
    ClusterContrastTrainer,
    make_optimizer,
    optimizer_params,
    zero_missing_grads,
)

MODES = ("train", "train_all", "train_reid", "train_all_bip", "train_all_with_memory")


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
    ``AEModel``) are trained in place on ``device`` (default: the card), or
    on the rank's card of ``mesh`` (the module's docstring)."""

    def __init__(self, model, gan, height=256, width=128, temp=0.05, momentum=0.2,
                 use_hard=False, lr=3.5e-4, weight_decay=5e-4, step_size=20,
                 iters_per_epoch=400, num_instances=16, device=None, mesh=None):
        super().__init__(model, height, width, temp, momentum, use_hard, lr,
                         weight_decay, step_size, iters_per_epoch, num_instances,
                         device, mesh)
        self.gan = gan
        gan.net_G = convert_global_bn(gan.net_G, mesh)
        gan.net_D = convert_global_bn(gan.net_D, mesh)
        gan.to(self.device)
        # a list to collect (phase, CUDA event) pairs at the joint step's
        # phase boundaries, for a device-time split; None records nothing
        self.marks = None

    def _mark(self, phase):
        if self.marks is not None:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append((phase, event))

    def init_state(self, memory, gan_state):
        """The encoder's fresh optimiser, ``memory`` and ``gan_state``; under
        a mesh the encoder, G, D and the bank are rank 0's."""
        for net in (self.model, self.gan.net_G, self.gan.net_D):
            replicate(self.mesh, net)
        opt, sched = make_optimizer(self.model.parameters(), **self.opt_args)
        return JointState(opt, sched, replicate(self.mesh, memory), 0, gan_state)

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
        feat = self.gathered(f_out.detach())
        self._mark("encoder forward (K5)")
        with torch.no_grad():
            fc_image = gan.synthesize_fc(xs, feat.to(gan_dtype), self.num_instances,
                                         train=True, mesh=self.mesh)
            self._mark("G (encode, hard mix, decode)")
            self.model.eval()
            f_ex = self.model(diff_transform(fc_image, self.height, self.width)
                              .to(enc_dtype))
            self.model.train()
        self._mark("re-encode (K12, K2)")
        losses, _ = memory_loss(f_out, self.local(targets), state.memory, temp=self.temp,
                                ex_f=f_ex, group_size=self.num_instances,
                                row0=self.row0(f_out.shape[0]))
        loss = losses.mean()
        self._mark("InfoNCE (K6)")
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_grads(self.mesh, optimizer_params(state.optimizer))
        self._mark("backward")
        state.optimizer.step()
        state.scheduler.step()
        self._mark("Adam")
        update_memory(state.memory, feat, targets, momentum=self.momentum,
                      use_hard=self.use_hard, group_size=self.num_instances)
        self._mark("bank fold (K7)")
        return state._replace(step=state.step + 1), \
            {"loss": all_reduce_mean(self.mesh, loss.detach())}

    def train_all_step(self, state, batch, seed, conf):
        """One joint step on a batch of device tensors (``img``, ``pid``,
        ``Xs``, ``keypoints``, ``old_size``) with per-sample confidence
        weights ``conf``. Under a mesh ``pid`` and ``conf`` are the whole
        batch's and the rest the rank's rows. Returns (state, losses on the
        device)."""
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
        losses_cl, _ = memory_loss(f_out, self.local(targets), state.memory,
                                   temp=self.temp)
        loss_cl = (losses_cl * self.local(conf).to(losses_cl.dtype)).mean()
        loss = loss_cl + loss_G
        self._mark("InfoNCE (K6)")
        loss_D = self._joint_update(state, loss, xs, fake)
        # the parallel GAN bank, where there is one, takes the pooled GAN map
        # (gan_trainers.py:241-249)
        gan_x = self.gathered(out["gan_feat"].mean(dim=(2, 3))) \
            if state.memory.gan_features.shape[0] else None
        update_memory(state.memory, self.gathered(f_out.detach()), targets,
                      momentum=self.momentum, use_hard=self.use_hard, gan_x=gan_x,
                      group_size=self.num_instances)
        self._mark("bank fold (K7)")
        state = state._replace(step=state.step + 1,
                               gan=gs._replace(step=gs.step + 1))
        return state, all_reduce_means(self.mesh, {
            "loss": loss.detach(), "loss_cl": loss_cl.detach(), "G": loss_G.detach(),
            "D": loss_D})

    def train_all_bip_step(self, state, batch, seed):
        """One bi-path step (the steps in the module's docstring) on a batch
        of device tensors (``img``, ``pid``, ``Xs``; under a mesh ``pid`` is
        the whole batch's and the rest the rank's rows). Returns (state,
        losses on the device)."""
        gan, gs = self.gan, state.gan
        targets = batch["pid"]
        enc_dtype = next(self.model.parameters()).dtype
        gan_dtype = next(gan.net_G.parameters()).dtype
        self._mark("start")
        x = self.augment(batch["img"], seed).to(enc_dtype)
        xs = gan_input_transform(batch["Xs"], gan.h, gan.w).to(gan_dtype)
        self._mark("inputs (K4, K9)")
        self.model.train()
        out = self.model(x, fuse=False)
        f1, f2 = out["feat"], out["feat2"]
        self._mark("encoder forward (K5 twice)")
        fake = gan.apply_G(xs, train=True)
        self._mark("G forward")
        loss_G = gan.get_loss_G_train(fake, xs)
        self._mark("G loss (D forward)")
        l1, _ = memory_loss(f1, self.local(targets), state.memory, temp=self.temp)
        l2, _ = memory_loss(f2, self.local(targets), state.memory, temp=self.temp)
        loss_cl = 0.5 * (l1.mean() + l2.mean())
        loss = loss_cl + loss_G
        self._mark("InfoNCE (K6 twice)")
        loss_D = self._joint_update(state, loss, xs, fake)
        update_memory(state.memory, self.gathered((f1 + f2).detach()), targets,
                      momentum=self.momentum, use_hard=self.use_hard,
                      group_size=self.num_instances)
        self._mark("bank fold (K7)")
        state = state._replace(step=state.step + 1, gan=gs._replace(step=gs.step + 1))
        return state, all_reduce_means(self.mesh, {
            "loss": loss.detach(), "loss_cl": loss_cl.detach(), "G": loss_G.detach(),
            "D": loss_D})

    def render_from_clusters(self, clusters, targets, ps):
        """G's train-mode render of each sample's cluster (a row of
        ``clusters`` L2-normalised with ``rsqrt(Σc² + 1e-12)``, broadcast to
        (B, D, h/8, w/8)) in its pose maps ``ps`` (gan_trainers.py:322-334)."""
        gan = self.gan
        cf = clusters * torch.rsqrt(torch.sum(clusters * clusters, -1, keepdim=True)
                                    + 1e-12)
        feats = cf[targets.long()]
        fmap = feats[:, :, None, None].expand(-1, -1, gan.h // 8, gan.w // 8)
        return gan.synthesize_p(fmap.to(ps.dtype), ps, train=True)  # ps: G's dtype

    def train_all_with_memory_step(self, state, gmem, batch, seed, cluster_lr=0.1):
        """One learnable-memory step (the steps in the module's docstring) on
        a batch of device tensors (``img``, ``pid``, ``Xs``, ``keypoints``,
        ``old_size``) and the clusters ``gmem`` (a ``GradientMemoryState``);
        under a mesh ``pid`` is the whole batch's and the rest the rank's
        rows, and the clusters' gradient is averaged over the ranks with
        the encoder's and G's, so every rank steps the same clusters.
        Returns (state, the new ``gmem``, losses on the device)."""
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
        f_out = self.model(x, with_gan_feat=False)["feat"]
        self._mark("encoder forward (K5)")
        clusters = gmem.clusters.detach().requires_grad_(True)
        fake = self.render_from_clusters(clusters, self.local(targets), ps)
        self._mark("G forward (from the clusters)")
        loss_G = gan.get_loss_G_train(fake, xs)
        self._mark("G loss (D forward)")
        loss_cl, _ = gradient_memory_loss(f_out, self.local(targets),
                                          gmem._replace(clusters=clusters), temp=self.temp)
        loss = loss_cl + loss_G
        self._mark("InfoNCE (K6)")
        loss_D = self._joint_update(state, loss, xs, fake, extra=[clusters])
        touched = torch.zeros(clusters.shape[0], dtype=torch.bool,
                              device=clusters.device).index_fill_(0, targets.long(), True)
        gmem = update_gradient_clusters(gmem, clusters.grad, touched, cluster_lr)
        self._mark("cluster SGD")
        state = state._replace(step=state.step + 1, gan=gs._replace(step=gs.step + 1))
        return state, gmem, all_reduce_means(self.mesh, {
            "loss": loss.detach(), "loss_cl": loss_cl.detach(), "G": loss_G.detach(),
            "D": loss_D})

    def row0(self, n):
        """The global index of the rank's first row in a batch of ``n`` rows
        a rank (0 without a mesh)."""
        return 0 if self.mesh is None else self.mesh.rank * n

    def gp_draws(self, n, dtype):
        """The WGAN-GP penalty's mixing weights (n, 1, 1, 1) of a whole batch
        of ``n``, uniform from the step's generator (seeded by the step's
        seed, after its augmentation draws), alike on every rank."""
        return torch.rand((n, 1, 1, 1), generator=self._gen, device=self.device,
                          dtype=dtype)

    def _joint_update(self, state, loss, xs, fake, extra=()):
        """The joint modes' updates: the joint backward (encoder, G and
        whatever else ``loss`` reaches), the D step on the detached fake from
        the ``u`` the G loss left, then the encoder's Adam (a parameter the
        loss missed gets a zero gradient) with its schedule and G's Adam.
        Under a mesh the gradients are averaged over the ranks, with those of
        the tensors ``extra`` (the learnable clusters), and the WGAN-GP
        penalty takes the rank's rows of the whole batch's ``gp_draws``.
        Returns the D loss, detached."""
        gs = state.gan
        state.optimizer.zero_grad(set_to_none=True)
        gs.opt_G.zero_grad(set_to_none=True)
        loss.backward()
        alpha = None
        if self.mesh is not None:
            zero_missing_grads(state.optimizer)
            all_reduce_grads(self.mesh, optimizer_params(state.optimizer) +
                             optimizer_params(gs.opt_G) + list(extra))
            if self.gan.gan_mode == "wgangp":
                alpha = self.local(self.gp_draws(xs.shape[0] * self.mesh.world_size,
                                                 xs.dtype))
        self._mark("joint backward (encoder, G, D input)")
        gs.opt_D.zero_grad(set_to_none=True)
        loss_D = self.gan.d_loss(xs, fake, alpha=alpha)
        loss_D.backward()
        all_reduce_grads(self.mesh, optimizer_params(gs.opt_D))
        gs.opt_D.step()
        self._mark("D step")
        zero_missing_grads(state.optimizer)
        state.optimizer.step()
        state.scheduler.step()
        gs.opt_G.step()
        self._mark("Adam (encoder, G)")
        return loss_D.detach()

    def _to_device(self, batch, mode):
        dev = self.device
        out = {"img": torch.from_numpy(np.ascontiguousarray(batch["img"])).to(dev),
               "pid": torch.from_numpy(np.asarray(batch["pid"], np.int32)).to(dev)}
        if mode != "train_reid":
            out["Xs"] = torch.from_numpy(np.ascontiguousarray(batch["Xs"])).to(dev)
        if mode in ("train_all", "train_all_with_memory"):
            for k in ("keypoints", "old_size"):
                out[k] = torch.from_numpy(np.asarray(batch[k], np.float32)).to(dev)
        return out

    def run_epoch(self, state, epoch, data_loader, mode="train_all", train_iters=400,
                  print_freq=10, base_seed=0, conf_weight=None, gmem=None,
                  cluster_lr=0.1):
        """Drive one epoch in ``mode`` (gan_trainers.py:485-561). Step i
        draws from seed ``base_seed + epoch * train_iters + i``.
        ``conf_weight``: optional (N_dataset,) host array of per-sample
        confidence weights, indexed by the batch's ``index`` (``train_all``
        only). ``gmem``: the clusters of ``train_all_with_memory``, stepped
        with ``cluster_lr``. The losses stay on the card and are fetched
        once a print window. Returns (state, the epoch's mean of each loss),
        and for ``train_all_with_memory`` (state, gmem, means)."""
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; the modes are {MODES}")
        if mode == "train_all_with_memory" and gmem is None:
            raise ValueError("train_all_with_memory needs the clusters (gmem)")
        meters = {}
        batch_time, data_time = AverageMeter(), AverageMeter()
        errs_buf = []
        end = window_start = time.time()
        for i in range(train_iters):
            batch = data_loader.next()
            data_time.update(time.time() - end)
            dev = self._to_device(batch, mode)
            seed = (base_seed + epoch * train_iters + i) & 0x7FFFFFFF
            if mode == "train_all":   # the whole batch's weights (``index``)
                conf = np.ones(len(batch["pid"]), np.float32) if conf_weight is None \
                    else np.asarray(conf_weight[np.asarray(batch["index"])], np.float32)
                state, errs = self.train_all_step(
                    state, dev, seed, torch.from_numpy(conf).to(self.device))
            elif mode == "train":
                state, errs = self.train_step(state, dev, seed)
            elif mode == "train_all_bip":
                state, errs = self.train_all_bip_step(state, dev, seed)
            elif mode == "train_all_with_memory":
                state, gmem, errs = self.train_all_with_memory_step(
                    state, gmem, dev, seed, cluster_lr)
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
        avg = {k: m.avg for k, m in meters.items()}
        if mode == "train_all_with_memory":
            return state, gmem, avg
        return state, avg


class GANTrainer:
    """Standalone GAN pre-training, the warm-up before the joint run
    (gan_trainers.py:545-610; parity: CC/clustercontrast/trainers.py:
    273-335): one D→G iteration of ``gan`` (an ``AEModel`` with the AE
    generator; the PoseAE generator's step takes pose maps, which the
    ``only_gan`` batches do not carry) per batch, on ``device`` (default:
    the card), or on the rank's card of ``mesh``: there each iteration runs
    on the rank's rows of the batch (a sharded ``only_gan`` loader) with G's
    and D's BatchNorms over the whole batch, D's and G's gradients averaged
    over the ranks before their Adam steps, the WGAN-GP mixing weights
    drawn for the whole batch on every rank and sliced, and the losses the
    ranks' means (``AEModel.step``)."""

    def __init__(self, gan, print_freq=100, device=None, mesh=None):
        self.gan = gan
        self.print_freq = print_freq
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        gan.net_G = convert_global_bn(gan.net_G, mesh)
        gan.net_D = convert_global_bn(gan.net_D, mesh)
        gan.to(self.device)
        self._gen = torch.Generator(device=self.device)

    def gp_draws(self, n, dtype):
        """The WGAN-GP mixing weights (n, 1, 1, 1) of a whole batch of ``n``
        from the iteration's generator, as the one-card step draws them."""
        return torch.rand((n, 1, 1, 1), generator=self._gen, device=self.device,
                          dtype=dtype)

    def train_gan(self, gan_state, epoch, gan_loader, train_iters=400, base_seed=0):
        """``train_iters`` iterations on the uint8 ``Xs`` batches of
        ``gan_loader`` (an ``only_gan`` loader; under a mesh, sharded).
        Iteration i seeds its draws (the WGAN-GP interpolation) from
        ``base_seed + epoch · train_iters + i``. Under a mesh G and D are
        rank 0's first. The losses stay on the card and are fetched once per
        ``print_freq``. Returns (state, the epoch's mean of each loss)."""
        for net in (self.gan.net_G, self.gan.net_D):
            replicate(self.mesh, net)
        meters, errs_buf = {}, []
        for i in range(train_iters):
            batch = gan_loader.next()
            xs = torch.from_numpy(np.ascontiguousarray(batch["Xs"])).to(self.device)
            self._gen.manual_seed(base_seed + epoch * train_iters + i)
            alpha = None
            if self.mesh is not None and self.gan.gan_mode == "wgangp":
                alpha = shard_batch(self.mesh, self.gp_draws(
                    xs.shape[0] * self.mesh.world_size,
                    next(self.gan.net_G.parameters()).dtype))
            gan_state, errs, _ = self.gan.optimize_parameters(
                gan_state, xs, self._gen, mesh=self.mesh, alpha=alpha)
            errs_buf.append(errs)
            if (i + 1) % self.print_freq == 0:
                _drain(errs_buf, meters)
                errs_buf = []
                msg = "  ".join(f"{k}: {m.avg:.3f}" for k, m in meters.items())
                print(f"GAN Epoch: [{epoch}][{i + 1}/{train_iters}]  {msg}")
        _drain(errs_buf, meters)
        return gan_state, {k: m.avg for k, m in meters.items()}
