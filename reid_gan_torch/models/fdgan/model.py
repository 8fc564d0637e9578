"""FDGANModel, the four-net adversarial engine of FD-GAN's stages II and III
(port of ``reid_gan_tpu/models/fdgan/model.py``; parity: FD/fdgan/
model.py).

- Nets (model.py:39-49): ``net_E``, the Siamese encoder + verifier (2
  classes); ``net_G``, ``CustomPoseGenerator``; ``net_Di``, a Siamese
  identity discriminator (1 logit); ``net_Dp``, the pose PatchGAN over
  (posemap ⊕ image).
- Stages (model.py:72-85): stage 1 (paper stage II) runs E in eval mode
  under no gradient and Di with fixed BatchNorm; stage 2 (paper stage III)
  runs E and Di with fixed BatchNorm but trains them. G and Dp run in train
  mode; Dp's running stats fold on each of its three forwards a step.
- The step in JAX's order (model.py:216-229): the Di step and the Dp step
  on the detached fake, then the G step against the updated Di and Dp. One
  G forward serves all three: JAX runs G twice with the same parameters,
  dropout key and batch statistics and keeps the second run's running
  stats, which equal the first's.
- Losses (model.py:159-214): the smoothed BCE with a 1/10001 label flip per
  discriminator for D; G = GAN_Di + GAN_Dp + λ_recon·L1 + λ_veri·CE +
  λ_sp·same-pose L1.
- Optimisers (model.py:100-117): Adam(0.5, 0.999) for G (and E in stage 2,
  one optimiser), SGD momentum 0.9 with coupled decay 1e-4 for Di and Dp;
  stage-1 lrs × (0.1, 0.01, 1), stage 2 × (0.1, 1, 1); the linear decay
  ``lambda_rule`` stepped per epoch.

Inputs come through kernels K14 (``fd_augment``: the origins with erasing,
the targets without) and K13 (``render_pose_peaks``), one launch each a
step. Every draw of a step is one ``FDDraws``, drawn from a
``torch.Generator`` (``sample_draws``) or given, as the parity tests give
JAX's. Memory: E's and Di's bases run with fixed BatchNorm, so a batch
splits into chunks without changing the result; where they need a gradient
they run chunk by chunk under activation checkpointing (``CHUNK`` images
at a time), so their activations are never held for the whole batch; each D
loss is two halves, backward in turn; Di and Dp take no gradient in the G
step, nor E in stage 1.

Under a data mesh (one rank a card; JAX model.py:75-77,134-137,435-438) the
four nets are replicated from rank 0 and each rank takes its contiguous
slice of both pair batches. E and Di run with fixed BatchNorm and need no
collective; G's and Dp's BatchNorms become global (``ops/norm.py``), Dp's
folding its running stats on each of its three forwards. The draws are the
whole batch's on every rank, from the same generator in lockstep (so the
scalars and the host's label-flip decision agree), and each rank takes its
rows: those of the (2B, ·) draws, the two halves' in ``[b1; b2]`` order,
come from global rows [r·s, (r+1)·s) and [B + r·s, B + (r+1)·s), as the
rank's ``origin`` is its rows of ``b1`` then of ``b2``. The gradients of
each optimiser are averaged over the ranks before its step. The same-pose
loss is a ratio of global sums (its denominator is all-reduced), and the
returned losses are the rank's (``global_errors`` reduces them).
"""

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...ops.norm import convert_global_bn
from ...ops.pose import render_pose_peaks
from ...ops.transforms import FD_FLIP, FD_PARAMS, fd_augment, sample_fd_augment_params
from ...parallel.mesh import (
    all_reduce_grads,
    all_reduce_mean,
    all_reduce_sum,
    mesh_device,
    replicate,
    shard_batch,
)
from ..multi_branch import siamese_net
from .losses import gan_loss_bce
from .networks import CustomPoseGenerator, NLayerDiscriminator

FLIP_P = 1.0 / 10001.0      # the D label flip (model.py:160,177 random.choice)
CHUNK = 128                 # images of a fixed-BatchNorm base per checkpointed chunk


class FDDraws(NamedTuple):
    """Every random number of one step. ``origin``: (2B, 9) K14 draws of the
    origins (erase with fill, flip); ``sigma``: (2B,) float32 and ``erase``:
    (2B,) int32, the pose maps' σ and erased channel of each side before the
    pose sharing; ``noise``: (B, noise_size); ``u_flip``: (2,) uniforms of
    the Di and Dp label flips; ``u_smooth``: (4,) smoothing uniforms, Di
    real and fake, Dp real and fake; ``masks``: G's five dropout keep masks
    over the 2B fakes, None when G does not drop."""
    origin: torch.Tensor
    sigma: torch.Tensor
    erase: torch.Tensor
    noise: torch.Tensor
    u_flip: torch.Tensor
    u_smooth: torch.Tensor
    masks: Optional[list] = None


def lambda_rule(epoch, niter, niter_decay):
    """LambdaLR multiplier, linear decay to 0 (FD/fdgan/networks.py:37-42)."""
    return 1.0 - max(0, epoch + 2 - niter) / float(niter_decay + 1)


def _run_base(base, x, grad):
    """An eval-mode base over ``x``: in ``CHUNK``-image pieces under
    activation checkpointing when a gradient is needed, else one no-grad
    forward."""
    if not grad:
        with torch.no_grad():
            return base(x)
    return torch.cat([checkpoint(base, c, use_reentrant=False) for c in x.split(CHUNK)])


class FDGANModel:
    """The engine on ``device`` (default: the card). ``cfg``: an
    ``FDGANConfig``. ``depth``: the Siamese ResNets' (50, or 18 for
    ``--debug``). ``seed`` seeds ``generator``, the draws' stream."""

    def __init__(self, cfg, height=256, width=128, depth=50, device=None, seed=0,
                 mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        self.height, self.width = height, width
        self.stage = cfg.stage
        self.smooth = cfg.smooth_label
        self.noise_size = cfg.noise_size
        feat_dim = 2048 if depth >= 50 else 512
        dev = self.device
        cl = torch.channels_last
        self.net_E = siamese_net(depth, num_classes=2).to(dev, memory_format=cl)
        self.net_Di = siamese_net(depth, num_classes=1).to(dev, memory_format=cl)
        self.net_G = CustomPoseGenerator(
            pose_feature_nc=cfg.pose_feature_size, reid_feature_nc=feat_dim,
            noise_nc=cfg.noise_size, dropout=cfg.drop, fuse_mode=cfg.fuse_mode,
            connect_layers=cfg.connect_layers, height=height, width=width).to(dev)
        self.net_Dp = NLayerDiscriminator(input_nc=3 + 18).to(dev)
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        lr = cfg.lr
        self._base_lrs = (lr * 0.1, lr * 0.01, lr) if self.stage == 1 else \
            (lr * 0.1, lr, lr)
        self._bootstrap()
        convert_global_bn(self.net_G, mesh)
        convert_global_bn(self.net_Dp, mesh)
        for net in self.nets().values():
            replicate(mesh, net)
        g_params = list(self.net_G.parameters())
        if self.stage == 2:
            g_params += list(self.net_E.parameters())
        g_lr, di_lr, dp_lr = self._base_lrs
        self.opt_G = torch.optim.Adam(g_params, lr=g_lr, betas=(0.5, 0.999), eps=1e-8)
        self.opt_Di = torch.optim.SGD(self.net_Di.parameters(), lr=di_lr, momentum=0.9,
                                      weight_decay=1e-4)
        self.opt_Dp = torch.optim.SGD(self.net_Dp.parameters(), lr=dp_lr, momentum=0.9,
                                      weight_decay=1e-4)
        # a list turns on the step's phase marks: (phase, CUDA event) at the
        # end of each phase, for a caller that splits the step's device time
        self.marks = None

    def _mark(self, phase):
        if self.marks is not None:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append((phase, event))

    def nets(self):
        return {"E": self.net_E, "G": self.net_G, "Di": self.net_Di, "Dp": self.net_Dp}

    # ------------------------------------------------------------- set-up
    def _bootstrap(self):
        """The ``net*_pretrain`` paths that chain the three stages
        (model.py:89-132): stage 1 loads the stage-I checkpoint (a
        ``cli/fdgan_baseline`` ``checkpoint.pth.tar``, or the JAX CLI's
        ``.msgpack`` of the Siamese variables) into E and Di from it
        (``_di_from_e``); stage 2 loads each net from its stage-1 file
        (``<which>_net_{E,G,Di,Dp}.pth``, or the JAX CLI's ``.msgpack``),
        strictly."""
        from ...utils.serialization import load_weights

        cfg = self.cfg
        if self.stage == 1:
            if cfg.netE_pretrain:
                load_weights(self.net_E, cfg.netE_pretrain)
                self.net_Di.load_state_dict(self._di_from_e(self.net_E.state_dict()))
        elif self.stage == 2:
            for net, path in ((self.net_E, cfg.netE_pretrain), (self.net_G, cfg.netG_pretrain),
                              (self.net_Di, cfg.netDi_pretrain),
                              (self.net_Dp, cfg.netDp_pretrain)):
                if path:
                    load_weights(net, path)

    @staticmethod
    def _di_from_e(sd):
        """Di's state_dict from E's: the verifier's positive row of the
        classifier (``weight[1:2]``, ``bias[1:2]``), all else copied
        (model.py:135-147; FD/fdgan/model.py:56-58)."""
        out = dict(sd)
        for k in ("embed_model.classifier.weight", "embed_model.classifier.bias"):
            out[k] = sd[k][1:2].clone()
        return out

    def set_epoch_lr(self, epoch):
        """The per-epoch linear decay of every optimiser (model.py:149-162)."""
        mult = lambda_rule(epoch, self.cfg.niter, self.cfg.niter_decay)
        for opt, base in zip((self.opt_G, self.opt_Di, self.opt_Dp), self._base_lrs):
            for g in opt.param_groups:
                g["lr"] = base * mult

    # ------------------------------------------------------------- draws
    def sample_draws(self, b):
        """One step's draws for B pairs from ``generator``, over JAX's ranges
        (model.py:210-265,293-306), and G's dropout masks last when G
        drops."""
        gen, dev, h, w = self.generator, self.device, self.height, self.width
        origin = sample_fd_augment_params(2 * b, h, w, gen)
        pose_aug = self.cfg.pose_aug
        sigma = torch.full((2 * b,), 5.0, device=dev)
        erase = torch.full((2 * b,), -1, dtype=torch.int32, device=dev)
        if pose_aug == "gauss":
            sigma = torch.randint(4, 7, (2 * b,), generator=gen, device=dev).float()
        elif pose_aug == "erase":
            erase = torch.randint(0, 18, (2 * b,), generator=gen, device=dev,
                                  dtype=torch.int32)
        noise = torch.randn((b, self.noise_size), generator=gen, device=dev)
        u_flip = torch.rand(2, generator=gen, device=dev)
        u_smooth = torch.rand(4, generator=gen, device=dev)
        masks = self.net_G.draw_masks(2 * b, gen) if self.net_G.dropout > 0.0 else None
        return FDDraws(origin, sigma, erase, noise, u_flip, u_smooth, masks)

    def local_draws(self, draws):
        """The rank's rows of the whole batch's ``draws`` (the module's
        docstring); ``draws`` itself without a mesh."""
        mesh = self.mesh
        if mesh is None:
            return draws
        masks = draws.masks

        def halves(t):
            return torch.cat([shard_batch(mesh, h) for h in t.chunk(2)])

        return draws._replace(
            origin=halves(draws.origin), sigma=halves(draws.sigma),
            erase=halves(draws.erase), noise=shard_batch(mesh, draws.noise),
            masks=None if masks is None else [halves(m) for m in masks])

    def global_errors(self, errors):
        """A step's losses (a dict of device scalars, or of stacked steps)
        as the whole batch's: each the mean over the ranks, in one
        reduction; ``errors`` itself without a mesh."""
        if self.mesh is None:
            return errors
        return dict(zip(errors, all_reduce_mean(self.mesh, torch.stack(
            [v.double() for v in errors.values()]))))

    # --------------------------------------------------------- preprocess
    def preprocess(self, batch1, batch2, draws):
        """The step's inputs on the card (model.py:198-265): the origins
        through K14 with erasing; the targets through K14 without, flipped
        with the pose maps; the pose maps through K13. The pose sharing of
        positive pairs (the second side takes the first side's target,
        landmarks, σ, erased channel and flip) selects per pair before the
        two kernels, which is exact: JAX's ``pm1·1 + pm2·0`` is ``pm1``.
        Returns (origin, target, posemap, labels, noise), the images
        (2B, 3, H, W) in the parameters' dtype."""
        dev = self.device
        dtype = next(self.net_G.parameters()).dtype

        def t(a, dt=None):
            return torch.as_tensor(a).to(dev, dt)

        labels = t(batch1["pid"] == batch2["pid"])
        b = labels.shape[0]
        same = labels[:, None, None, None]
        img = torch.cat([t(batch1["img"]), t(batch2["img"])]).contiguous()
        origin = fd_augment(img, draws.origin)
        t1, t2 = t(batch1["target"]), t(batch2["target"])
        tgt = torch.cat([t1, torch.where(same, t1, t2)]).contiguous()
        f1, f2 = t(batch1["flip"], torch.int32), t(batch2["flip"], torch.int32)
        flip = torch.cat([f1, torch.where(labels, f1, f2)])
        # the target is float32 in JAX under x64 too (normalize of to_float)
        t_params = torch.zeros((2 * b, FD_PARAMS), dtype=torch.float32, device=dev)
        t_params[:, FD_FLIP] = flip.to(t_params.dtype)
        target = fd_augment(tgt, t_params)

        def share(a):
            return torch.cat([a[:b], torch.where(labels.view(-1, *[1] * (a.dim() - 1)),
                                                 a[:b], a[b:])])

        l1, l2 = t(batch1["landmark"], torch.float32), t(batch2["landmark"], torch.float32)
        lm = torch.cat([l1, torch.where(labels[:, None, None], l1, l2)]).contiguous()
        posemap = render_pose_peaks(lm, share(draws.sigma.float()).contiguous(),
                                    share(draws.erase.to(torch.int32)).contiguous(),
                                    flip.contiguous(), self.height, self.width)
        noise = torch.cat([draws.noise, draws.noise]).to(dtype)
        return (origin.to(dtype), target.to(dtype), posemap.to(dtype),
                labels.to(torch.int64), noise)

    # ------------------------------------------------------------- the step
    def _d_halves(self, pred_real_fn, pred_fake_fn, u_flip, u_real, u_fake):
        """A D loss in JAX's form, ``where(flip, lr_sw + lf_sw, lr_ + lf_) ·
        0.5``, as two halves, each backward as soon as it is formed."""
        flip = bool(self.smooth) and float(u_flip) < FLIP_P
        pred = pred_real_fn()
        half_r = 0.5 * gan_loss_bce(pred, not flip, self.smooth,
                                    u_fake if flip else u_real)
        half_r.backward()
        pred = pred_fake_fn()
        half_f = 0.5 * gan_loss_bce(pred, flip, self.smooth,
                                    u_real if flip else u_fake)
        half_f.backward()
        return (half_r + half_f).detach()

    def optimize_step(self, batch1, batch2, draws=None):
        """One Di → Dp → G iteration on host pair batches (``fdgan_pose``
        mode). Returns (errors, a dict of device scalars; the fake (2B, 3,
        H, W), detached). Under a mesh the batches are the rank's rows,
        ``draws`` the whole batch's, and the errors and the fake the
        rank's."""
        cfg = self.cfg
        mesh = self.mesh
        self._mark("start")
        if draws is None:
            draws = self.sample_draws(len(batch1["pid"]) * (mesh.world_size if mesh else 1))
        draws = self.local_draws(draws)
        origin, target, posemap, labels, noise = self.preprocess(batch1, batch2, draws)
        self._mark("inputs (K14, K13)")
        b = labels.shape[0]
        u_flip, u_sm = draws.u_flip, draws.u_smooth
        E, G, Di, Dp = self.net_E, self.net_G, self.net_Di, self.net_Dp
        E.eval()
        Di.eval()
        G.train()
        Dp.train()
        stage2 = self.stage == 2

        # E features and verification logits, then the fake (model.py:149-157)
        e_base = E.base_model
        f1 = _run_base(e_base, origin[:b], stage2)
        f2 = _run_base(e_base, origin[b:], stage2)
        with torch.set_grad_enabled(stage2):
            id_score = E.embed_model(f1, f2)
        fake = G(posemap, torch.cat([f1, f2]), noise, masks=draws.masks)
        fake_d = fake.detach()
        self._mark("E and G forward")

        # Di step (model.py:175-186) on the detached fake; each half runs the
        # origin branch again, as JAX applies Di twice
        self.opt_Di.zero_grad(set_to_none=True)

        def di_logits(x):
            return Di.embed_model(_run_base(Di.base_model, origin, True),
                                  _run_base(Di.base_model, x, True))

        loss_Di = self._d_halves(lambda: di_logits(target), lambda: di_logits(fake_d),
                                 u_flip[0], u_sm[0], u_sm[1])
        all_reduce_grads(mesh, Di.parameters())
        self.opt_Di.step()
        self._mark("Di step")

        # Dp step (model.py:159-173), posemap channels first
        self.opt_Dp.zero_grad(set_to_none=True)
        loss_Dp = self._d_halves(lambda: Dp(torch.cat([posemap, target], 1)),
                                 lambda: Dp(torch.cat([posemap, fake_d], 1)),
                                 u_flip[1], u_sm[2], u_sm[3])
        all_reduce_grads(mesh, Dp.parameters())
        self.opt_Dp.step()
        self._mark("Dp step")

        # G step against the updated discriminators (model.py:188-214)
        frozen = [p for p in list(Di.parameters()) + list(Dp.parameters())
                  if p.requires_grad]
        for p in frozen:
            p.requires_grad_(False)
        try:
            o_feat_di = _run_base(Di.base_model, origin, False)
            loss_v = F.cross_entropy(id_score, labels)
            loss_r = torch.abs(fake - target).mean()
            mask_f = labels.to(fake.dtype)[:, None, None, None]
            num = torch.sum(torch.abs(fake[:b] - fake[b:]) * mask_f)
            # a ratio of sums over the whole batch: the denominator counts
            # every rank's positive pairs, and the rank's numerator is scaled
            # by the mesh size, so that the ranks' mean (of the loss, and of
            # its gradient after all_reduce_grads) is Σ_r num_r / den
            den = torch.clamp_min(all_reduce_sum(mesh, torch.sum(mask_f)) * fake[0].numel(),
                                  1.0)
            loss_sp = num * (mesh.world_size if mesh else 1) / den
            pred_fake_di = Di.embed_model(o_feat_di, _run_base(Di.base_model, fake, True))
            pred_fake_dp = Dp(torch.cat([posemap, fake], 1))
            loss_gan_di = gan_loss_bce(pred_fake_di, True)
            loss_gan_dp = gan_loss_bce(pred_fake_dp, True)
            loss_G = (loss_gan_di + loss_gan_dp + loss_r * cfg.lambda_recon +
                      loss_v * cfg.lambda_veri + loss_sp * cfg.lambda_sp)
            self.opt_G.zero_grad(set_to_none=True)
            loss_G.backward()
            all_reduce_grads(mesh, [p for g in self.opt_G.param_groups for p in g["params"]])
            self.opt_G.step()
            self._mark("G step")
        finally:
            for p in frozen:
                p.requires_grad_(True)
        errors = {"G": loss_G.detach(), "D_i": loss_Di, "D_p": loss_Dp,
                  "G_v": loss_v.detach(), "G_r": loss_r.detach(),
                  "G_sp": loss_sp.detach(), "G_gan_Di": loss_gan_di.detach(),
                  "G_gan_Dp": loss_gan_dp.detach()}
        return errors, fake_d
