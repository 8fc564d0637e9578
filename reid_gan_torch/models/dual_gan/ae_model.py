"""AEModel, the dual_gan engine of the joint loop and the GAN warm-up, for
the pose and the AE generators (port of
``reid_gan_tpu/models/dual_gan/ae_model.py``; parity:
CC/dual_gan/models/AE_model.py).

The nets are ``torch.nn.Module``s held by the engine and trained in place;
``AEState`` carries their optimizers: Adam with β1 0.5 at ``gan_lr`` for G
and ``gan_lr · ratio_g2d`` for D (AE_model.py:131-158). The losses follow the
JAX functions:

- ``d_loss``: real, then the detached fake, through D in train mode (each
  forward advances D's spectral ``u``/``sigma``), lsgan/vanilla/hinge/wgangp
  halves averaged, plus the gradient penalty for wgangp;
- ``get_loss_G_train``: the G loss against D as it stands, in train mode
  so its power iteration persists, with D's parameters frozen so the loss's
  gradient reaches the fake only (the pre-update D in the joint step, the
  updated D in the standalone step).

``hard_mix`` and ``synthesize_fc`` make the AE hard-mix mode's negatives;
``optimize_parameters`` is the standalone D→G step of the GAN warm-up.
Not ported yet (ROADMAP A: GAN-feature clustering): ``synthesize_mix_p``; ``use_vgg`` raises.
"""

from typing import Any, NamedTuple

import torch

from ...ops.cluster_memory import _l2n
from ...ops.transforms import gan_input_transform
from .external_function import cal_gradient_penalty, gan_loss
from .networks import define_D, define_G


# The recipe's feature mix (ae_model.py:63-85; AE_model.py:274-292):
# λ·f_s[in] + (1 − λ)·f_s[out].
LAMBDA_FUS = 0.8


class AEState(NamedTuple):
    G: torch.nn.Module
    D: torch.nn.Module
    opt_G: torch.optim.Optimizer
    opt_D: torch.optim.Optimizer
    step: Any


def hard_mix(f_s, reid_f, group_size):
    """Per-group hard feature mixing (ae_model.py:42-57; AE_model.py:274-292).
    The anchor of each group of ``group_size`` consecutive samples is the
    L2-normalised mean of its re-ID features ``reid_f`` (N, C); by
    ``exp(anchor · instance)`` it picks the group's farthest member and the
    nearest sample outside the group (the first on a tie) and mixes their
    generator features ``f_s`` (N, ...): ``λ·f_s[in] + (1 − λ)·f_s[out]``
    with λ = ``LAMBDA_FUS``, one row per group."""
    n, fdim = reid_f.shape
    num_groups = n // group_size
    anchor = _l2n(reid_f.reshape(num_groups, group_size, fdim).mean(dim=1))
    sim = torch.exp(anchor @ _l2n(reid_f).T)
    row = torch.arange(num_groups, device=sim.device)[:, None]
    col = torch.arange(n, device=sim.device)[None]
    id_mask = (col // group_size == row).to(sim.dtype)
    in_id = torch.argmin(id_mask * sim + (1 - id_mask) * sim.max(), dim=1)
    out_id = torch.argmax((1 - id_mask) * sim, dim=1)
    return LAMBDA_FUS * f_s[in_id] + (1 - LAMBDA_FUS) * f_s[out_id]


class AEModel:
    """The engine: ``net_G`` (the pose or the AE generator, ``cfg.model_gen``)
    and ``net_D`` (the spectral-norm discriminator) on ``device``, with the
    loss functions of the joint step and the standalone GAN step."""

    def __init__(self, cfg, gan_height=128, gan_width=64, num_feats=256, ngf=64,
                 reid_feat_dim=2048, device=None):
        if cfg.use_vgg:
            raise NotImplementedError("use_vgg: the VGG19 perceptual loss is not "
                                      "ported yet (ROADMAP A: other generators and DPTN)")
        self.cfg = cfg
        self.h, self.w = gan_height, gan_width
        self.reid_feat_dim = reid_feat_dim
        self.model_gen = cfg.model_gen
        self.gan_mode = cfg.gan_mode
        # the engine's nets (AE_model.py:66-101): G with batch norm and no
        # spectral norm, 3 layers; D with spectral norm, ndf 32, img_f 128
        self.net_G = define_G(cfg.model_gen, pose_nc=cfg.pose_channels, ngf=ngf,
                              img_f=num_feats, reid_nc=reid_feat_dim).to(device)
        self.net_D = define_D(input_nc=3, ndf=32, img_f=128, layers=3).to(device)

    def init_state(self):
        """Fresh Adam states for G and D (AE_model.py:131-158)."""
        opt_G = torch.optim.Adam(self.net_G.parameters(), lr=self.cfg.gan_lr,
                                 betas=(0.5, 0.999), eps=1e-8)
        opt_D = torch.optim.Adam(self.net_D.parameters(),
                                 lr=self.cfg.gan_lr * self.cfg.ratio_g2d,
                                 betas=(0.5, 0.999), eps=1e-8)
        return AEState(self.net_G, self.net_D, opt_G, opt_D, 0)

    def set_epoch_lr(self, state, mult):
        """The per-epoch learning rates: ``gan_lr · mult`` for G and
        ``gan_lr · ratio_g2d · mult`` for D (ae_model.py:129-141)."""
        for g in state.opt_G.param_groups:
            g["lr"] = self.cfg.gan_lr * mult
        for g in state.opt_D.param_groups:
            g["lr"] = self.cfg.gan_lr * self.cfg.ratio_g2d * mult
        return state

    # ------------------------------------------------------------ forwards
    def apply_G(self, *args, train=False, method="forward"):
        self.net_G.train(train)
        return getattr(self.net_G, method)(*args)

    def apply_D(self, x, train=False):
        self.net_D.train(train)
        return self.net_D(x)

    def synthesize_p(self, features, source_pose, train=False):
        """Features + pose maps → image (AE_model.py:212-214)."""
        return self.apply_G(features, source_pose, train=train)

    def synthesize_fc(self, source_image, reid_f, group_size=16, train=False):
        """AE generator: encode the GAN images, ``hard_mix`` the features per
        group by the re-ID features, decode one image per group
        (ae_model.py:168-192). In train mode G's BatchNorm folds its running
        stats at the encoder's and again at the decoder's forward."""
        f_s = self.apply_G(source_image, train=train, method="forward_enc")
        mixed = hard_mix(f_s.reshape(f_s.shape[0], -1), reid_f,
                         group_size).reshape((-1,) + f_s.shape[1:])
        return self.apply_G(mixed, train=train, method="forward_dec")

    # -------------------------------------------------------------- losses
    def d_loss(self, real, fake, generator=None):
        """backward_D_basic (AE_model.py:294-308): real, then the detached
        fake, in train mode, plus the WGAN-GP penalty for ``wgangp``, taken
        in eval mode from the stats D had before this call."""
        fake = fake.detach()
        gp = 0.0
        if self.gan_mode == "wgangp":
            gp, _ = cal_gradient_penalty(lambda x: self.apply_D(x, train=False),
                                         real, fake, generator=generator)
        pred_real = self.apply_D(real, train=True)
        pred_fake = self.apply_D(fake, train=True)
        loss = (gan_loss(pred_real, True, True, self.gan_mode) +
                gan_loss(pred_fake, False, True, self.gan_mode)) * 0.5
        return loss + gp

    def g_loss_basic(self, fake, target, use_d=True):
        """backward_G_basic (AE_model.py:316-337): per-element L1 · λ_rec and
        GAN · λ_g against D in eval mode."""
        cfg = self.cfg
        loss_app = torch.abs(fake - target) * cfg.lambda_rec
        loss_ad = None
        if use_d:
            loss_ad = gan_loss(self.apply_D(fake, train=False), True, False,
                               self.gan_mode) * cfg.lambda_g
        return loss_app, loss_ad

    def get_loss_G_train(self, fake, target):
        """The joint step's G loss (ae_model.py:262-284): D frozen and in
        train mode, so its power iteration persists into the D step; the
        per-sample L1 mean plus the per-sample GAN mean (lsgan), averaged."""
        cfg = self.cfg
        frozen = [p for p in self.net_D.parameters() if p.requires_grad]
        for p in frozen:
            p.requires_grad_(False)
        try:
            pred_fake = self.apply_D(fake, train=True)
        finally:
            for p in frozen:
                p.requires_grad_(True)
        loss_ad = gan_loss(pred_fake, True, False, self.gan_mode) * cfg.lambda_g
        loss_app = torch.abs(fake - target) * cfg.lambda_rec
        per_sample = loss_app.reshape(loss_app.shape[0], -1).mean(dim=-1)
        if loss_ad.dim() > 0:
            per_sample = per_sample + loss_ad.reshape(loss_ad.shape[0], -1).mean(dim=-1)
            return per_sample.mean()
        return per_sample.mean() + loss_ad

    def step(self, state, source, generator=None):
        """The standalone D→G step (ae_model.py:298-359) on a GAN batch
        ``source`` (N, 3, H, W) at the nets' dtype: G's one train-mode
        forward (its running stats fold once, as the JAX step keeps only the
        second of its two identical forwards), the D step on the detached
        fake (real, then fake, each advancing D's ``u``) and D's Adam, then
        the G loss against the updated D in train mode (its power iteration
        persists) and G's Adam. ``generator`` seeds the WGAN-GP draws.
        Returns (state, {"G", "D"} losses on the device, the fake)."""
        if self.model_gen != "AE":
            raise ValueError(f"the standalone GAN step drives the AE generator; "
                             f"{self.model_gen!r} is driven by the joint trainer")
        fake = self.apply_G(source, train=True)
        state.opt_D.zero_grad(set_to_none=True)
        loss_D = self.d_loss(source, fake, generator)
        loss_D.backward()
        state.opt_D.step()
        state.opt_G.zero_grad(set_to_none=True)
        loss_G = self.get_loss_G_train(fake, source)
        loss_G.backward()
        state.opt_G.step()
        return state._replace(step=state.step + 1), \
            {"G": loss_G.detach(), "D": loss_D.detach()}, fake.detach()

    def optimize_parameters(self, state, xs_u8, generator=None):
        """One D→G iteration on a device uint8 (N, H, W, 3) GAN batch staged
        at the GAN size (AE_model.py:392-401): the GAN input transform (K9 on
        the card), then ``step``."""
        dtype = next(self.net_G.parameters()).dtype
        source = gan_input_transform(xs_u8, self.h, self.w).to(dtype)
        return self.step(state, source, generator)

    def get_L1_loss(self, fake, target, with_dis=False):
        """Per-sample reconstruction loss (AE_model.py:378-390)."""
        if with_dis:
            loss_app, loss_ad = self.g_loss_basic(fake, target, True)
            return loss_app.reshape(loss_app.shape[0], -1).mean(-1) + \
                loss_ad.reshape(loss_ad.shape[0], -1).mean(-1)
        loss_app = torch.abs(fake - target) * self.cfg.lambda_rec
        return loss_app.reshape(loss_app.shape[0], -1).mean(-1)
