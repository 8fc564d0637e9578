"""AEModel, the dual_gan engine of the joint loop, for the pose generator
(port of ``reid_gan_tpu/models/dual_gan/ae_model.py:60-295``; parity:
CC/dual_gan/models/AE_model.py).

The nets are ``torch.nn.Module``s held by the engine and trained in place;
``AEState`` carries their optimizers: Adam with β1 0.5 at ``gan_lr`` for G
and ``gan_lr · ratio_g2d`` for D (AE_model.py:131-158). The losses follow the
JAX functions:

- ``d_loss``: real, then the detached fake, through D in train mode (each
  forward advances D's spectral ``u``/``sigma``), lsgan/vanilla/hinge/wgangp
  halves averaged, plus the gradient penalty for wgangp;
- ``get_loss_G_train``: the G loss of the joint step against D as it stands
  (the pre-update D), in train mode so its power iteration persists, with
  D's parameters frozen so the loss's gradient reaches the fake only.

Not ported yet (ROADMAP A6): ``hard_mix``, ``synthesize_fc``,
``synthesize_mix_p`` and the standalone GAN step; ``use_vgg`` raises.
"""

from typing import Any, NamedTuple

import torch

from .external_function import cal_gradient_penalty, gan_loss
from .networks import define_D, define_G


class AEState(NamedTuple):
    G: torch.nn.Module
    D: torch.nn.Module
    opt_G: torch.optim.Optimizer
    opt_D: torch.optim.Optimizer
    step: Any


class AEModel:
    """The engine: ``net_G`` (the pose generator) and ``net_D`` (the
    spectral-norm discriminator) on ``device``, with the loss functions of
    the joint step."""

    def __init__(self, cfg, gan_height=128, gan_width=64, num_feats=256, ngf=64,
                 reid_feat_dim=2048, device=None):
        if cfg.use_vgg:
            raise NotImplementedError("use_vgg: the VGG19 perceptual loss is not "
                                      "ported yet (ROADMAP A5)")
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
    def apply_G(self, *args, train=False):
        self.net_G.train(train)
        return self.net_G(*args)

    def apply_D(self, x, train=False):
        self.net_D.train(train)
        return self.net_D(x)

    def synthesize_p(self, features, source_pose, train=False):
        """Features + pose maps → image (AE_model.py:212-214)."""
        return self.apply_G(features, source_pose, train=train)

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

    def get_L1_loss(self, fake, target, with_dis=False):
        """Per-sample reconstruction loss (AE_model.py:378-390)."""
        if with_dis:
            loss_app, loss_ad = self.g_loss_basic(fake, target, True)
            return loss_app.reshape(loss_app.shape[0], -1).mean(-1) + \
                loss_ad.reshape(loss_ad.shape[0], -1).mean(-1)
        loss_app = torch.abs(fake - target) * self.cfg.lambda_rec
        return loss_app.reshape(loss_app.shape[0], -1).mean(-1)
