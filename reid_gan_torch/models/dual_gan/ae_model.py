"""AEModel, the dual_gan engine of the joint loop and the GAN warm-up (port
of ``reid_gan_tpu/models/dual_gan/ae_model.py``; parity:
CC/dual_gan/models/AE_model.py), and ``GANEngine``, what it shares with the
DPTN engine (``dptn_model.py``).

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
  updated D in the standalone step), plus with ``use_vgg`` the VGG19
  perceptual terms ``style · λ_style + content · λ_content`` of the fake
  against the target.

The generator is any of ``define_G``'s: the joint ``train_all`` step
renders with the pose generator, the hard-mix ``train`` step and the
standalone step run the AE generator, the standalone step the PoseAE
generator too (with the pose maps); the DEC and FD generators are built and
never stepped, as in the JAX package. ``hard_mix`` and ``synthesize_fc``
make the AE hard-mix mode's negatives; ``synthesize_mix_p`` the pose
generator's; ``optimize_parameters`` is the standalone D→G step of the GAN
warm-up.
"""

import contextlib
from typing import Any, NamedTuple

import torch

from ...ops.cluster_memory import _l2n
from ...ops.norm import local_stats
from ...ops.transforms import gan_input_transform
from ...parallel.mesh import all_reduce_grads, all_reduce_means, assemble_rows
from ..precision import set_compute_dtype
from .external_function import VGGLoss, cal_gradient_penalty, gan_loss
from .networks import define_D, define_G


# The recipe's feature mix (ae_model.py:63-85; AE_model.py:274-292):
# λ·f_s[in] + (1 − λ)·f_s[out].
LAMBDA_FUS = 0.8


def _params(optimizer):
    return [q for group in optimizer.param_groups for q in group["params"]]


class AEState(NamedTuple):
    G: torch.nn.Module
    D: torch.nn.Module
    opt_G: torch.optim.Optimizer
    opt_D: torch.optim.Optimizer
    step: Any


def hard_mix(f_s, reid_f, group_size, mesh=None):
    """Per-group hard feature mixing (ae_model.py:42-57; AE_model.py:274-292).
    The anchor of each group of ``group_size`` consecutive samples is the
    L2-normalised mean of its re-ID features ``reid_f`` (N, C); by
    ``exp(anchor · instance)`` it picks the group's farthest member and the
    nearest sample outside the group (the first on a tie) and mixes their
    generator features ``f_s`` (N, ...): ``λ·f_s[in] + (1 − λ)·f_s[out]``
    with λ = ``LAMBDA_FUS``, one row per group. Under a data mesh ``f_s`` is
    the rank's rows and ``reid_f`` the whole batch's: the chosen rows come
    from the ranks that own them (``assemble_rows``), and every rank returns
    the same mix."""
    n, fdim = reid_f.shape
    num_groups = n // group_size
    anchor = _l2n(reid_f.reshape(num_groups, group_size, fdim).mean(dim=1))
    sim = torch.exp(anchor @ _l2n(reid_f).T)
    row = torch.arange(num_groups, device=sim.device)[:, None]
    col = torch.arange(n, device=sim.device)[None]
    id_mask = (col // group_size == row).to(sim.dtype)
    in_id = torch.argmin(id_mask * sim + (1 - id_mask) * sim.max(), dim=1)
    out_id = torch.argmax((1 - id_mask) * sim, dim=1)
    picked = assemble_rows(mesh, f_s, torch.cat([in_id, out_id]))
    return LAMBDA_FUS * picked[:num_groups] + (1 - LAMBDA_FUS) * picked[num_groups:]


@contextlib.contextmanager
def frozen(module):
    """``module``'s parameters with ``requires_grad`` off for the block: a
    loss through it reaches its inputs only."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


class GANEngine:
    """The nets of a dual_gan engine on ``device``: ``net_G`` (``MODEL_GEN``
    of ``define_G``, else ``cfg.model_gen``; batch norm and no spectral norm
    by default) and ``net_D`` (the spectral-norm discriminator, ndf 32,
    img_f 128), and with ``cfg.use_vgg`` the VGG19 perceptual loss ``vgg``
    (``vgg_params``: a ``VGG19`` state dict; without it random taps drawn
    from ``seed``, which leave torch's global generator as it was), else
    ``vgg`` None (ae_model.py:63-94; AE_model.py:66-101). The keywords are
    the JAX engines'. ``dtype`` (``torch.bfloat16`` under ``--fp16``) is G's
    and D's compute dtype (``precision.py``); VGG19 stays fp32."""

    MODEL_GEN = None

    def __init__(self, cfg, gan_height=128, gan_width=64, num_feats=256, ngf=64,
                 layers_g=3, num_blocks=3, dis_layers=3, use_spect_g=False,
                 use_spect_d=True, norm="batch", vgg_params=None, reid_feat_dim=2048,
                 seed=0, device=None, dtype=None):
        self.cfg = cfg
        self.h, self.w = gan_height, gan_width
        self.reid_feat_dim = reid_feat_dim
        self.model_gen = self.MODEL_GEN or cfg.model_gen
        self.gan_mode = cfg.gan_mode
        self.net_G = define_G(self.model_gen, pose_nc=cfg.pose_channels, ngf=ngf,
                              img_f=num_feats, encoder_layer=layers_g, norm=norm,
                              use_spect=use_spect_g, num_blocks=num_blocks,
                              reid_nc=reid_feat_dim)
        self.net_D = define_D(input_nc=3, ndf=32, img_f=128, layers=dis_layers,
                              use_spect=use_spect_d)
        for net in (self.net_G, self.net_D):
            set_compute_dtype(net, dtype)
        self.vgg = VGGLoss(vgg_params, seed) if cfg.use_vgg else None
        self.to(device)

    def to(self, device):
        """Move the nets (and the VGG19 taps) to ``device``."""
        for net in (self.net_G, self.net_D, self.vgg):
            if net is not None:
                net.to(device)
        return self

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

    def apply_G(self, *args, train=False, method="forward"):
        self.net_G.train(train)
        return getattr(self.net_G, method)(*args)

    def apply_D(self, x, train=False):
        self.net_D.train(train)
        return self.net_D(x)

    def d_loss(self, real, fake, generator=None, alpha=None):
        """backward_D_basic (AE_model.py:294-308): real, then the detached
        fake, in train mode, plus the WGAN-GP penalty for ``wgangp``, taken
        in eval mode from the stats D had before this call (``alpha``: its
        mixing weights, else drawn from ``generator``)."""
        fake = fake.detach()
        gp = 0.0
        if self.gan_mode == "wgangp":
            gp, _ = cal_gradient_penalty(lambda x: self.apply_D(x, train=False),
                                         real, fake, alpha=alpha, generator=generator)
        pred_real = self.apply_D(real, train=True)
        pred_fake = self.apply_D(fake, train=True)
        loss = (gan_loss(pred_real, True, True, self.gan_mode) +
                gan_loss(pred_fake, False, True, self.gan_mode)) * 0.5
        return loss + gp

    def vgg_terms(self, fake, target):
        """(style · λ_style, content · λ_content) of ``fake`` against
        ``target`` with the VGG19 loss, else (None, None)."""
        if self.vgg is None:
            return None, None
        content, style = self.vgg(fake, target)
        return style * self.cfg.lambda_style, content * self.cfg.lambda_content


class AEModel(GANEngine):
    """The AE engine: ``net_G`` is ``cfg.model_gen`` (the pose generator
    for the joint step, the AE generator for the hard-mix mode and the
    warm-up), with the loss functions of the joint step and the standalone
    GAN step (ae_model.py:60-368)."""

    # ------------------------------------------------------------ forwards
    def synthesize_p(self, features, source_pose, train=False):
        """Features + pose maps → image (AE_model.py:212-214)."""
        return self.apply_G(features, source_pose, train=train)

    def synthesize_fc(self, source_image, reid_f, group_size=16, train=False,
                      mesh=None):
        """AE generator: encode the GAN images, ``hard_mix`` the features per
        group by the re-ID features, decode one image per group
        (ae_model.py:168-192). In train mode G's BatchNorm folds its running
        stats at the encoder's and again at the decoder's forward.

        Under a data mesh ``source_image`` is the rank's rows and ``reid_f``
        the whole batch's (gathered): the encoder runs on the rank's rows
        with G's global BatchNorm, the 2·G mixed rows (G groups) come from
        the ranks that own them (``hard_mix``), so a group may straddle two
        ranks, and the decoder runs on all G mixed rows on every rank
        alike, its BatchNorms over those rows alone (``local_stats``), as
        JAX's decoder normalises the G rows of the sharded batch. Every rank
        returns the same G images."""
        f_s = self.apply_G(source_image, train=train, method="forward_enc")
        mixed = hard_mix(f_s, reid_f, group_size, mesh)
        with local_stats(self.net_G):
            return self.apply_G(mixed, train=train, method="forward_dec")

    def synthesize_mix_p(self, f_gan, f_gan_ex, source_pose, p_idx, train=False):
        """Pose generator's negatives (ae_model.py:194-205; AE_model.py:
        238-250): the batch's features and the extra ones ``f_gan_ex``
        rendered in one pass, the extra ones with the poses ``p_idx`` (the
        draws, (len(f_gan_ex),) indices into the batch, sampled by the
        caller). Returns (the batch's images, the extra ones detached)."""
        bs = f_gan.shape[0]
        syn = self.synthesize_p(torch.cat([f_gan, f_gan_ex]),
                                torch.cat([source_pose, source_pose[p_idx]]), train=train)
        return syn[:bs], syn[bs:].detach()

    # -------------------------------------------------------------- losses
    def get_loss_G_train(self, fake, target):
        """The joint step's G loss (ae_model.py:262-284): D frozen and in
        train mode, so its power iteration persists into the D step; the
        per-sample L1 mean plus the per-sample GAN mean (lsgan), averaged;
        plus the VGG terms with ``use_vgg``."""
        cfg = self.cfg
        with frozen(self.net_D):
            pred_fake = self.apply_D(fake, train=True)
        loss_ad = gan_loss(pred_fake, True, False, self.gan_mode) * cfg.lambda_g
        loss_app = torch.abs(fake - target) * cfg.lambda_rec
        per_sample = loss_app.reshape(loss_app.shape[0], -1).mean(dim=-1)
        if loss_ad.dim() > 0:
            per_sample = per_sample + loss_ad.reshape(loss_ad.shape[0], -1).mean(dim=-1)
            loss = per_sample.mean()
        else:
            loss = per_sample.mean() + loss_ad
        loss_style, loss_content = self.vgg_terms(fake, target)
        if loss_style is not None:
            loss = loss + loss_style + loss_content
        return loss

    def step(self, state, source, generator=None, pose=None, mesh=None, alpha=None):
        """The standalone D→G step (ae_model.py:298-359) on a GAN batch
        ``source`` (N, 3, H, W) at the nets' dtype, with the PoseAE
        generator on its pose maps ``pose`` (N, pose_nc, H, W): G's one
        train-mode forward (its running stats fold once, as the JAX step
        keeps only the second of its two identical forwards), the D step on
        the detached fake (real, then fake, each advancing D's ``u``) and
        D's Adam, then the G loss against the updated D in train mode (its
        power iteration persists) and G's Adam. ``generator`` seeds the
        WGAN-GP draws, or ``alpha`` gives them. Under a data mesh ``mesh``
        the batch is the rank's rows (G's and D's BatchNorms global), D's
        and G's gradients are averaged over the ranks before their Adam
        steps and the losses are the ranks' means. Returns (state, {"G",
        "D"} losses on the device, the fake)."""
        if self.model_gen == "AE":
            fake = self.apply_G(source, train=True)
        elif self.model_gen == "PoseAE":
            if pose is None:
                raise ValueError("the PoseAE generator's step needs the pose maps")
            fake = self.apply_G(source, pose, train=True)
        else:
            raise ValueError(f"optimize_parameters supports AE/PoseAE; "
                             f"{self.model_gen} is driven by the joint trainer")
        state.opt_D.zero_grad(set_to_none=True)
        loss_D = self.d_loss(source, fake, generator, alpha)
        loss_D.backward()
        all_reduce_grads(mesh, _params(state.opt_D))
        state.opt_D.step()
        state.opt_G.zero_grad(set_to_none=True)
        loss_G = self.get_loss_G_train(fake, source)
        loss_G.backward()
        all_reduce_grads(mesh, _params(state.opt_G))
        state.opt_G.step()
        errs = all_reduce_means(mesh, {"G": loss_G.detach(), "D": loss_D.detach()})
        return state._replace(step=state.step + 1), errs, fake.detach()

    def optimize_parameters(self, state, xs_u8, generator=None, pose=None, mesh=None,
                            alpha=None):
        """One D→G iteration on a device uint8 (N, H, W, 3) GAN batch staged
        at the GAN size (AE_model.py:392-401): the GAN input transform (K9 on
        the card), then ``step``; ``pose``: the PoseAE generator's pose maps
        (kernel K10's output); ``mesh``, ``alpha``: ``step``'s."""
        dtype = next(self.net_G.parameters()).dtype
        source = gan_input_transform(xs_u8, self.h, self.w).to(dtype)
        return self.step(state, source, generator,
                         None if pose is None else pose.to(dtype), mesh, alpha)

    def get_L1_loss(self, fake, target, with_dis=False):
        """Per-sample reconstruction loss, the mean L1 · λ_rec, plus with
        ``with_dis`` the mean GAN term · λ_g against D in eval mode
        (AE_model.py:378-390); no VGG term."""
        loss = torch.abs(fake - target) * self.cfg.lambda_rec
        loss = loss.reshape(loss.shape[0], -1).mean(-1)
        if with_dis:
            loss_ad = gan_loss(self.apply_D(fake, train=False), True, False,
                               self.gan_mode) * self.cfg.lambda_g
            loss = loss + loss_ad.reshape(loss_ad.shape[0], -1).mean(-1)
        return loss
