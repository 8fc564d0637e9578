"""DPTNModel, the dual-task pose transformer engine (port of
``reid_gan_tpu/models/dual_gan/dptn_model.py``; parity:
CC/dual_gan/models/DPTN_model.py).

One step (``step``) on a batch of source images and pose maps (``Xs``,
``Ps``) and target images and pose maps (``Xt``, ``Pt``):

1. G (``DPTNGenerator``) once in train mode: the target branch ``fake_t``
   and the source branch ``fake_s`` (the JAX step's two forwards are
   identical and it keeps the second's BatchNorm stats, so they fold once;
   G's encoder runs twice within it);
2. the D step: the real target, then the detached ``fake_t``, through D in
   train mode (``u`` advances twice); for ``wgangp`` the penalty reads D in
   eval mode from the stats before the step; D's Adam;
3. the G loss against the updated D in eval mode (D's ``u`` after the step
   is the D step's): ``r · (app_t + style_t + content_t) + (1 − r) ·
   (app_s + style_s + content_s) + ad_t`` with ``r = t_s_ratio``, the L1
   ``app`` a scalar mean · λ_rec, the adversarial term on the target branch
   only; G's Adam.
"""

from typing import Any, NamedTuple

import torch

from .ae_model import GANEngine, frozen
from .external_function import gan_loss


class DPTNState(NamedTuple):
    G: torch.nn.Module
    D: torch.nn.Module
    opt_G: torch.optim.Optimizer
    opt_D: torch.optim.Optimizer
    step: Any


class DPTNModel(GANEngine):
    """The DPTN engine: ``net_G`` the ``DPTNGenerator``, ``net_D`` the
    spectral-norm discriminator (dptn_model.py:24-49). The keywords are
    ``GANEngine``'s."""

    MODEL_GEN = "DPTN"

    def __init__(self, cfg, **kwargs):
        super().__init__(cfg, **kwargs)
        self.t_s_ratio = cfg.t_s_ratio

    def init_state(self):
        return DPTNState(*super().init_state())

    def synthesize(self, source, source_pose, target_pose, is_train=False, train=False):
        """(the target image, the source image or None) (DPTN_model.py:
        139-144)."""
        return self.apply_G(source, source_pose, target_pose, is_train, train=train)

    def synthesize_pair(self, source, source_pose, target_pose):
        """Negatives: the flipped batch (``source[::-1]`` with its poses)
        rendered into this batch's target poses, in eval mode, detached
        (dptn_model.py:70-75)."""
        with torch.no_grad():
            fake_n, _ = self.synthesize(source.flip(0), source_pose.flip(0), target_pose)
        return fake_n

    def _g_loss_basic(self, fake, target, use_d):
        """(L1 mean · λ_rec, GAN mean · λ_g against D in eval mode or 0, the
        style and content terms or 0) (dptn_model.py:77-92)."""
        cfg = self.cfg
        loss_app = torch.abs(fake - target).mean() * cfg.lambda_rec
        loss_ad = 0.0
        if use_d:
            la = gan_loss(self.apply_D(fake, train=False), True, False, self.gan_mode)
            loss_ad = (la.mean() if la.dim() > 0 else la) * cfg.lambda_g
        loss_style, loss_content = self.vgg_terms(fake, target)
        if loss_style is None:
            loss_style = loss_content = 0.0
        return loss_app, loss_ad, loss_style, loss_content

    def step(self, state, xs, ps, xt, pt, generator=None, alpha=None):
        """One D→G step (dptn_model.py:94-154; the steps in the module's
        docstring) on (N, 3, H, W) images and (N, pose_nc, H, W) pose maps at
        the nets' dtype. ``generator`` draws, or ``alpha`` gives, the WGAN-GP
        mixing weights. Returns (state, {"G", "D"} losses on the device, the
        target branch's fake)."""
        r = self.t_s_ratio
        fake_t, fake_s = self.apply_G(xs, ps, pt, True, train=True)
        state.opt_D.zero_grad(set_to_none=True)
        loss_D = self.d_loss(xt, fake_t, generator, alpha)
        loss_D.backward()
        state.opt_D.step()
        state.opt_G.zero_grad(set_to_none=True)
        with frozen(self.net_D):
            at, adt, st, ct = self._g_loss_basic(fake_t, xt, True)
            as_, _, ss, cs = self._g_loss_basic(fake_s, xs, False)
        loss_G = r * (at + st + ct) + (1 - r) * (as_ + ss + cs) + adt
        loss_G.backward()
        state.opt_G.step()
        return state._replace(step=state.step + 1), \
            {"G": loss_G.detach(), "D": loss_D.detach()}, fake_t.detach()

    def optimize_parameters(self, state, batch, generator=None):
        """``step`` on a dict of device tensors ``Xs``, ``Ps``, ``Xt``,
        ``Pt`` (dptn_model.py:158-160), cast to the nets' dtype."""
        dtype = next(self.net_G.parameters()).dtype
        return self.step(state, *(batch[k].to(dtype) for k in ("Xs", "Ps", "Xt", "Pt")),
                         generator=generator)
