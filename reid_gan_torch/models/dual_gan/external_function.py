"""Multi-mode GAN loss and the WGAN-GP gradient penalty (port of
``reid_gan_tpu/models/dual_gan/external_function.py:17-63``; parity:
CC/dual_gan/models/external_function.py:14-104). ``VGG19``/``VGGLoss`` are
not ported yet (ROADMAP A5): the engine raises on ``use_vgg``.
"""

import torch
import torch.nn.functional as F


def gan_loss(prediction, target_is_real, is_disc=False, gan_mode="lsgan"):
    """external_function.py:17-40. lsgan returns the per-element losses on
    the generator path (callers mean over the non-batch dims); every
    discriminator path returns a scalar."""
    if gan_mode in ("lsgan", "vanilla"):
        label = 1.0 if target_is_real else 0.0
        if gan_mode == "lsgan":
            loss = (prediction - label) ** 2
        else:
            loss = (torch.clamp_min(prediction, 0) - prediction * label +
                    torch.log1p(torch.exp(-torch.abs(prediction))))
            loss = loss.mean()
        if is_disc and gan_mode == "lsgan":
            loss = loss.mean()
        return loss
    if gan_mode in ("hinge", "wgangp"):
        if is_disc:
            pred = -prediction if target_is_real else prediction
            if gan_mode == "hinge":
                return F.relu(1 + pred).mean()
            return pred.mean()
        return -prediction.mean()
    raise NotImplementedError(f"gan mode {gan_mode} not implemented")


def cal_gradient_penalty(disc_fn, real, fake, alpha=None, generator=None,
                         kind="mixed", constant=1.0, lambda_gp=10.0):
    """WGAN-GP penalty (external_function.py:43-63). ``disc_fn`` maps images
    to scores. ``alpha``: the (N, 1, 1, 1) mixing weights, drawn uniform from
    ``generator`` when not given. Returns (penalty, per-sample gradients);
    the penalty is differentiable for the discriminator's parameters."""
    if lambda_gp <= 0:
        return 0.0, None
    if kind == "real":
        interp = real
    elif kind == "fake":
        interp = fake
    else:
        if alpha is None:
            alpha = torch.rand((real.shape[0], 1, 1, 1), generator=generator,
                               device=real.device, dtype=real.dtype)
        interp = alpha * real + (1 - alpha) * fake
    interp = interp.detach().requires_grad_(True)
    grads, = torch.autograd.grad(disc_fn(interp).sum(), interp, create_graph=True)
    grads = grads.reshape(real.shape[0], -1)
    gp = ((torch.linalg.vector_norm(grads + 1e-16, dim=1) - constant) ** 2).mean()
    return gp * lambda_gp, grads
