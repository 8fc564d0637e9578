"""FD-GAN's adversarial loss (port of
``reid_gan_tpu/models/fdgan/losses.py``; parity: FD/fdgan/losses.py:12-32)."""

import torch


def gan_loss_bce(logits, target_is_real, smooth=False, u=None):
    """Mean BCE-with-logits against one scalar target: with ``smooth``,
    ``u · 0.3 + 0.7`` for real and ``u · 0.3`` for fake, ``u`` the call's
    uniform draw in [0, 1) (given, since the JAX function draws it from its
    key: ``jax.random.uniform(key, ())``); otherwise 1 or 0. The stable form
    ``max(x, 0) − x·t + log1p(exp(−|x|))`` of the JAX function."""
    if smooth:
        target = u * 0.3 + (0.7 if target_is_real else 0.0)
    else:
        target = 1.0 if target_is_real else 0.0
    loss = torch.clamp_min(logits, 0) - logits * target + torch.log1p(torch.exp(-torch.abs(logits)))
    return loss.mean()
