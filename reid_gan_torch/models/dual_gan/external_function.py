"""Multi-mode GAN loss, the WGAN-GP gradient penalty and the VGG19
perceptual loss (port of ``reid_gan_tpu/models/dual_gan/external_function.py``;
parity: CC/dual_gan/models/external_function.py:14-146,226-347).
"""

import math
import warnings

import torch
import torch.nn.functional as F
from torch import nn


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


# ---------------------------------------------------------------------------
# VGG19 perceptual loss
# ---------------------------------------------------------------------------

VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]

# tap names in torchvision layout: reluX_Y after the Y-th conv of block X
TAPS = ["relu1_1", "relu1_2", "relu2_1", "relu2_2",
        "relu3_1", "relu3_2", "relu3_3", "relu3_4",
        "relu4_1", "relu4_2", "relu4_3", "relu4_4",
        "relu5_1", "relu5_2", "relu5_3", "relu5_4"]


class VGG19(nn.Module):
    """The feature-tap extractor (external_function.py:80-100): 16 3×3
    convs ``conv0`` … ``conv15`` with bias, each followed by a ReLU whose
    output is a tap, a 2×2/2 max-pool between the blocks. The input is
    taken as given (no ImageNet normalisation). ``forward(x, last)`` stops
    after the tap ``last`` (default all 16; the trailing pool feeds no tap
    and is not run)."""

    def __init__(self):
        super().__init__()
        cin, ci = 3, 0
        for v in VGG19_CFG:
            if v != "M":
                self.add_module(f"conv{ci}", nn.Conv2d(cin, v, 3, 1, 1))
                cin, ci = v, ci + 1

    def forward(self, x, last=TAPS[-1]):
        taps, ci = {}, 0
        for v in VGG19_CFG:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = F.relu(getattr(self, f"conv{ci}")(x))
            taps[TAPS[ci]] = x
            if TAPS[ci] == last:
                return taps
            ci += 1
        return taps


def compute_gram(x):
    """(N, C, H, W) → (N, C, C) Gram matrices divided by H·W·C
    (external_function.py:103-107)."""
    n, c, h, w = x.shape
    f = x.reshape(n, c, h * w)
    return f @ f.transpose(1, 2) / (h * w * c)


def random_vgg19(seed=0):
    """A ``VGG19`` of random taps: LeCun normal kernels drawn from a generator
    seeded with ``seed``, zero biases. It is built on the meta device first,
    so torch's global generator is left as it was."""
    with torch.device("meta"):
        vgg = VGG19()
    vgg.to_empty(device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for conv in vgg.children():
            conv.weight.normal_(0.0, 1.0 / math.sqrt(conv.weight[0].numel()), generator=g)
            conv.bias.zero_()
    return vgg


class VGGLoss(nn.Module):
    """Content and style L1 over VGG19 taps (external_function.py:110-149):
    ``forward(x, y)`` → (content, style), content the sum of the mean |Δ| at
    ``CONTENT``'s taps (the JAX package's weights, all 1), style the sum of
    the mean |Δ| of the Gram matrices at ``STYLE``'s. The VGG weights are
    constants (``requires_grad`` off): a backward reaches the inputs only.
    ``params``: a ``VGG19`` state dict (``import_torch_vgg19``); without it
    the taps are ``random_vgg19(seed)``'s, with the JAX package's warning."""

    CONTENT = ["relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu5_1"]
    STYLE = ["relu2_2", "relu3_4", "relu4_4", "relu5_2"]

    def __init__(self, params=None, seed=0):
        super().__init__()
        self.pretrained = params is not None
        if params is None:
            warnings.warn(
                "VGGLoss: no pretrained VGG19 weights supplied — "
                "lambda_style/lambda_content will use RANDOM taps. "
                "Load torchvision vgg19 weights via import_torch_vgg19 / "
                "--vgg-weights for reference-parity perceptual loss.",
                stacklevel=2)
            print("[VGGLoss] WARNING: running with randomly initialized "
                  "VGG19 taps (no pretrained weights found)")
            self.model = random_vgg19(seed)
        else:
            with torch.device("meta"):
                self.model = VGG19()
            self.model.load_state_dict(params, assign=True)   # at the given dtype
        self.model.requires_grad_(False)
        self.last = max(self.CONTENT + self.STYLE, key=TAPS.index)

    def forward(self, x, y):
        tx, ty = self.model(x, self.last), self.model(y, self.last)
        content = sum((tx[t] - ty[t]).abs().mean() for t in self.CONTENT)
        style = sum((compute_gram(tx[t]) - compute_gram(ty[t])).abs().mean()
                    for t in self.STYLE)
        return content, style


def _torch_layers():
    """torchvision's ``vgg19.features`` index of each layer: a conv and a
    ReLU per channel entry, a pool per "M" (external_function.py:170-177)."""
    out = []
    for v in VGG19_CFG:
        out.extend(["pool"] if v == "M" else ["conv", "relu"])
    return out


def import_torch_vgg19(state_dict):
    """torchvision vgg19 ``features.{i}.weight/bias`` (OIHW, the port's
    layout) → the ``VGG19`` state dict entries ``conv{k}.weight/bias``
    (external_function.py:152-167); a conv missing from ``state_dict`` is
    left out."""
    conv_ids = [i for i, v in enumerate(_torch_layers()) if v == "conv"]
    out = {}
    for ci, li in enumerate(conv_ids):
        if f"features.{li}.weight" in state_dict:
            out[f"conv{ci}.weight"] = state_dict[f"features.{li}.weight"]
            out[f"conv{ci}.bias"] = state_dict[f"features.{li}.bias"]
    return out
