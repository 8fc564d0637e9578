"""Building blocks of the pose generator and the discriminator (port of
``reid_gan_tpu/models/dual_gan/base_function.py``; parity:
CC/dual_gan/models/base_function.py).

NCHW. Pre-activation ordering (norm → act → conv) as the reference. The
semantics follow the JAX package, not torch's own layers, where the two
differ:

- spectral normalisation is flax's ``SpectralNorm``: one power iteration
  per forward from the stored ``u`` over the kernel viewed as a
  (fan-in, out) matrix, ``sigma`` differentiable through the kernel, the
  kernel divided by ``where(sigma != 0, sigma, 1)``; the new ``u`` and
  ``sigma`` are stored only in train mode, while an eval forward still
  iterates from the stored ``u`` (not ``torch.nn.utils.spectral_norm``);
- a transposed convolution is flax's ``ConvTranspose(padding="SAME")``,
  which correlates the dilated input with the kernel as stored (no flip):
  here torch's ``conv_transpose2d`` with the kernel held flipped
  (``convert.py`` flips it), cropped to twice the input size;
- BatchNorm is torch's (flax momentum 0.9 = torch momentum 0.1; the
  unbiased running variance, as the JAX package's ``TorchBatchNorm``).

Only what ``PoseGenerator1``, ``AEGenerator`` and ``ResDiscriminator`` use
is here; ``ResUP12Block``, ``FeatureAdaptBlock`` and ``AutoAttn`` are not
ported yet (ROADMAP A: other generators and DPTN).
"""

import torch
import torch.nn.functional as F
from torch import nn


def get_nonlinearity(activation_type="LeakyReLU"):
    """base_function.py:33-46 (LeakyReLU slope 0.1; PReLU as a fixed 0.25
    leak, as the JAX factory)."""
    if activation_type == "ReLU":
        return F.relu
    if activation_type == "SELU":
        return F.selu
    if activation_type == "LeakyReLU":
        return lambda x: F.leaky_relu(x, 0.1)
    if activation_type == "PReLU":
        return lambda x: F.leaky_relu(x, 0.25)
    raise NotImplementedError(f"activation layer [{activation_type}] not found")


def _l2_normalize(x, eps=1e-12):
    """flax's ``_l2_normalize`` over the whole vector: x * rsqrt(|x|² + eps)."""
    return x * torch.rsqrt(torch.sum(x * x) + eps)


class _SpectralMixin:
    """flax ``SpectralNorm`` of ``self.conv.weight`` with ``u`` (1, out) and
    ``sigma`` () buffers. The rows of the matrix are the kernel's fan-in in
    the port's order, a permutation of flax's (H·W·in): ``u`` and ``sigma``
    do not depend on the order of the rows."""

    def _init_spectral(self, out_c):
        self.register_buffer("u", torch.randn(1, out_c))
        self.register_buffer("sigma", torch.ones(()))

    def _normalized(self, w, mat):
        with torch.no_grad():
            v0 = _l2_normalize(self.u @ mat)          # (1, fan-in)
            u0 = _l2_normalize(v0 @ mat.T)            # (1, out)
        sigma = (v0 @ mat.T @ u0.T)[0, 0]
        if self.training:
            with torch.no_grad():
                self.u.copy_(u0)
                self.sigma.copy_(sigma)
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))


class SpectralConv(_SpectralMixin, nn.Module):
    """Conv with optional spectral normalisation (base_function.py:49-78;
    ``use_coord`` is not ported)."""

    def __init__(self, in_c, out_c, kernel_size=3, stride=1, padding=1,
                 use_bias=True, use_spect=False):
        super().__init__()
        self.conv = nn.Conv2d(in_c, out_c, kernel_size, stride, padding, bias=use_bias)
        nn.init.orthogonal_(self.conv.weight)
        if use_bias:
            nn.init.zeros_(self.conv.bias)
        self.use_spect = use_spect
        if use_spect:
            self._init_spectral(out_c)

    def forward(self, x):
        w = self.conv.weight
        if self.use_spect:
            w = self._normalized(w, w.reshape(w.shape[0], -1))
        c = self.conv
        return F.conv2d(x, w, c.bias, c.stride, c.padding)


class SpectralConvTranspose(_SpectralMixin, nn.Module):
    """flax ``ConvTranspose(padding="SAME")`` with optional spectral
    normalisation (base_function.py:81-99). The weight is torch's
    (in, out, kH, kW) layout holding the flax kernel flipped; the transposed
    convolution without padding is cropped to ``stride`` times the input."""

    def __init__(self, in_c, out_c, kernel_size=3, stride=2, use_bias=True,
                 use_spect=False):
        super().__init__()
        self.conv = nn.ConvTranspose2d(in_c, out_c, kernel_size, stride, bias=use_bias)
        nn.init.orthogonal_(self.conv.weight)
        if use_bias:
            nn.init.zeros_(self.conv.bias)
        self.use_spect = use_spect
        if use_spect:
            self._init_spectral(out_c)

    def forward(self, x):
        w = self.conv.weight
        if self.use_spect:
            w = self._normalized(w, w.transpose(0, 1).reshape(w.shape[1], -1))
        s = self.conv.stride
        y = F.conv_transpose2d(x, w, self.conv.bias, s)
        return y[:, :, :x.shape[2] * s[0], :x.shape[3] * s[1]]


def make_norm(norm, c):
    """'batch' | 'instance' | 'none' → module or None (base_function.py:
    102-113). Instance norm is not ported yet
    (ROADMAP A: other generators and DPTN)."""
    if norm == "batch":
        return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)
    if norm == "none" or norm is None:
        return None
    raise NotImplementedError(f"norm {norm!r} is not ported yet "
                              "(ROADMAP A: other generators and DPTN)")


def _apply(norm, x):
    return x if norm is None else norm(x)


def pixel_shuffle(x, factor=2):
    """The JAX package's NHWC pixel shuffle (base_function.py:134-140) on an
    NCHW tensor: input channel ``(i · factor + j) · C + c`` lands on output
    channel ``c`` at offset (i, j). Not ``F.pixel_shuffle``, whose channel
    order is ``c · factor² + i · factor + j``."""
    n, c, h, w = x.shape
    out_c = c // (factor * factor)
    x = x.reshape(n, factor, factor, out_c, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, out_c, h * factor, w * factor)


class ResBlock(nn.Module):
    """Pre-activation residual with a 1×1 bypass, and ``sample_type`` "up"
    (``pixel_shuffle`` ×2 of both branches, which then carry 4 × ``out_c``
    channels) or "down" (2×2 average pool of both) (base_function.py:
    143-184)."""

    def __init__(self, in_c, out_c, hidden_c=None, norm="batch",
                 activation="LeakyReLU", sample_type="none", use_spect=False):
        super().__init__()
        if sample_type not in ("none", "up", "down"):
            raise ValueError(f"sample_type {sample_type!r}")
        hidden_c = hidden_c or out_c
        conv_c = out_c * 4 if sample_type == "up" else out_c
        self.act = get_nonlinearity(activation)
        self.sample_type = sample_type
        self.norm1 = make_norm(norm, in_c)
        self.conv1 = SpectralConv(in_c, hidden_c, 3, 1, 1, use_spect=use_spect)
        self.norm2 = make_norm(norm, hidden_c)
        self.conv2 = SpectralConv(hidden_c, conv_c, 3, 1, 1, use_spect=use_spect)
        self.bypass = SpectralConv(in_c, conv_c, 1, 1, 0, use_spect=use_spect)

    def forward(self, x):
        y = self.conv1(self.act(_apply(self.norm1, x)))
        y = self.conv2(self.act(_apply(self.norm2, y)))
        short = self.bypass(x)
        if self.sample_type == "up":
            return pixel_shuffle(y, 2) + pixel_shuffle(short, 2)
        if self.sample_type == "down":
            return F.avg_pool2d(y, 2, 2) + F.avg_pool2d(short, 2, 2)
        return y + short


class EncoderBlockOptimized(nn.Module):
    """First generator encoder block: conv↓2 → norm → act → conv
    (base_function.py:187-209)."""

    def __init__(self, in_c, out_c, norm="batch", activation="LeakyReLU",
                 use_spect=False):
        super().__init__()
        self.act = get_nonlinearity(activation)
        self.conv1 = SpectralConv(in_c, out_c, 4, 2, 1, use_spect=use_spect)
        self.norm1 = make_norm(norm, out_c)
        self.conv2 = SpectralConv(out_c, out_c, 3, 1, 1, use_spect=use_spect)

    def forward(self, x):
        return self.conv2(self.act(_apply(self.norm1, self.conv1(x))))


class EncoderBlock(nn.Module):
    """Mid encoder block: norm → act → conv↓2 → norm → act → conv, or the
    norm-free conv↓2 → act → conv → act (base_function.py:212-248)."""

    def __init__(self, in_c, out_c, norm="batch", activation="LeakyReLU",
                 use_spect=False):
        super().__init__()
        self.act = get_nonlinearity(activation)
        self.norm1 = make_norm(norm, in_c)
        self.conv1 = SpectralConv(in_c, out_c, 4, 2, 1, use_spect=use_spect)
        self.norm2 = make_norm(norm, out_c)
        self.conv2 = SpectralConv(out_c, out_c, 3, 1, 1, use_spect=use_spect)

    def forward(self, x):
        if self.norm1 is not None:
            y = self.conv1(self.act(self.norm1(x)))
            return self.conv2(self.act(self.norm2(y)))
        return self.act(self.conv2(self.act(self.conv1(x))))


class FeatureAdaptBlock1(nn.Module):
    """1×1 conv channel adapter for the spatial re-ID map → norm → act
    (base_function.py:273-288)."""

    def __init__(self, in_c, out_c, norm="batch", activation="LeakyReLU"):
        super().__init__()
        self.act = get_nonlinearity(activation)
        self.conv1 = nn.Conv2d(in_c, out_c, 1)
        nn.init.orthogonal_(self.conv1.weight)
        nn.init.zeros_(self.conv1.bias)
        self.norm1 = make_norm(norm, out_c)

    def forward(self, x):
        return self.act(_apply(self.norm1, self.conv1(x)))


class ResBlockDecoder(nn.Module):
    """Pre-activation residual ×2 upsampling decoder block
    (base_function.py:291-322)."""

    def __init__(self, in_c, out_c, hidden_c=None, norm="batch",
                 activation="LeakyReLU", use_spect=False):
        super().__init__()
        hidden_c = hidden_c or out_c
        self.act = get_nonlinearity(activation)
        self.norm1 = make_norm(norm, in_c)
        self.conv1 = SpectralConv(in_c, hidden_c, 3, 1, 1, use_spect=use_spect)
        self.norm2 = make_norm(norm, hidden_c)
        self.conv2 = SpectralConvTranspose(hidden_c, out_c, 3, 2, use_spect=use_spect)
        self.bypass = SpectralConvTranspose(in_c, out_c, 3, 2, use_spect=use_spect)

    def forward(self, x):
        y = self.conv1(self.act(_apply(self.norm1, x)))
        y = self.conv2(self.act(_apply(self.norm2, y)))
        return y + self.bypass(x)


class ResBlockEncoderOptimized(nn.Module):
    """First discriminator block: conv → [norm] → act → conv↓2, plus an
    avg-pool → 1×1 conv shortcut (base_function.py:359-386)."""

    def __init__(self, in_c, out_c, hidden_c=None, norm="none",
                 activation="LeakyReLU", use_spect=True):
        super().__init__()
        hidden_c = hidden_c or in_c
        self.act = get_nonlinearity(activation)
        self.conv1 = SpectralConv(in_c, hidden_c, 3, 1, 1, use_spect=use_spect)
        self.norm1 = make_norm(norm, hidden_c)
        self.conv2 = SpectralConv(hidden_c, out_c, 4, 2, 1, use_spect=use_spect)
        self.bypass = SpectralConv(in_c, out_c, 1, 1, 0, use_spect=use_spect)

    def forward(self, x):
        y = self.conv2(self.act(_apply(self.norm1, self.conv1(x))))
        return y + self.bypass(F.avg_pool2d(x, 2, 2))


class ResBlockEncoder(nn.Module):
    """Mid discriminator block: [norm] → act → conv → [norm] → act → conv↓2,
    plus an avg-pool → 1×1 conv shortcut (base_function.py:389-420)."""

    def __init__(self, in_c, out_c, hidden_c=None, norm="none",
                 activation="LeakyReLU", use_spect=True):
        super().__init__()
        hidden_c = hidden_c or in_c
        self.act = get_nonlinearity(activation)
        self.norm1 = make_norm(norm, in_c)
        self.conv1 = SpectralConv(in_c, hidden_c, 3, 1, 1, use_spect=use_spect)
        self.norm2 = make_norm(norm, hidden_c)
        self.conv2 = SpectralConv(hidden_c, out_c, 4, 2, 1, use_spect=use_spect)
        self.bypass = SpectralConv(in_c, out_c, 1, 1, 0, use_spect=use_spect)

    def forward(self, x):
        y = self.conv1(self.act(_apply(self.norm1, x)))
        y = self.conv2(self.act(_apply(self.norm2, y)))
        return y + self.bypass(F.avg_pool2d(x, 2, 2))


class Output(nn.Module):
    """[norm] → act → reflection pad → conv → tanh (base_function.py:423-449)."""

    def __init__(self, in_c, out_c, kernel_size=3, norm="none",
                 activation="LeakyReLU", use_spect=False):
        super().__init__()
        self.act = get_nonlinearity(activation)
        self.norm1 = make_norm(norm, in_c)
        self.pad = kernel_size // 2
        self.conv1 = SpectralConv(in_c, out_c, kernel_size, 1, 0, use_spect=use_spect)

    def forward(self, x):
        y = self.act(_apply(self.norm1, x))
        y = F.pad(y, (self.pad,) * 4, mode="reflect")
        return torch.tanh(self.conv1(y))
