"""FD-GAN's pose generator and PatchGAN discriminator (port of
``reid_gan_tpu/models/fdgan/networks.py``; parity: FD/fdgan/
networks.py:62-237).

NCHW in and out. Module names follow the flax modules (``en_conv1``,
``en_conv{i}_conv``/``_bn``, ``en_avg_conv``/``_bn``, ``W_reid``/``W_pose``/
``W_noise``, ``de_avg_conv``/``_bn``, ``de_conv{i}_conv``/``_bn``;
``conv0``..``conv3``, ``bn1``..``bn3``, ``conv_out``), so
``models/dual_gan/convert.state_dict_from_jax`` maps a JAX tree onto a
``state_dict`` path by path (flipping the ``ConvTranspose`` kernels). What the JAX modules fix and the port keeps:

- pre-activation order: LeakyReLU(0.2) before each encoder conv but the
  first, ReLU before each decoder conv, the first conv and the logits conv
  bare;
- flax's ``ConvTranspose`` correlates the dilated input with the kernel
  unflipped; a torch transposed convolution applies its kernel flipped, so
  the converter flips it. The 4×4 stride-2 ``padding="SAME"`` layers are
  ``ConvTranspose2d(k 4, s 2, p 1)`` (both pad the dilated input by 2 a
  side), and ``de_avg``, ``padding="VALID"`` on the 1×1 code, is a
  ``ConvTranspose2d`` with the pose encoder's (H/32, W/32) kernel;
- BatchNorm with torch's running-stat convention (eps 1e-5, momentum 0.1);
  the GAN's BatchNorm scales start at N(1, 0.02), as the reference's
  ``weights_init_normal`` (networks.py:13-21), the convolutions at N(0, 0.02);
- Dp reads the posemap channels first, then the image (FD/fdgan/
  model.py:160-161).

The generator's dropout (after ``de_avg`` and the four middle decoder
blocks) applies the keep masks it is given (``masks``: ``draw_masks``'s, or
the JAX step's in a test); given none, the forward draws them with
``draw_masks`` from an explicit ``torch.Generator``.
"""

import torch
from torch import nn
import torch.nn.functional as F

# connect_layers → per-decode-stage input channel multipliers (networks.py:78-83)
_INPUT_CHANNEL = [
    [8, 8, 4, 2, 1],
    [16, 8, 4, 2, 1],
    [16, 16, 4, 2, 1],
    [16, 16, 8, 2, 1],
    [16, 16, 8, 4, 1],
    [16, 16, 8, 4, 2],
]

_DEC = ("de_conv5", "de_conv4", "de_conv3", "de_conv2")


def _gan_init(module):
    """N(0, 0.02) convolutions and Dense kernels, N(1, 0.02) BatchNorm
    scales with zero bias (networks.py:13-21)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            nn.init.normal_(m.weight, 0.0, 0.02)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            nn.init.normal_(m.weight, 1.0, 0.02)
            nn.init.zeros_(m.bias)


class CustomPoseGenerator(nn.Module):
    """(N, 18, H, W) pose maps, (N, reid_nc) re-ID features and (N,
    noise_nc) noise → (N, 3, H, W) in tanh [-1, 1]. H and W are multiples
    of 32; ``height``/``width`` fix the 1×1 code's kernel (H/32, W/32)."""

    def __init__(self, pose_feature_nc=128, reid_feature_nc=2048, noise_nc=56,
                 pose_nc=18, output_nc=3, dropout=0.0, fuse_mode="cat",
                 connect_layers=0, ngf=64, height=256, width=128):
        super().__init__()
        if not 0 <= connect_layers <= 5:
            raise ValueError("connect_layers must be in 0..5")
        if fuse_mode not in ("cat", "add"):
            raise ValueError("fuse_mode must be cat|add")
        self.dropout = dropout
        self.ngf, self.height, self.width = ngf, height, width
        self.fuse_mode = fuse_mode
        self.connect_layers = connect_layers
        k_avg = (height // 32, width // 32)

        def conv(cin, cout):
            return nn.Conv2d(cin, cout, 4, 2, 1, bias=False)

        self.en_conv1 = conv(pose_nc, ngf)
        for i, (cin, cout) in enumerate(((ngf, ngf * 2), (ngf * 2, ngf * 4),
                                         (ngf * 4, ngf * 8), (ngf * 8, ngf * 8)), start=2):
            setattr(self, f"en_conv{i}_conv", conv(cin, cout))
            setattr(self, f"en_conv{i}_bn", nn.BatchNorm2d(cout))
        self.en_avg_conv = nn.Conv2d(ngf * 8, pose_feature_nc, k_avg, bias=False)
        self.en_avg_bn = nn.BatchNorm2d(pose_feature_nc)
        if fuse_mode == "cat":
            fused = reid_feature_nc + pose_feature_nc + noise_nc
        else:
            fused = max(pose_feature_nc, reid_feature_nc, noise_nc)
            self.W_reid = nn.Linear(reid_feature_nc, fused, bias=False)
            self.W_pose = nn.Linear(pose_feature_nc, fused, bias=False)
            self.W_noise = nn.Linear(noise_nc, fused, bias=False)
        self.de_avg_conv = nn.ConvTranspose2d(fused, ngf * 8, k_avg, bias=False)
        self.de_avg_bn = nn.BatchNorm2d(ngf * 8)
        mult = _INPUT_CHANNEL[connect_layers]
        for name, m, cout in zip(_DEC, mult, (ngf * 8, ngf * 4, ngf * 2, ngf)):
            setattr(self, f"{name}_conv", nn.ConvTranspose2d(ngf * m, cout, 4, 2, 1,
                                                             bias=False))
            setattr(self, f"{name}_bn", nn.BatchNorm2d(cout))
        self.de_conv1_conv = nn.ConvTranspose2d(ngf * mult[4], output_nc, 4, 2, 1,
                                                bias=False)
        _gan_init(self)

    def draw_masks(self, n, generator):
        """The five keep masks of a batch of ``n``, drawn from ``generator``
        in the order the forward applies them (after ``de_avg`` and each of
        the four middle decoder blocks)."""
        h, w, ngf = self.height // 32, self.width // 32, self.ngf
        dev = self.de_avg_conv.weight.device
        return [torch.rand((n, c, h << k, w << k), generator=generator, device=dev)
                < 1.0 - self.dropout
                for k, c in enumerate((ngf * 8, ngf * 8, ngf * 4, ngf * 2, ngf))]

    def _drop(self, x, i, masks):
        """flax ``Dropout``: keep with p 1 − rate, scaled by 1 / (1 − rate)."""
        if masks is None:
            return x
        return torch.where(masks[i], x / (1.0 - self.dropout), 0.0)

    def forward(self, posemap, reid_feature, noise, masks=None, generator=None):
        if not self.training or self.dropout <= 0.0:
            masks = None
        elif masks is None:
            masks = self.draw_masks(len(noise), generator)
        lrelu = lambda t: F.leaky_relu(t, 0.2)  # noqa: E731
        p = [self.en_conv1(posemap)]
        for i in range(2, 6):
            p.append(getattr(self, f"en_conv{i}_bn")(
                getattr(self, f"en_conv{i}_conv")(lrelu(p[-1]))))
        pose_feature = self.en_avg_bn(self.en_avg_conv(lrelu(p[-1])))   # (N, C, 1, 1)
        if self.fuse_mode == "cat":
            feat = torch.cat([reid_feature[:, :, None, None], pose_feature,
                              noise[:, :, None, None]], dim=1)
        else:
            feat = (self.W_reid(reid_feature) + self.W_pose(pose_feature[:, :, 0, 0]) +
                    self.W_noise(noise))[:, :, None, None]
        y = self.de_avg_bn(self.de_avg_conv(F.relu(feat)))
        y = self._drop(y, 0, masks)
        cn = self.connect_layers
        for i, (name, skip) in enumerate(zip(_DEC, p[:0:-1]), start=1):
            if cn > 0:
                y = torch.cat([y, skip], dim=1)
                cn -= 1
            y = getattr(self, f"{name}_bn")(getattr(self, f"{name}_conv")(F.relu(y)))
            y = self._drop(y, i, masks)
        if cn > 0:
            y = torch.cat([y, p[0]], dim=1)
        return torch.tanh(self.de_conv1_conv(F.relu(y)))


class NLayerDiscriminator(nn.Module):
    """3-layer PatchGAN over (posemap ⊕ image), (N, input_nc, H, W) →
    (N, 1, H/8 − 2, W/8 − 2) logits (networks.py:194-237)."""

    def __init__(self, input_nc=21, ndf=64, n_layers=3):
        super().__init__()
        self.n_layers = n_layers
        self.conv0 = nn.Conv2d(input_nc, ndf, 4, 2, 1)
        nf = ndf
        for n in range(1, n_layers):
            out = ndf * min(2 ** n, 8)
            setattr(self, f"conv{n}", nn.Conv2d(nf, out, 4, 2, 1, bias=False))
            setattr(self, f"bn{n}", nn.BatchNorm2d(out))
            nf = out
        out = ndf * min(2 ** n_layers, 8)
        setattr(self, f"conv{n_layers}", nn.Conv2d(nf, out, 4, 1, 1, bias=False))
        setattr(self, f"bn{n_layers}", nn.BatchNorm2d(out))
        self.conv_out = nn.Conv2d(out, 1, 4, 1, 1)
        _gan_init(self)

    def forward(self, x):
        y = F.leaky_relu(self.conv0(x), 0.2)
        for n in range(1, self.n_layers + 1):
            y = F.leaky_relu(getattr(self, f"bn{n}")(getattr(self, f"conv{n}")(y)), 0.2)
        return self.conv_out(y)
