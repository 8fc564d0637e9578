"""The generators and the discriminator of the dual_gan engines (port of
``reid_gan_tpu/models/dual_gan/networks.py``; parity:
CC/dual_gan/models/networks.py:14-38,54-355,401-543,639-831,917-956).

NCHW in and out. Module names follow the flax modules (``block0``,
``encoder{i}``, ``feature_block``, ``PCTM``, ``decoder{i}``, ``outconv``;
``encoders_{i}``, ``mblocks_{i}``, ``decoder.decoder{i}``; ``W_reid``,
``de_avg_conv``, ``de_conv{i}_conv``; ``block0``, ``encoder{i}``, ``conv``),
so ``convert.py`` maps a JAX tree onto a ``state_dict`` path by path.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.transforms import cubic_resize
from ..precision import ConvTranspose2d, Linear, widen
from .base_function import (
    EncoderBlock,
    EncoderBlockOptimized,
    FeatureAdaptBlock1,
    Output,
    ResBlock,
    ResBlockDecoder,
    ResBlockEncoder,
    ResBlockEncoderOptimized,
    SpectralConv,
    get_nonlinearity,
    make_norm,
)
from .ptm import PCTM, PTM


def _enc_mults(ngf, img_f, layers):
    mults = [1]
    for i in range(layers - 1):
        mults.append(min(2 ** (i + 1), img_f // ngf))
    return mults


def _dec_mults(ngf, img_f, layers):
    return [min(2 ** (layers - i - 2), img_f // ngf) if i != layers - 1 else 1
            for i in range(layers)]


def _add_encoders(net, prefix, ngf, img_f, layers, norm, activation, use_spect,
                  use_coord):
    """The encoder stack after ``block0``: ``{prefix}{i}`` EncoderBlocks.
    Returns the last one's width."""
    mults = _enc_mults(ngf, img_f, layers)
    for i, m in enumerate(mults[1:]):
        net.add_module(f"{prefix}{i}", EncoderBlock(
            ngf * mults[i], ngf * m, norm, activation, use_spect, use_coord))
    return ngf * mults[-1]


def _run(net, prefix, n, x):
    for i in range(n):
        x = getattr(net, f"{prefix}{i}")(x)
    return x


class SourceEncoder(nn.Module):
    """DPTN's source encoder ``En_s`` (networks.py:51-73): ``block0`` and
    ``layers − 1`` encoder blocks."""

    def __init__(self, input_nc=3, ngf=64, img_f=256, layers=3, norm="batch",
                 activation="LeakyReLU", use_spect=False, use_coord=False):
        super().__init__()
        self.block0 = EncoderBlockOptimized(input_nc, ngf, norm, activation, use_spect,
                                            use_coord)
        _add_encoders(self, "encoder", ngf, img_f, layers, norm, activation,
                      use_spect, use_coord)
        self.layers = layers

    def forward(self, source):
        return _run(self, "encoder", self.layers - 1, self.block0(source))


class ResizeReID(nn.Module):
    """Residual adaptor (networks.py:76-98): the JAX bicubic 2× upsample
    (``jax.image.resize``: Keys a = −0.5, renormalised edge taps; the plain
    resize of kernel K12, ``ops/transforms.py::cubic_resize``) of a (N, C,
    H, W) map, plus three ResBlocks (C → ngf → ngf → C) on it."""

    def __init__(self, in_c, ngf=64, norm="batch", activation="LeakyReLU",
                 use_spect=False):
        super().__init__()
        kw = dict(norm=norm, activation=activation, use_spect=use_spect)
        self.resblock1 = ResBlock(in_c, ngf, **kw)
        self.resblock2 = ResBlock(ngf, ngf, **kw)
        self.resblock3 = ResBlock(ngf, in_c, **kw)

    def forward(self, x):
        x = cubic_resize(x, 2 * x.shape[2], 2 * x.shape[3])
        return x + self.resblock3(self.resblock2(self.resblock1(x)))


class _Decoder(nn.Module):
    """The shared decoder stack: ``layers`` ResBlockDecoders (×2 each) and
    the Output block (networks.py:101-125, without skip adds). ``in_c``:
    the input's channels (default ``ngf · min(2^(layers−1), img_f/ngf)``,
    the encoders' last width)."""

    def __init__(self, ngf=64, img_f=256, layers=3, output_nc=3, norm="batch",
                 activation="LeakyReLU", use_spect=False, in_c=None):
        super().__init__()
        cin = in_c or ngf * min(2 ** (layers - 1), img_f // ngf)
        for i, m in enumerate(_dec_mults(ngf, img_f, layers)):
            self.add_module(f"decoder{i}", ResBlockDecoder(
                cin, ngf * m, ngf * m, norm, activation, use_spect))
            cin = ngf * m
        self.outconv = Output(cin, output_nc, 3, "none", activation, use_spect)
        self.layers = layers

    def forward(self, feature):
        return self.outconv(_run(self, "decoder", self.layers, feature))


class PoseGenerator1(nn.Module):
    """Pose-map encoder + 1×1 re-ID adapter + PCTM + decoder with U-Net skip
    adds (networks.py:254-303). ``reid_f``: the spatial (N, reid_nc, H/8,
    W/8) GAN map; ``source_pose``: (N, pose_nc, H, W) maps → (N, 3, H, W)
    in [-1, 1]."""

    def __init__(self, ngf=64, pose_nc=18, img_f=256, layers=3, norm="batch",
                 activation="LeakyReLU", use_spect=False, output_nc=3, affine=True,
                 nhead=2, num_CABs=2, num_TTBs=2, reid_nc=2048, use_coord=False):
        super().__init__()
        self.block0 = EncoderBlockOptimized(pose_nc, ngf, norm, activation, use_spect,
                                            use_coord)
        d_model = _add_encoders(self, "encoder", ngf, img_f, layers, norm,
                                activation, use_spect, use_coord)
        self.feature_block = FeatureAdaptBlock1(reid_nc, d_model, norm, activation)
        self.PCTM = PCTM(d_model, nhead, num_CABs, num_TTBs, dim_feedforward=d_model,
                         activation="LeakyReLU", affine=affine, norm=norm)
        cin = d_model
        for i, m in enumerate(_dec_mults(ngf, img_f, layers)):
            self.add_module(f"decoder{i}", ResBlockDecoder(
                cin, ngf * m, ngf * m, norm, activation, use_spect))
            cin = ngf * m
        self.outconv = Output(cin, output_nc, 3, "none", activation, use_spect)
        self.layers = layers

    def forward(self, reid_f, source_pose):
        f_p = self.block0(source_pose)
        skips = []
        for i in range(self.layers - 1):
            skips.append(f_p)
            f_p = getattr(self, f"encoder{i}")(f_p)
        f_g = self.PCTM(f_p, self.feature_block(reid_f))
        for i in range(self.layers):
            f_g = getattr(self, f"decoder{i}")(f_g)
            if i < self.layers - 1:
                f_g = f_g + skips.pop()
        return self.outconv(f_g)


class AEGenerator(nn.Module):
    """The autoencoder generator of the AE hard-mix mode and the GAN
    warm-up, with the encoder and the decoder callable apart
    (networks.py:128-173): ``forward_enc`` (N, 3, H, W) → (N, ngf·4, H/8,
    W/8) features, ``forward_dec`` (``num_blocks`` mid ResBlocks, then the
    decoder) back to (N, 3, H, W) in [-1, 1]."""

    def __init__(self, image_nc=3, ngf=64, img_f=256, layers=3, norm="batch",
                 activation="LeakyReLU", use_spect=False, output_nc=3, num_blocks=3,
                 use_coord=False):
        super().__init__()
        self.block0 = EncoderBlockOptimized(image_nc, ngf, norm, activation, use_spect,
                                            use_coord)
        d_model = _add_encoders(self, "encoders_", ngf, img_f, layers, norm,
                                activation, use_spect, use_coord)
        for i in range(num_blocks):
            self.add_module(f"mblocks_{i}", ResBlock(
                d_model, d_model, norm=norm, activation=activation, use_spect=use_spect,
                use_coord=use_coord))
        self.decoder = _Decoder(ngf, img_f, layers, output_nc, norm, activation,
                                use_spect)
        self.num_encoders, self.num_blocks = layers - 1, num_blocks

    def forward(self, inputs):
        return self.forward_dec(self.forward_enc(inputs))

    def forward_enc(self, source):
        return _run(self, "encoders_", self.num_encoders, self.block0(source))

    def forward_dec(self, feature):
        return self.decoder(_run(self, "mblocks_", self.num_blocks, feature))


class DECGenerator1(nn.Module):
    """The spatial (N, reid_nc, h, w) re-ID map → a 1×1 adapter to ngf·4
    channels, ``num_blocks`` ResBlocks, the decoder → (N, 3, 8h, 8w)
    (networks.py:176-200)."""

    def __init__(self, ngf=64, img_f=256, layers=3, norm="batch", activation="LeakyReLU",
                 use_spect=False, output_nc=3, num_blocks=3, reid_nc=2048):
        super().__init__()
        c = ngf * 4
        self.feature_block = FeatureAdaptBlock1(reid_nc, c, norm, activation)
        for i in range(num_blocks):
            self.add_module(f"mblock{i}", ResBlock(c, c, norm=norm, activation=activation,
                                                   use_spect=use_spect))
        self.dec = _Decoder(ngf, img_f, layers, output_nc, norm, activation, use_spect,
                            in_c=c)
        self.num_blocks = num_blocks

    def forward(self, feature):
        return self.dec(_run(self, "mblock", self.num_blocks, self.feature_block(feature)))


class FDGenerator(nn.Module):
    """FD-GAN-style decoder from a re-ID vector (networks.py:203-251).
    ``fuse_mode``: ``add`` (bias-free Dense ``W_reid`` and ``W_noise`` to
    max(reid_feature_nc, noise_nc), summed), ``cat`` (vector and noise
    concatenated) or ``none`` (``W_reid`` to reid_feature_nc). Then ReLU, a
    VALID ``bottleneck_hw`` transposed conv on the 1×1 map (``de_avg_conv``),
    BatchNorm, and five ReLU → 4×4 stride-2 SAME transposed convs (torch's
    padding 1: flax's output starts one row and column into torch's unpadded
    form; ``de_conv5`` … ``de_conv1``, BatchNorm after all but the last)
    → tanh, (N, 3, 32·bh, 32·bw). ``reid_nc``, ``noise_in``: the input
    vectors' widths. The JAX module's dropout after each BatchNorm has rate
    0 in every caller, and is left out."""

    def __init__(self, reid_feature_nc=2048, ngf=64, noise_nc=512, output_nc=3,
                 fuse_mode="none", bottleneck_hw=(8, 4), reid_nc=2048, noise_in=512):
        super().__init__()
        if fuse_mode == "cat":
            feat_c = reid_nc + noise_in
        elif fuse_mode == "add":
            feat_c = max(reid_feature_nc, noise_nc)
            self.W_reid = Linear(reid_nc, feat_c, bias=False)
            self.W_noise = Linear(noise_in, feat_c, bias=False)
        elif fuse_mode == "none":
            feat_c = reid_feature_nc
            self.W_reid = Linear(reid_nc, feat_c, bias=False)
        else:
            raise ValueError(f"fuse_mode {fuse_mode!r}")
        self.fuse_mode = fuse_mode
        self.de_avg_conv = ConvTranspose2d(feat_c, ngf * 8, bottleneck_hw, bias=False)
        self.de_avg_bn = make_norm("batch", ngf * 8)
        cin = ngf * 8
        for i, c in enumerate((ngf * 8, ngf * 4, ngf * 2, ngf, output_nc)):
            self.add_module(f"de_conv{5 - i}_conv",
                            ConvTranspose2d(cin, c, 4, 2, 1, bias=False))
            if i < 4:
                self.add_module(f"de_conv{5 - i}_bn", make_norm("batch", c))
            cin = c
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.ConvTranspose2d)):
                nn.init.orthogonal_(m.weight)

    def forward(self, reid_feature, noise=None):
        if self.fuse_mode == "cat":
            feat = torch.cat([reid_feature, noise], dim=1)
        elif self.fuse_mode == "add":
            feat = self.W_reid(reid_feature) + self.W_noise(noise)
        else:
            feat = self.W_reid(reid_feature)
        y = self.de_avg_bn(self.de_avg_conv(F.relu(feat)[:, :, None, None]))
        for i in range(5, 1, -1):
            y = getattr(self, f"de_conv{i}_bn")(getattr(self, f"de_conv{i}_conv")(F.relu(y)))
        return widen(torch.tanh(self.de_conv1_conv(F.relu(y))))


class PoseAEGenerator(nn.Module):
    """Two encoder stacks, one on the source image (``block0_i``,
    ``encoders_i_{k}``) and one on the target pose maps (``block0_p``,
    ``encoders_p_{k}``), then PCTM (query the pose features, value the image
    features), then the decoder; no skip adds (networks.py:306-362)."""

    def __init__(self, ngf=64, image_nc=3, pose_nc=18, img_f=256, layers=3, norm="batch",
                 activation="LeakyReLU", use_spect=False, use_coord=False, output_nc=3,
                 affine=True, nhead=2, num_CABs=2, num_TTBs=2):
        super().__init__()
        enc = (norm, activation, use_spect, use_coord)
        self.block0_p = EncoderBlockOptimized(pose_nc, ngf, *enc)
        self.block0_i = EncoderBlockOptimized(image_nc, ngf, *enc)
        _add_encoders(self, "encoders_i_", ngf, img_f, layers, *enc)
        d_model = _add_encoders(self, "encoders_p_", ngf, img_f, layers, *enc)
        self.pctm = PCTM(d_model, nhead, num_CABs, num_TTBs, dim_feedforward=d_model,
                         activation="LeakyReLU", affine=affine, norm=norm)
        self.decoder = _Decoder(ngf, img_f, layers, output_nc, norm, activation, use_spect)
        self.num_encoders = layers - 1

    def forward(self, source_image, target_pose):
        f_i, f_p = self.forward_enc(source_image, target_pose)
        return self.forward_dec(self.pctm(f_p, f_i))

    def forward_enc(self, source_image, target_pose):
        f_i, f_p = self.block0_i(source_image), self.block0_p(target_pose)
        for k in range(self.num_encoders):
            f_i = getattr(self, f"encoders_i_{k}")(f_i)
            f_p = getattr(self, f"encoders_p_{k}")(f_p)
        return f_i, f_p

    def forward_dec(self, f_composed):
        return self.decoder(f_composed)


class DPTNGenerator(nn.Module):
    """Dual-task Pose Transformer Network (networks.py:365-429). One encoder
    (``block0``, ``encoders_{k}``, ``mblocks_{k}``) runs on ``cat(source,
    source_pose, source_pose)`` and again on ``cat(source, source_pose,
    target_pose)`` (in train mode its BatchNorm folds twice a forward); PTM
    moves the source branch's features by the source encoder's
    (``source_encoder``) into the target pose; one decoder renders both.
    Returns (the target image, the source image, or None unless
    ``is_train``)."""

    def __init__(self, image_nc=3, pose_nc=18, ngf=64, img_f=256, layers=3, norm="batch",
                 activation="LeakyReLU", use_spect=False, use_coord=False, output_nc=3,
                 num_blocks=3, affine=True, nhead=2, num_CABs=2, num_TTBs=2):
        super().__init__()
        enc = (norm, activation, use_spect, use_coord)
        self.block0 = EncoderBlockOptimized(image_nc + 2 * pose_nc, ngf, *enc)
        d_model = _add_encoders(self, "encoders_", ngf, img_f, layers, *enc)
        for i in range(num_blocks):
            self.add_module(f"mblocks_{i}", ResBlock(
                d_model, d_model, norm=norm, activation=activation, use_spect=use_spect,
                use_coord=use_coord))
        self.ptm = PTM(d_model, nhead, num_CABs, num_TTBs, dim_feedforward=d_model,
                       activation="LeakyReLU", affine=affine, norm=norm)
        self.source_encoder = SourceEncoder(image_nc, ngf, img_f, layers, *enc)
        self.decoder = _Decoder(ngf, img_f, layers, output_nc, norm, activation, use_spect)
        self.num_encoders, self.num_blocks = layers - 1, num_blocks

    def _encode(self, x):
        f = _run(self, "encoders_", self.num_encoders, self.block0(x))
        return _run(self, "mblocks_", self.num_blocks, f)

    def forward(self, source, source_b, target_b, is_train=True):
        f_s_s = self._encode(torch.cat([source, source_b, source_b], dim=1))
        f_s_t = self._encode(torch.cat([source, source_b, target_b], dim=1))
        f_s_t = self.ptm(f_s_s, f_s_t, self.source_encoder(source))
        out_image_s = self.decoder(f_s_s) if is_train else None
        return self.decoder(f_s_t), out_image_s


class ResDiscriminator(nn.Module):
    """Spectral-norm residual discriminator (networks.py:432-461): (N, 3, H,
    W) → (N, 1, H/2^layers, W/2^layers) scores, in at least fp32
    (networks.py:461)."""

    def __init__(self, input_nc=3, ndf=64, img_f=1024, layers=3, norm="none",
                 activation="LeakyReLU", use_spect=True):
        super().__init__()
        self.act = get_nonlinearity(activation)
        self.block0 = ResBlockEncoderOptimized(input_nc, ndf, ndf, norm, activation,
                                               use_spect)
        mult = 1
        for i in range(layers - 1):
            mult_prev = mult
            mult = min(2 ** (i + 1), img_f // ndf)
            self.add_module(f"encoder{i}", ResBlockEncoder(
                ndf * mult_prev, ndf * mult, ndf * mult_prev, norm, activation,
                use_spect))
        self.conv = SpectralConv(ndf * mult, 1, 1, 1, 0, use_spect=True)
        self.layers = layers

    def forward(self, x):
        return widen(self.conv(self.act(_run(self, "encoder", self.layers - 1,
                                             self.block0(x)))))


def define_G(model_gen="Pose", image_nc=3, pose_nc=18, ngf=64, img_f=256,
             encoder_layer=3, norm="batch", activation="LeakyReLU",
             use_spect=False, use_coord=False, output_nc=3, num_blocks=3, affine=True,
             nhead=2, num_CABs=2, num_TTBs=2, reid_nc=2048):
    """Generator factory (networks.py:464-495). ``reid_nc``: the width of
    the re-ID input of the pose, DEC and FD generators. ``FD`` takes
    ``img_f`` as its ``reid_feature_nc``, 512-wide noise and the ``add``
    fusion, as the JAX factory does."""
    if model_gen == "DPTN":
        return DPTNGenerator(image_nc, pose_nc, ngf, img_f, encoder_layer, norm,
                             activation, use_spect, use_coord, output_nc, num_blocks,
                             affine, nhead, num_CABs, num_TTBs)
    if model_gen == "AE":
        return AEGenerator(image_nc, ngf, img_f, encoder_layer, norm, activation,
                           use_spect, output_nc, num_blocks, use_coord)
    if model_gen == "DEC":
        return DECGenerator1(ngf, img_f, encoder_layer, norm, activation, use_spect,
                             output_nc, num_blocks, reid_nc)
    if model_gen == "FD":
        return FDGenerator(img_f, ngf, noise_nc=512, output_nc=3, fuse_mode="add",
                           reid_nc=reid_nc)
    if model_gen == "Pose":
        return PoseGenerator1(ngf, pose_nc, img_f, encoder_layer, norm, activation,
                              use_spect, output_nc, affine, nhead, num_CABs,
                              num_TTBs, reid_nc, use_coord)
    if model_gen == "PoseAE":
        return PoseAEGenerator(ngf, image_nc, pose_nc, img_f, encoder_layer, norm,
                               activation, use_spect, use_coord, output_nc, affine,
                               nhead, num_CABs, num_TTBs)
    raise ValueError(f"generator {model_gen} not implemented")


def define_D(input_nc=3, ndf=32, img_f=128, layers=3, norm="none",
             activation="LeakyReLU", use_spect=True):
    """Discriminator factory (networks.py:498-503; the AE engine uses ndf 32,
    img_f 128)."""
    return ResDiscriminator(input_nc, ndf, img_f, layers, norm, activation, use_spect)
