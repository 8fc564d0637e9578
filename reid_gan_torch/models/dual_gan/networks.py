"""The generators and the discriminator of the joint recipe (port of
``reid_gan_tpu/models/dual_gan/networks.py`` ``PoseGenerator1``,
``AEGenerator``, ``ResDiscriminator``, ``define_G`` and ``define_D``;
parity: CC/dual_gan/models/networks.py:278-355,639-738,917-956).

NCHW in and out. Module names follow the flax modules (``block0``,
``encoder{i}``, ``feature_block``, ``PCTM``, ``decoder{i}``, ``outconv``;
``block0``, ``encoders_{i}``, ``mblocks_{i}``, ``decoder.decoder{i}``,
``decoder.outconv``; ``block0``, ``encoder{i}``, ``conv``), so ``convert.py``
maps a JAX tree onto a ``state_dict`` path by path.
"""

from torch import nn

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
)
from .ptm import PCTM


def _enc_mults(ngf, img_f, layers):
    mults = [1]
    for i in range(layers - 1):
        mults.append(min(2 ** (i + 1), img_f // ngf))
    return mults


def _dec_mults(ngf, img_f, layers):
    return [min(2 ** (layers - i - 2), img_f // ngf) if i != layers - 1 else 1
            for i in range(layers)]


class PoseGenerator1(nn.Module):
    """Pose-map encoder + 1×1 re-ID adapter + PCTM + decoder with U-Net skip
    adds (networks.py:254-303). ``reid_f``: the spatial (N, reid_nc, H/8,
    W/8) GAN map; ``source_pose``: (N, pose_nc, H, W) maps → (N, 3, H, W)
    in [-1, 1]."""

    def __init__(self, ngf=64, pose_nc=18, img_f=256, layers=3, norm="batch",
                 activation="LeakyReLU", use_spect=False, output_nc=3, affine=True,
                 nhead=2, num_CABs=2, num_TTBs=2, reid_nc=2048):
        super().__init__()
        mults = _enc_mults(ngf, img_f, layers)
        self.block0 = EncoderBlockOptimized(pose_nc, ngf, norm, activation, use_spect)
        for i, m in enumerate(mults[1:]):
            self.add_module(f"encoder{i}", EncoderBlock(
                ngf * mults[i], ngf * m, norm, activation, use_spect))
        d_model = ngf * mults[-1]
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


class _Decoder(nn.Module):
    """The shared decoder stack: ``layers`` ResBlockDecoders (×2 each) and
    the Output block (networks.py:101-125, without skip adds)."""

    def __init__(self, ngf=64, img_f=256, layers=3, output_nc=3, norm="batch",
                 activation="LeakyReLU", use_spect=False):
        super().__init__()
        cin = ngf * min(2 ** (layers - 1), img_f // ngf)
        for i, m in enumerate(_dec_mults(ngf, img_f, layers)):
            self.add_module(f"decoder{i}", ResBlockDecoder(
                cin, ngf * m, ngf * m, norm, activation, use_spect))
            cin = ngf * m
        self.outconv = Output(cin, output_nc, 3, "none", activation, use_spect)
        self.layers = layers

    def forward(self, feature):
        for i in range(self.layers):
            feature = getattr(self, f"decoder{i}")(feature)
        return self.outconv(feature)


class AEGenerator(nn.Module):
    """The autoencoder generator of the AE hard-mix mode and the GAN
    warm-up, with the encoder and the decoder callable apart
    (networks.py:128-173): ``forward_enc`` (N, 3, H, W) → (N, ngf·4, H/8,
    W/8) features, ``forward_dec`` back to (N, 3, H, W) in [-1, 1]. The
    decoder starts with the recipe's 3 mid ResBlocks (ae_model.py:63-85)."""

    num_blocks = 3

    def __init__(self, image_nc=3, ngf=64, img_f=256, layers=3, norm="batch",
                 activation="LeakyReLU", use_spect=False, output_nc=3):
        super().__init__()
        mults = _enc_mults(ngf, img_f, layers)
        self.block0 = EncoderBlockOptimized(image_nc, ngf, norm, activation, use_spect)
        for i, m in enumerate(mults[1:]):
            self.add_module(f"encoders_{i}", EncoderBlock(
                ngf * mults[i], ngf * m, norm, activation, use_spect))
        for i in range(self.num_blocks):
            self.add_module(f"mblocks_{i}", ResBlock(
                ngf * mults[-1], ngf * mults[-1], norm=norm, activation=activation,
                use_spect=use_spect))
        self.decoder = _Decoder(ngf, img_f, layers, output_nc, norm, activation,
                                use_spect)
        self.num_encoders = layers - 1

    def forward(self, inputs):
        return self.forward_dec(self.forward_enc(inputs))

    def forward_enc(self, source):
        f = self.block0(source)
        for i in range(self.num_encoders):
            f = getattr(self, f"encoders_{i}")(f)
        return f

    def forward_dec(self, feature):
        for i in range(self.num_blocks):
            feature = getattr(self, f"mblocks_{i}")(feature)
        return self.decoder(feature)


class ResDiscriminator(nn.Module):
    """Spectral-norm residual discriminator (networks.py:432-461): (N, 3, H,
    W) → (N, 1, H/2^layers, W/2^layers) scores."""

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
        out = self.block0(x)
        for i in range(self.layers - 1):
            out = getattr(self, f"encoder{i}")(out)
        return self.conv(self.act(out))


def define_G(model_gen="Pose", image_nc=3, pose_nc=18, ngf=64, img_f=256,
             encoder_layer=3, norm="batch", activation="LeakyReLU",
             use_spect=False, output_nc=3, affine=True, nhead=2,
             num_CABs=2, num_TTBs=2, reid_nc=2048):
    """Generator factory (networks.py:464-495). The pose generator of the
    joint recipe and the AE generator are ported."""
    if model_gen == "Pose":
        return PoseGenerator1(ngf, pose_nc, img_f, encoder_layer, norm, activation,
                              use_spect, output_nc, affine, nhead, num_CABs,
                              num_TTBs, reid_nc)
    if model_gen == "AE":
        return AEGenerator(image_nc, ngf, img_f, encoder_layer, norm, activation,
                           use_spect, output_nc)
    if model_gen in ("DEC", "FD", "PoseAE", "DPTN"):
        raise NotImplementedError(
            f"generator {model_gen!r} is not ported yet (ROADMAP A5); the port "
            "runs --model-gen Pose and AE")
    raise ValueError(f"generator {model_gen} not implemented")


def define_D(input_nc=3, ndf=32, img_f=128, layers=3, norm="none",
             activation="LeakyReLU", use_spect=True):
    """Discriminator factory (networks.py:498-503; the AE engine uses ndf 32,
    img_f 128)."""
    return ResDiscriminator(input_nc, ndf, img_f, layers, norm, activation, use_spect)
