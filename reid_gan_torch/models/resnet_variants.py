"""Backbone variants: bi-path and multi-part ResNets (port of
``reid_gan_tpu/models/resnet_variants.py``; parity:
CC/clustercontrast/models/{resnet_bip,resnet_bipd,resnet_mp}.py).

Module names mirror the JAX package's scopes (``base``, ``p1_l3``,
``res_g``, ``gpool_p1``, ``feat_bn_g``, ``predictor.fc1``, ...), so
``convert.variant_state_dict_from_jax`` maps one tree onto the other by
name. The port's conventions hold: in eval a model returns its feature
tensor, or with ``test_all`` (``ResNetBipD``, ``ResNetMP``) a dict with its
GAN map; in train it takes ``with_gan_feat`` and returns a dict with
``'feat'``. Every GeM with a learned p runs through kernel K5 (forward and
backward); an eval head of GeM → scale-only BN on running stats → L2 is
kernel K2; ``ResNetBipD``'s GAN map is kernel K11.
"""

import math

import torch
from torch import nn

from .pooling import build_pooling_layer, eval_l2_head, l2n
from .resnet import STAGES, ResNetBackbone, _init_convs, gan_feat, make_stage


def _feat_bn(dim):
    """The scale-only BatchNorm of a head: bias frozen at zero, as the JAX
    package's ``use_bias=False``."""
    bn = nn.BatchNorm1d(dim)
    bn.bias.requires_grad_(False)
    return bn


def part_map(fmap, lo, hi):
    """Rows ``lo:hi`` of an (N, C, H, W) map as a map of its own, channels_last
    and contiguous: a row slice of a channels_last map is contiguous in
    neither format for N > 1, and K5 reads a contiguous one."""
    return fmap[:, :, lo:hi].contiguous(memory_format=torch.channels_last)


def _fp32(fmap):
    """A branch's last map in fp32, as the JAX variants cast it
    (``.astype(jnp.float32)``): a bf16 map is widened, an fp64 one (the
    parity tests) rounded; the heads then promote it to their parameters'
    dtype, as jnp does."""
    return fmap.to(torch.float32)


def _pool_bn(gap, bn, fmap):
    return bn(gap(fmap).to(bn.weight.dtype))


class ResNetStage(nn.Sequential):
    """One ``layer{stage}`` group of blocks, for the duplicated branches
    (resnet_variants.py:18-35): children ``0``, ``1``, ..., the first block
    with ``stride``."""

    def __init__(self, depth=50, stage=4, stride=2):
        super().__init__(*make_stage(depth, stage, stride))
        block, _ = STAGES[depth]
        self.out_channels = (64, 128, 256, 512)[stage - 1] * block.expansion
        _init_convs(self)


class _BiPath(nn.Module):
    """A shared stem through stage 2 and two layer3/layer4 branches
    ``p1``, ``p2`` (layer3 stride 2, layer4 stride 1)."""

    def __init__(self, depth):
        super().__init__()
        self.base = ResNetBackbone(depth, stop_at_stage=2)
        self.p1_l3 = ResNetStage(depth, 3, 2)
        self.p1_l4 = ResNetStage(depth, 4, 1)
        self.p2_l3 = ResNetStage(depth, 3, 2)
        self.p2_l4 = ResNetStage(depth, 4, 1)
        self.out_channels = self.p1_l4.out_channels

    def branches(self, x):
        stem = self.base(x)
        return _fp32(self.p1_l4(self.p1_l3(stem))), _fp32(self.p2_l4(self.p2_l3(stem)))


def _refuse_features(name, num_features):
    if num_features > 0:
        raise NotImplementedError(
            f"{name} with --features > 0: the reference's embedding branch "
            "crashes as shipped (resnet_bip.py:59-67 builds feat_bn but the "
            "forward reads feat_bn1/feat_bn2); use --features 0")


class ResNetBip(_BiPath):
    """Duplicated layer3/4 branches over a shared stem, fused
    α·bn_x1 + (1-α)·bn_x2 or a dual output (resnet_variants.py:38-88;
    CC/clustercontrast/models/resnet_bip.py:40-45,90-130).

    Eval: the fused feature (N, D), or ``(feat, feat2)`` with
    ``fuse=False``; with ``norm`` each branch's head is kernel K2. Train:
    ``{'feat'}`` (fused) or ``{'feat', 'feat2'}``. ``dropout`` is accepted
    and unused, as in the JAX class; ``num_features > 0`` raises (the
    reference's own fault)."""

    def __init__(self, depth=50, norm=True, dropout=0.0, pooling_type="gem",
                 num_features=0):
        _refuse_features("resnet_bip*", num_features)
        super().__init__(depth)
        self.norm = norm
        self.gap1 = build_pooling_layer(pooling_type)
        self.gap2 = build_pooling_layer(pooling_type)
        self.feat_bn1 = _feat_bn(self.out_channels)
        self.feat_bn2 = _feat_bn(self.out_channels)

    def forward(self, x, fuse=True, output_balance=1.0, with_gan_feat=True):
        x1, x2 = self.branches(x)
        if not self.training and self.norm:
            f1 = eval_l2_head(x1, self.gap1, self.feat_bn1)
            f2 = eval_l2_head(x2, self.gap2, self.feat_bn2)
        else:
            f1 = _pool_bn(self.gap1, self.feat_bn1, x1)
            f2 = _pool_bn(self.gap2, self.feat_bn2, x2)
            if self.norm:
                f1, f2 = l2n(f1), l2n(f2)
        if fuse:
            f = output_balance * f1 + (1 - output_balance) * f2
            if self.norm:
                f = l2n(f)
            return {"feat": f} if self.training else f
        return {"feat": f1, "feat2": f2} if self.training else (f1, f2)


class ResNetBipD(_BiPath):
    """Bi-path with decoupled outputs: p1 → the pooled id vector, p2 → the
    spatial GAN map (resnet_variants.py:91-128; resnet_bipd.py:97-138).

    Eval: the L2-normalised ``feat_bn`` output (kernel K2); with
    ``test_all``, ``{'feat', 'gan_feat'}``. Train: ``{'feat'}``,
    L2-normalised with ``norm``, and with ``with_gan_feat`` ``gan_feat``.
    ``gan_feat`` is the channel-L2 map of p2 (kernel K11, detached as
    ``resnet.gan_feat``)."""

    def __init__(self, depth=50, norm=True, dropout=0.0, pooling_type="gem",
                 num_features=0):
        _refuse_features("resnet_bipd", num_features)
        super().__init__(depth)
        self.norm = norm
        self.gap = build_pooling_layer(pooling_type)
        self.feat_bn = _feat_bn(self.out_channels)

    def forward(self, x, with_gan_feat=True, test_all=False):
        x1, x2 = self.branches(x)
        if not self.training:
            feat = eval_l2_head(x1, self.gap, self.feat_bn)
            return {"feat": feat, "gan_feat": gan_feat(x2)} if test_all else feat
        f = _pool_bn(self.gap, self.feat_bn, x1)
        out = {"feat": l2n(f) if self.norm else f}
        if with_gan_feat:
            out["gan_feat"] = gan_feat(x2)
        return out


class PredictorMLP(nn.Module):
    """SimSiam-style two-layer predictor (resnet_variants.py:131-143;
    resnet_mp.py:177-197): Linear(dim → 2·dim, no bias) → BatchNorm1d →
    ReLU → Linear(2·dim → dim, no bias)."""

    def __init__(self, dim=2048):
        super().__init__()
        self.fc1 = nn.Linear(dim, 2 * dim, bias=False)
        self.bn1 = nn.BatchNorm1d(2 * dim)
        self.fc2 = nn.Linear(2 * dim, dim, bias=False)
        for fc in (self.fc1, self.fc2):   # flax Dense's LeCun normal
            nn.init.normal_(fc.weight, std=1.0 / math.sqrt(fc.in_features))

    def forward(self, x):
        return self.fc2(torch.relu(self.bn1(self.fc1(x))))


class ResNetMP(nn.Module):
    """Multi-part backbone: a global branch (layer4 at stride 2) and an
    upper/lower part branch (layer4 at stride 1) over a stem through stage
    3, ``sum``, ``cat`` or plain fusion, and a 1×1 GAN projection
    (resnet_variants.py:146-232; resnet_mp.py:85-158).

    Eval: the fused feature (N, D); with ``test_all``, ``{'feat',
    'gan_feat', 'feat_g'}``. Train: ``{'feat', 'feat_g', 'feat_p1',
    'feat_p2'}``, with ``with_gan_feat`` the projected map ``gan_feat``
    (N, num_proj, H, W), and with ``need_predictor`` the predictor's output
    ``pred``. The predictor's parameters exist in eval mode too, so
    checkpoints round-trip. Each part map is copied to a contiguous
    channels_last map for K5 (``part_map``). ``num_features`` and
    ``dropout`` are accepted and ignored, as the reference ignores them."""

    def __init__(self, depth=50, norm=True, dropout=0.0, num_proj=256, fusion="sum",
                 need_predictor=False, pooling_type="gem", num_features=0):
        super().__init__()
        self.norm = norm
        self.fusion = fusion
        self.base = ResNetBackbone(depth, stop_at_stage=3)
        self.res_g = ResNetStage(depth, 4, 2)
        self.res_p = ResNetStage(depth, 4, 1)
        nfeat = self.res_g.out_channels
        for name in ("gpool_g", "gpool_p1", "gpool_p2"):
            setattr(self, name, build_pooling_layer(pooling_type))
        for name in ("feat_bn_g", "feat_bn_p1", "feat_bn_p2"):
            setattr(self, name, _feat_bn(nfeat))
        if fusion == "cat":
            for name, width in (("fc_id_g", nfeat // 2), ("fc_id_p1", nfeat // 4),
                                ("fc_id_p2", nfeat // 4)):
                fc = nn.Linear(nfeat, width, bias=False)
                nn.init.kaiming_normal_(fc.weight, mode="fan_out", nonlinearity="relu")
                setattr(self, name, fc)
        self.proj_gan = nn.Conv2d(nfeat, num_proj, 1, bias=False)
        nn.init.kaiming_normal_(self.proj_gan.weight, mode="fan_out", nonlinearity="relu")
        self.predictor = PredictorMLP(nfeat) if need_predictor else None

    def forward(self, x, with_gan_feat=True, test_all=False):
        stem = self.base(x)
        x_g, x_p = _fp32(self.res_g(stem)), _fp32(self.res_p(stem))
        div = x_p.shape[2] // 2
        x_g = _pool_bn(self.gpool_g, self.feat_bn_g, x_g)
        x_p1 = _pool_bn(self.gpool_p1, self.feat_bn_p1, part_map(x_p, 0, div))
        x_p2 = _pool_bn(self.gpool_p2, self.feat_bn_p2, part_map(x_p, div, x_p.shape[2]))
        if self.fusion == "cat":
            x_gc = torch.cat([self.fc_id_g(x_g), self.fc_id_p1(x_p1),
                              self.fc_id_p2(x_p2)], dim=1)
        elif self.fusion == "sum":
            x_gc = x_g + x_p1 + x_p2
        else:
            x_gc = x_g
        f_gc = l2n(x_gc) if self.norm else x_gc
        if not self.training and not test_all:
            return f_gc
        gan = self.proj_gan(x_p.to(self.proj_gan.weight.dtype)) \
            if with_gan_feat or test_all else None
        if not self.training:
            return {"feat": f_gc, "gan_feat": gan,
                    "feat_g": l2n(x_g) if self.norm else x_g}
        parts = (x_g, x_p1, x_p2)
        f_g, f_p1, f_p2 = map(l2n, parts) if self.norm else parts
        out = {"feat": f_gc, "feat_g": f_g, "feat_p1": f_p1, "feat_p2": f_p2}
        if gan is not None:
            out["gan_feat"] = gan
        if self.predictor is not None:
            out["pred"] = self.predictor(f_gc)
        return out


def resnet_bip50(**kw):
    return ResNetBip(depth=50, **kw)


def resnet_bipd50(**kw):
    return ResNetBipD(depth=50, **kw)


def resnet_mp50(**kw):
    return ResNetMP(depth=50, **kw)
