"""ResNet re-ID backbone (port of ``reid_gan_tpu/models/resnet.py``).

torchvision key names (``conv1``, ``bn1``, ``layerI.J.convK``,
``layerI.J.downsample.{0,1}``) plus ``gap.p``, ``feat.*``, ``feat_bn.*`` and
``classifier.weight``, so a ``state_dict()`` of this model is what
``reid_gan_tpu.models.resnet.import_torch_resnet`` reads and what
``convert.resnet_state_dict_from_jax`` writes. The IBN-a encoders
(``resnet_ibn50a``, ``resnet_ibn101a``; CC/clustercontrast/models/
resnet_ibn_a.py:22-105) split the ``bn1`` of every block of stages 1-3 into
``bn1.IN`` and ``bn1.BN``, the layout of the reference's checkpoints. ``nn.BatchNorm2d`` already has
the semantics of the JAX package's ``TorchBatchNorm``: in eval mode it
normalises with the running stats; in train mode with the biased batch
variance, and it stores the unbiased one with torch momentum 0.1 (flax
0.9). So that module needs no port.

``ReIDResNet`` is the CC re-ID model (CC/clustercontrast/models/resnet.py:
14-127): last-stride 1, GeM pooling with a trainable ``p``, a scale-only
``feat_bn`` (bias frozen at zero, resnet.py:61). Eval: an L2-normalised
feature; with GeM and no embedding layer (the recipe's default) the whole
eval head is kernel K2 (``pooling.gem_bn_l2n``). Train
(``resnet.py:177-219``): GeM with its gradient (kernel K5,
``pooling.gem_pool``) → ``feat`` → ``feat_bn`` on batch stats → L2 (``norm``)
or ReLU → dropout → ``prob``; beside it the detached ``gan_feat`` map that
conditions the pose generator (kernel K11, ``gan_feat``).
"""

import torch
from torch import nn

from ..kernels import GAN_FEAT_L2N
from .pooling import build_pooling_layer, eval_l2_head, l2n
from .precision import BatchNorm2d, Conv2d, widen


def _conv(cin, cout, k, stride=1):
    return Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)


class IBN(nn.Module):
    """Instance-Batch Norm split (resnet.py:38-51; resnet_ibn_a.py:54-67):
    the first half of the channels through instance norm with an affine
    scale and shift (the JAX package's one-channel-a-group ``GroupNorm``,
    eps 1e-5; no running stats, so train and eval normalise alike), the
    second half through BatchNorm, concatenated. The output keeps the
    input's memory format: a channels_last block stays channels_last. Both
    halves normalise the input widened to fp32, as the JAX package's
    ``GroupNorm`` and ``TorchBatchNorm`` do under ``--fp16``."""

    def __init__(self, planes):
        super().__init__()
        self.half = planes // 2
        self.IN = nn.InstanceNorm2d(self.half, eps=1e-5, affine=True,
                                    track_running_stats=False)
        self.BN = nn.BatchNorm2d(planes - self.half)

    def forward(self, x):
        x = widen(x)
        # torch.cat and the copy back to channels_last, not writes of the
        # halves into one output: the writes save a pass forward but their
        # backward costs more (PERF.md §6, the IBN-a entry)
        out = torch.cat([self.IN(x[:, :self.half]), self.BN(x[:, self.half:])], 1)
        if x.is_contiguous(memory_format=torch.channels_last):
            return out.contiguous(memory_format=torch.channels_last)
        return out


def _bn1(planes, ibn):
    return IBN(planes) if ibn else BatchNorm2d(planes)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, ibn=False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = _bn1(planes, ibn)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(_conv(inplanes, planes, 1, stride),
                                            BatchNorm2d(planes))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, ibn=False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = _bn1(planes, ibn)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = _conv(planes, out, 1)
        self.bn3 = BatchNorm2d(out)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = nn.Sequential(_conv(inplanes, out, 1, stride),
                                            BatchNorm2d(out))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + residual)


STAGES = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


def _init_convs(module):
    for m in module.modules():
        if isinstance(m, nn.Conv2d):   # conv_kaiming of the JAX package
            nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu")


def make_stage(depth, stage, stride, ibn=False):
    """The blocks of ``layer{stage}`` (1-based) as an ``nn.Sequential``
    (children ``0``, ``1``, ...), the first with ``stride``; IBN in every
    block's ``bn1`` when ``ibn``."""
    block, sizes = STAGES[depth]
    planes = (64, 128, 256, 512)[stage - 1]
    inplanes = 64 if stage == 1 else planes // 2 * block.expansion
    blocks = []
    for j in range(sizes[stage - 1]):
        blocks.append(block(inplanes, planes, stride if j == 0 else 1, ibn))
        inplanes = planes * block.expansion
    return nn.Sequential(*blocks)


class ResNetBackbone(nn.Module):
    """conv1 → maxpool → layer1..``stop_at_stage`` (NCHW in, NCHW out);
    IBN-a in stages 1-3 with ``ibn`` (stage 4 never has it, resnet.py:146).
    Under a bf16 compute dtype (``precision.set_compute_dtype``, the
    ``--fp16`` flag) conv1 casts the input to bf16 (resnet.py:137-138), each
    convolution runs in bf16 and each BatchNorm reduces in and emits fp32,
    so the map leaves in fp32."""

    def __init__(self, depth=50, last_stride=1, ibn=False, stop_at_stage=4):
        super().__init__()
        self.stop_at_stage = stop_at_stage
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        for i in range(stop_at_stage):
            stride = 1 if i == 0 else (last_stride if i == 3 else 2)
            setattr(self, f"layer{i + 1}", make_stage(depth, i + 1, stride, ibn and i < 3))
        block, _ = STAGES[depth]
        self.out_channels = (64, 128, 256, 512)[stop_at_stage - 1] * block.expansion
        _init_convs(self)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for i in range(self.stop_at_stage):
            x = getattr(self, f"layer{i + 1}")(x)
        return x


class ReIDResNet(ResNetBackbone):
    """Eval: (N, 3, H, W) → (N, D) L2-normalised ``feat_bn`` output; with
    ``test_all``, ``{'feat', 'gan_feat'}`` (``resnet.py:201-205``).
    Train: ``{'feat', 'gan_feat'}`` (+ ``'prob'``), as ``resnet.py:208-219``."""

    def __init__(self, depth=50, ibn=False, num_features=0, norm=False, dropout=0.0,
                 num_classes=0, pooling_type="gem", last_stride=1):
        super().__init__(depth, last_stride, ibn)
        self.gap = build_pooling_layer(pooling_type)
        dim = self.out_channels
        self.num_features = num_features
        self.norm = norm
        if num_features > 0:
            self.feat = nn.Linear(dim, num_features)
            nn.init.kaiming_normal_(self.feat.weight, mode="fan_out")
            nn.init.zeros_(self.feat.bias)
            dim = num_features
        self.feat_bn = nn.BatchNorm1d(dim)
        self.feat_bn.bias.requires_grad_(False)   # frozen at zero
        self.drop = nn.Dropout(dropout) if dropout > 0 else None
        self.classifier = None
        if num_classes > 0:
            self.classifier = nn.Linear(dim, num_classes, bias=False)
            nn.init.normal_(self.classifier.weight, std=0.001)

    def forward(self, x, with_gan_feat=True, test_all=False):
        fmap = super().forward(x)
        # the heads run in (at least) fp32, as resnet.py:183 upcasts
        fmap = fmap.to(torch.promote_types(fmap.dtype, torch.float32))
        if not self.training:
            if self.num_features == 0:
                feat = eval_l2_head(fmap, self.gap, self.feat_bn)
            else:
                feat = l2n(self.feat_bn(self.feat(self.gap(fmap))))
            return {"feat": feat, "gan_feat": gan_feat(fmap)} if test_all else feat
        out = {"feat": self._train_head(fmap)}
        if with_gan_feat:
            out["gan_feat"] = gan_feat(fmap)
        if self.classifier is not None:
            out["prob"] = self.classifier(out["feat"])
        return out

    def _train_head(self, fmap):
        z = self.gap(fmap)
        if self.num_features > 0:
            z = self.feat(z)
        z = self.feat_bn(z)
        if self.norm:
            z = l2n(z)
        elif self.num_features > 0:
            z = torch.relu(z)
        if self.drop is not None:
            z = self.drop(z)
        return z


class FDResNet(ResNetBackbone):
    """FD-GAN's backbone head (``reid_gan_tpu/models/resnet.py:222-254``;
    parity: FD/reid/models/resnet.py:65-88): ResNet with last stride 2, the
    spatial mean of layer4 (a plain ``torch.mean``, as the JAX package
    leaves it to XLA); ``cut_at_pooling`` returns the pooled vector, else
    the optional ``feat`` → ``feat_bn`` → L2 (``norm``) or ReLU → dropout →
    ``classifier`` head. (N, 3, H, W) → (N, D)."""

    def __init__(self, depth=50, num_features=0, norm=False, dropout=0.0,
                 num_classes=0, cut_at_pooling=False):
        super().__init__(depth, last_stride=2)
        self.cut_at_pooling = cut_at_pooling
        self.norm = norm
        self.num_features = num_features
        dim = self.out_channels
        if not cut_at_pooling and num_features > 0:
            self.feat = nn.Linear(dim, num_features)
            nn.init.kaiming_normal_(self.feat.weight, mode="fan_out", nonlinearity="relu")
            nn.init.zeros_(self.feat.bias)
            self.feat_bn = nn.BatchNorm1d(num_features)
            dim = num_features
        self.drop = nn.Dropout(dropout) if not cut_at_pooling and dropout > 0 else None
        self.classifier = None
        if not cut_at_pooling and num_classes > 0:
            self.classifier = nn.Linear(dim, num_classes)
            nn.init.normal_(self.classifier.weight, std=0.001)
            nn.init.zeros_(self.classifier.bias)

    def forward(self, x):
        y = torch.mean(super().forward(x), dim=(2, 3))
        if self.cut_at_pooling:
            return y
        if self.num_features > 0:
            y = self.feat_bn(self.feat(y))
        if self.norm:
            y = l2n(y)
        elif self.num_features > 0:
            y = torch.relu(y)
        if self.drop is not None:
            y = self.drop(y)
        if self.classifier is not None:
            y = self.classifier(y)
        return y


def gan_feat_plain(fmap):
    """Plain PyTorch version of K11: the per-position channel-L2 map of an
    (N, C, H, W) map, ``x / (sqrt(sum_c x²) + 1e-12)`` (resnet.py:186-187)."""
    return fmap * torch.reciprocal(
        torch.sqrt(torch.sum(fmap * fmap, dim=1, keepdim=True)) + 1e-12)


def _gan_feat_cuda(fmap):
    if fmap.dtype != torch.float32 or fmap.dim() != 4 or \
            not fmap.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"gan_feat takes a channels_last (N, C, H, W) float32 map, "
                         f"got {tuple(fmap.shape)} {fmap.dtype}")
    n, c, h, w = fmap.shape
    out = torch.empty_like(fmap, memory_format=torch.channels_last)
    vec = int(c % 4 == 0 and fmap.data_ptr() % 16 == 0)
    GAN_FEAT_L2N(fmap.data_ptr(), out.data_ptr(), n * h * w, c, vec,
                 device=fmap.device)
    return out


def gan_feat(fmap):
    """The GAN branch's conditioning map (resnet.py:186-187), NCHW, detached
    (kernel K11 on the card, forward only). No mode of the joint trainer
    differentiates it: ``train_all`` detaches it before the generator and
    pulls back zeros (gan_trainers.py:181,233), the other modes discard it."""
    fmap = fmap.detach()
    if fmap.is_cuda:
        return _gan_feat_cuda(fmap)
    if fmap.device.type != "cpu":
        raise ValueError(f"gan_feat: unsupported device {fmap.device}")
    return gan_feat_plain(fmap)


def resnet18(**kw):
    return ReIDResNet(depth=18, **kw)


def resnet34(**kw):
    return ReIDResNet(depth=34, **kw)


def resnet50(**kw):
    return ReIDResNet(depth=50, **kw)


def resnet101(**kw):
    return ReIDResNet(depth=101, **kw)


def resnet152(**kw):
    return ReIDResNet(depth=152, **kw)


def resnet_ibn50a(**kw):
    return ReIDResNet(depth=50, ibn=True, **kw)


def resnet_ibn101a(**kw):
    return ReIDResNet(depth=101, ibn=True, **kw)
