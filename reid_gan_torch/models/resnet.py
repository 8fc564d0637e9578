"""ResNet re-ID backbone (port of ``reid_gan_tpu/models/resnet.py``).

torchvision key names (``conv1``, ``bn1``, ``layerI.J.convK``,
``layerI.J.downsample.{0,1}``) plus ``gap.p``, ``feat.*``, ``feat_bn.*`` and
``classifier.weight``, so a ``state_dict()`` of this model is what
``reid_gan_tpu.models.resnet.import_torch_resnet`` reads and what
``convert.resnet_state_dict_from_jax`` writes. ``nn.BatchNorm2d`` already has
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
from .pooling import GeneralizedMeanPooling, build_pooling_layer, gem_bn_l2n, l2n


def _conv(cin, cout, k, stride=1):
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = nn.BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(_conv(inplanes, planes, 1, stride),
                                            nn.BatchNorm2d(planes))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = _conv(planes, out, 1)
        self.bn3 = nn.BatchNorm2d(out)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = nn.Sequential(_conv(inplanes, out, 1, stride),
                                            nn.BatchNorm2d(out))

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


class ResNetBackbone(nn.Module):
    """conv1 → maxpool → layer1..4 (NCHW in, NCHW out)."""

    def __init__(self, depth=50, last_stride=1):
        super().__init__()
        block, sizes = STAGES[depth]
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for i, planes in enumerate((64, 128, 256, 512)):
            stride = 1 if i == 0 else (last_stride if i == 3 else 2)
            blocks = []
            for j in range(sizes[i]):
                blocks.append(block(inplanes, planes, stride if j == 0 else 1))
                inplanes = planes * block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.out_channels = inplanes
        for m in self.modules():
            if isinstance(m, nn.Conv2d):   # conv_kaiming of the JAX package
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu")

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


class ReIDResNet(ResNetBackbone):
    """Eval: (N, 3, H, W) → (N, D) L2-normalised ``feat_bn`` output.
    Train: ``{'feat', 'gan_feat'}`` (+ ``'prob'``), as ``resnet.py:208-219``."""

    def __init__(self, depth=50, num_features=0, norm=False, dropout=0.0,
                 num_classes=0, pooling_type="gem", last_stride=1):
        super().__init__(depth, last_stride)
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
        self._fused_head = (isinstance(self.gap, GeneralizedMeanPooling)
                            and isinstance(self.gap.p, nn.Parameter)
                            and num_features == 0)

    def forward(self, x, with_gan_feat=True):
        fmap = super().forward(x)
        # the heads run in (at least) fp32, as resnet.py:183 upcasts
        fmap = fmap.to(torch.promote_types(fmap.dtype, torch.float32))
        if not self.training:
            if self._fused_head:
                bn = self.feat_bn
                return gem_bn_l2n(fmap, self.gap.p, bn.weight, bn.running_mean,
                                  bn.running_var, self.gap.eps, bn.eps)
            z = self.gap(fmap)
            if self.num_features > 0:
                z = self.feat(z)
            return l2n(self.feat_bn(z))
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
