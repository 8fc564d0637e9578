"""Model registry (parity: CC/clustercontrast/models/__init__.py and
FD/reid/models/__init__.py:19-52)."""

from .embedding import EltwiseSubEmbed
from .multi_branch import SiameseNet, siamese_baseline
from .resnet import (
    FDResNet,
    ReIDResNet,
    ResNetBackbone,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
)

__factory = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
}


def names():
    return sorted(__factory.keys())


def create(name, *args, **kwargs):
    """Create a model by name (an ``nn.Module`` in fp32 on the CPU)."""
    if name not in __factory:
        raise KeyError(f"Unknown model: {name}")
    return __factory[name](*args, **kwargs)


__all__ = ["EltwiseSubEmbed", "FDResNet", "ReIDResNet", "ResNetBackbone", "SiameseNet",
           "create", "names", "siamese_baseline"]
