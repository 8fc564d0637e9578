"""Model registry (parity: CC/clustercontrast/models/__init__.py)."""

from .resnet import (
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


__all__ = ["ReIDResNet", "ResNetBackbone", "create", "names"]
