"""Model registry (parity: CC/clustercontrast/models/__init__.py and
FD/reid/models/__init__.py:19-52)."""

from .embedding import EltwiseSubEmbed
from .multi_branch import SiameseNet, siamese_baseline
from .precision import set_compute_dtype
from .resnet import (
    FDResNet,
    ReIDResNet,
    ResNetBackbone,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
    resnet_ibn50a,
    resnet_ibn101a,
)
from .resnet_variants import (
    PredictorMLP,
    ResNetBip,
    ResNetBipD,
    ResNetMP,
    resnet_bip50,
    resnet_bipd50,
    resnet_mp50,
)

__factory = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
    "resnet_ibn50a": resnet_ibn50a,
    "resnet_ibn101a": resnet_ibn101a,
    "resnet_bip50": resnet_bip50,
    "resnet_bipd50": resnet_bipd50,
    "resnet_mp50": resnet_mp50,
}


def names():
    return sorted(__factory.keys())


def create(name, *args, dtype=None, **kwargs):
    """Create a model by name (an ``nn.Module`` in fp32 on the CPU). With
    ``dtype=torch.bfloat16`` (``--fp16``) the backbone computes in bf16 as
    the JAX package's ``dtype=jnp.bfloat16`` does (``precision.py``): its
    convolutions in bf16, its BatchNorms and the heads in fp32, the
    parameters fp32."""
    if name not in __factory:
        raise KeyError(f"Unknown model: {name}")
    return set_compute_dtype(__factory[name](*args, **kwargs), dtype)


__all__ = ["EltwiseSubEmbed", "FDResNet", "PredictorMLP", "ReIDResNet", "ResNetBackbone",
           "ResNetBip", "ResNetBipD", "ResNetMP", "SiameseNet", "create", "names",
           "siamese_baseline"]
