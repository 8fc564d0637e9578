"""GAN-engine factory with the per-model option defaults, and the VGG19
weights loader (port of ``reid_gan_tpu/models/dual_gan/models.py``; parity:
CC/dual_gan/models/__init__.py:7-31, models.py:4-22)."""

import torch

from .ae_model import AEModel
from .dptn_model import DPTNModel
from .external_function import import_torch_vgg19, random_vgg19

_MODELS = {"AE": AEModel, "DPTN": DPTNModel}

# the reference's modify_options defaults (AE_model.py:19-46, DPTN_model.py)
_MODEL_DEFAULTS = {
    "AE": {"lambda_rec": 2.0, "lambda_g": 5.0, "lambda_style": 500.0,
           "lambda_content": 0.5, "ratio_g2d": 0.1},
    "DPTN": {"lambda_rec": 2.5, "lambda_g": 2.0, "lambda_style": 500.0,
             "lambda_content": 0.5, "ratio_g2d": 0.1},
}


def find_model_using_name(name):
    if name not in _MODELS:
        raise KeyError(f"unknown dual_gan model {name}; options: {list(_MODELS)}")
    return _MODELS[name]


def get_option_setter(name):
    """A function that applies the model's option defaults to a GANConfig,
    overriding only the fields left at the dataclass default."""
    defaults = _MODEL_DEFAULTS.get(name, {})

    def apply(cfg):
        from ...config import GANConfig

        base = GANConfig()
        for field, val in defaults.items():
            if getattr(cfg, field) == getattr(base, field):
                setattr(cfg, field, val)
        return cfg

    return apply


def load_vgg_params(path):
    """A torchvision vgg19 ``.pth`` (a state dict, or an object with
    ``.state_dict()``) → a ``VGG19`` state dict (models.py:47-62): its convs
    by ``import_torch_vgg19``, any conv the file lacks from
    ``random_vgg19(0)`` (the JAX loader's is its init from key 0). Nothing
    is downloaded."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    vgg = random_vgg19(0)
    vgg.load_state_dict(import_torch_vgg19(sd), strict=False)
    return vgg.state_dict()


def create_model(cfg, **kwargs):
    """Instantiate the engine named by ``cfg.model`` (models.py:65-74), with
    the VGG19 weights of ``cfg.vgg_weights`` where ``use_vgg`` asks for them
    and the caller passed none."""
    cls = find_model_using_name(cfg.model)
    get_option_setter(cfg.model)(cfg)
    if cfg.use_vgg and cfg.vgg_weights and "vgg_params" not in kwargs:
        kwargs["vgg_params"] = load_vgg_params(cfg.vgg_weights)
    model = cls(cfg, **kwargs)
    print(f"model [{cls.__name__}] was created")
    return model
