"""GAN-engine factory with the per-model option defaults (port of
``reid_gan_tpu/models/dual_gan/models.py:16-44,65-74``; parity:
CC/dual_gan/models/__init__.py:7-31, models.py:4-22)."""

from .ae_model import AEModel

_MODELS = {"AE": AEModel}

# the reference's modify_options defaults (AE_model.py:19-46)
_MODEL_DEFAULTS = {
    "AE": {"lambda_rec": 2.0, "lambda_g": 5.0, "lambda_style": 500.0,
           "lambda_content": 0.5, "ratio_g2d": 0.1},
}


def find_model_using_name(name):
    if name == "DPTN":
        raise NotImplementedError("the DPTN engine is not ported yet "
                                  "(ROADMAP A: other generators and DPTN)")
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


def create_model(cfg, **kwargs):
    """Instantiate the engine named by ``cfg.model`` (models.py:65-74)."""
    cls = find_model_using_name(cfg.model)
    get_option_setter(cfg.model)(cfg)
    model = cls(cfg, **kwargs)
    print(f"model [{cls.__name__}] was created")
    return model
