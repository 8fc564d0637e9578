"""Weight conversion between the JAX package's trees and the port's
``state_dict`` layout, and reference-checkpoint key normalisation."""

import re

import numpy as np
import torch


def _t(a):
    """At least float32; float64 stays float64 (the fp64 parity tests)."""
    a = np.asarray(a)
    return torch.tensor(a.astype(np.promote_types(a.dtype, np.float32)))


# The JAX variants' scopes that hold one ``ResNetStage`` (children
# ``layerK_J``), which the port keeps as an ``nn.Sequential`` (children ``J``)
_STAGE_SCOPES = ("p1_l3", "p1_l4", "p2_l3", "p2_l4", "res_g", "res_p")


def _torch_child(child, in_stage):
    """A flax scope's name → the port's module name: ``layerI_J`` →
    ``layerI.J`` (``J`` inside a ``ResNetStage``), ``downsample_{conv,bn}``
    → ``downsample.{0,1}``."""
    if re.fullmatch(r"layer[0-9]_[0-9]+", child):
        stage, blk = child.split("_")
        return blk if in_stage else f"{stage}.{blk}"
    return {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}.get(child, child)


def _module_to_sd(sd, key, name, p, s):
    """One flax module's (params, batch_stats) subtrees, numpy leaves, into
    ``sd`` under the torch prefix ``key``: a kernel (HWIO → OIHW for a
    convolution, (in, out) → (out, in) for a Dense) with its bias, a
    BatchNorm (its running stats; a scale-only one gets its frozen zero
    bias), an instance norm ``IN`` (scale and shift, no stats), a GeM ``p``,
    or a scope of such modules."""
    join = lambda k: f"{key}.{k}" if key else k   # noqa: E731
    if "kernel" in p:
        kern = np.asarray(p["kernel"])
        sd[join("weight")] = _t(np.transpose(kern, (3, 2, 0, 1)) if kern.ndim == 4 else kern.T)
        if "bias" in p:
            sd[join("bias")] = _t(p["bias"])
    elif "scale" in p and name == "IN":
        sd[join("weight")] = _t(p["scale"])
        sd[join("bias")] = _t(p["bias"])
    elif "scale" in p:
        scale = np.asarray(p["scale"])
        sd[join("weight")] = _t(scale)
        sd[join("bias")] = _t(p["bias"]) if "bias" in p else \
            torch.zeros(scale.shape, dtype=torch.float32)
        sd[join("running_mean")] = _t(s["mean"])
        sd[join("running_var")] = _t(s["var"])
        sd[join("num_batches_tracked")] = torch.tensor(0)
    elif "p" in p:
        sd[join("p")] = _t(p["p"])
    else:
        for child, sub in p.items():
            if not isinstance(sub, dict) and not hasattr(sub, "items"):
                raise KeyError(f"unsupported entry {key or '.'}/{child}")
            _module_to_sd(sd, join(_torch_child(child, name in _STAGE_SCOPES)), child,
                          sub, s.get(child, {}))
    return sd


def resnet_state_dict_from_jax(params, batch_stats):
    """``ReIDResNet`` (or ``FDResNet``) (params, batch_stats) trees, numpy
    leaves → a torch ``state_dict`` for the port's model.

    The inverse of ``reid_gan_tpu/models/resnet.py::import_torch_resnet``
    (resnet.py:263-337): conv kernels HWIO → OIHW, Dense (in, out) →
    (out, in) (``feat``, ``classifier``), BN scale/bias/mean/var →
    weight/bias/running_mean/running_var,
    ``base/layerI_J`` → ``layerI.J``, ``downsample_{conv,bn}`` →
    ``downsample.{0,1}``, an IBN-a split ``bn1/{IN,BN}`` → ``bn1.IN.{weight,
    bias}`` and ``bn1.BN.*`` (resnet.py:290-305). The scale-only ``feat_bn``
    gets its frozen zero bias.
    """
    params, batch_stats = dict(params), dict(batch_stats)
    sd = _module_to_sd({}, "", "base", params.pop("base"), batch_stats.pop("base", {}))
    return _module_to_sd(sd, "", "", params, batch_stats)


def variant_state_dict_from_jax(params, batch_stats):
    """A ``ResNetBip``, ``ResNetBipD`` or ``ResNetMP`` (params, batch_stats)
    → the port's ``state_dict`` of the same variant
    (``models/resnet_variants.py``), scope by scope: ``base`` (the stem,
    ``base.conv1``, ``base.layerI.J``), the stages ``p1_l3`` ... ``res_p``
    (``layerK_J`` → ``<scope>.J``), the GeMs ``gap*``/``gpool_*``, the
    scale-only ``feat_bn*``, the Dense ``fc_id_*``, the 1×1 ``proj_gan``
    and ``predictor/{fc1, bn1, fc2}``."""
    return _module_to_sd({}, "", "", params, batch_stats)


def _prefixed(prefix, sd):
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def siamese_state_dict_from_jax(params, batch_stats):
    """A JAX ``SiameseNet(FDResNet(cut_at_pooling), EltwiseSubEmbed)``
    (params, batch_stats) → the port's ``SiameseNet`` ``state_dict``:
    ``base_model`` through ``resnet_state_dict_from_jax`` (an FDResNet has
    the backbone under ``base`` and no head), ``embed_model``'s BatchNorm
    ``bn`` and Dense ``classifier`` ((in, out) kernel → (out, in) weight).
    The inverse of ``tests/test_fdgan_parity_oracle.py::_import_fd_siamese``.
    A gradient tree converts the same way (pass it as ``params``, with any
    ``batch_stats``)."""
    sd = _prefixed("base_model", resnet_state_dict_from_jax(
        params["base_model"], batch_stats["base_model"]))
    em_p, em_s = params["embed_model"], batch_stats.get("embed_model", {})
    if "bn" in em_p:
        sd["embed_model.bn.weight"] = _t(em_p["bn"]["scale"])
        sd["embed_model.bn.bias"] = _t(em_p["bn"]["bias"])
        sd["embed_model.bn.running_mean"] = _t(em_s["bn"]["mean"])
        sd["embed_model.bn.running_var"] = _t(em_s["bn"]["var"])
        sd["embed_model.bn.num_batches_tracked"] = torch.tensor(0)
    if "classifier" in em_p:
        sd["embed_model.classifier.weight"] = _t(np.asarray(em_p["classifier"]["kernel"]).T)
        sd["embed_model.classifier.bias"] = _t(em_p["classifier"]["bias"])
    return sd


# CC wraps the torchvision stages in one nn.Sequential
# (CC/clustercontrast/models/resnet.py:37-39):
# Sequential(conv1, bn1, relu, maxpool, layer1, layer2, layer3, layer4) —
# indices 2/3 (relu/maxpool) carry no parameters.
_CC_BASE_MAP = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
                "6": "layer3", "7": "layer4"}


def normalize_reference_state_dict(state_dict):
    """Translate a reference-format checkpoint state dict (the CC ``base.N``
    sequential layout, possibly ``module.``-prefixed,
    CC/clustercontrast/utils/serialization.py:41-61) into torchvision-style
    key names (copy of ``reid_gan_tpu/models/resnet.py:348-373``).

    Returns ``(translated_dict, gem_p)`` where ``gem_p`` is the trainable
    GeM pooling power (``gap.p``) if the checkpoint carries one.
    """
    out, gem_p = {}, None
    for k, v in state_dict.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k == "gap.p":
            gem_p = v
            continue
        if k.startswith("base."):
            parts = k.split(".")
            head = _CC_BASE_MAP.get(parts[1])
            if head is None:       # relu/maxpool — no params expected
                out[k] = v
                continue
            k = ".".join([head] + parts[2:])
        out[k] = v
    return out, gem_p
