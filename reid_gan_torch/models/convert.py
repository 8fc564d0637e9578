"""Weight conversion between the JAX package's trees and the port's
``state_dict`` layout, and reference-checkpoint key normalisation."""

import numpy as np
import torch


def _t(a):
    """At least float32; float64 stays float64 (the fp64 parity tests)."""
    a = np.asarray(a)
    return torch.tensor(a.astype(np.promote_types(a.dtype, np.float32)))


def resnet_state_dict_from_jax(params, batch_stats):
    """``ReIDResNet`` (params, batch_stats) trees, numpy leaves → a torch
    ``state_dict`` for the port's ``ReIDResNet``.

    The inverse of ``reid_gan_tpu/models/resnet.py::import_torch_resnet``
    (resnet.py:263-337): conv kernels HWIO → OIHW, Dense (in, out) →
    (out, in) (``feat``, ``classifier``), BN scale/bias/mean/var →
    weight/bias/running_mean/running_var,
    ``base/layerI_J`` → ``layerI.J``, ``downsample_{conv,bn}`` →
    ``downsample.{0,1}``. The scale-only ``feat_bn`` gets its frozen zero
    bias. IBN variants are not covered (their ``bn1`` is split).
    """
    sd = {}

    def conv(key, tree):
        sd[key] = _t(np.transpose(np.asarray(tree["kernel"]), (3, 2, 0, 1)))

    def bn(prefix, p, s):
        scale = np.asarray(p["scale"])
        sd[f"{prefix}.weight"] = _t(scale)
        sd[f"{prefix}.bias"] = _t(p["bias"]) if "bias" in p else \
            torch.zeros(scale.shape, dtype=torch.float32)
        sd[f"{prefix}.running_mean"] = _t(s["mean"])
        sd[f"{prefix}.running_var"] = _t(s["var"])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    base_p, base_s = params["base"], batch_stats["base"]
    conv("conv1.weight", base_p["conv1"])
    bn("bn1", base_p["bn1"], base_s["bn1"])
    for name in base_p:
        if not name.startswith("layer"):
            continue
        stage, blk = name.split("_")
        prefix = f"{stage}.{blk}"
        for sub in base_p[name]:
            if sub == "downsample_conv":
                conv(f"{prefix}.downsample.0.weight", base_p[name][sub])
            elif sub == "downsample_bn":
                bn(f"{prefix}.downsample.1", base_p[name][sub],
                   base_s[name][sub])
            elif sub.startswith("conv"):
                conv(f"{prefix}.{sub}.weight", base_p[name][sub])
            elif sub.startswith("bn") and "scale" in base_p[name][sub]:
                bn(f"{prefix}.{sub}", base_p[name][sub], base_s[name][sub])
            else:
                raise KeyError(f"unsupported backbone entry base/{name}/{sub}")
    if "gap" in params:
        sd["gap.p"] = _t(params["gap"]["p"])
    if "feat" in params:
        sd["feat.weight"] = _t(np.asarray(params["feat"]["kernel"]).T)
        sd["feat.bias"] = _t(params["feat"]["bias"])
    if "feat_bn" in params:
        bn("feat_bn", params["feat_bn"], batch_stats["feat_bn"])
    if "classifier" in params:
        sd["classifier.weight"] = _t(np.asarray(params["classifier"]["kernel"]).T)
        if "bias" in params["classifier"]:
            sd["classifier.bias"] = _t(params["classifier"]["bias"])
    return sd


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
