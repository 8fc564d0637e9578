"""Weight conversion between the JAX package's trees and the port's
``state_dict`` layout, both ways, and reference-checkpoint key
normalisation.

``state_dict_from_flax`` routes a flax variables tree (a decoded msgpack
checkpoint) to the converter of the model it is loaded into;
``flax_variables_from_model`` is its inverse, used to write a checkpoint in
the JAX package's layout (the mapping ``reid_gan_tpu/models/resnet.py::
import_torch_resnet`` spells out, :263-347)."""

import re

import numpy as np
import torch
from torch import nn


def _t(a):
    """At least float32; float64 stays float64 (the fp64 parity tests). A
    torch tensor (a bfloat16 leaf of a msgpack file) is widened the same
    way."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.promote_types(a.dtype, torch.float32)).clone()
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


# ---------------------------------------------------------------------------
# state dict → flax variables (the writer's side)
# ---------------------------------------------------------------------------

def _np(t):
    return t.detach().cpu().numpy()


def _put(tree, path, leaf):
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = leaf


def flax_scope(parts):
    """The port's module path (a list of names) → the flax scope path: the
    inverse of ``_torch_child``: ``layerI.J`` → ``layerI_J``, a stage scope's
    ``<scope>.J`` → ``<scope>/layerK_J`` (K 3 for ``*_l3``, else 4),
    ``downsample.{0,1}`` → ``downsample_{conv,bn}``."""
    out, i = [], 0
    while i < len(parts):
        p, nxt = parts[i], parts[i + 1] if i + 1 < len(parts) else None
        if re.fullmatch(r"layer[1-4]", p) and nxt is not None:
            out.append(f"{p}_{nxt}")
            i += 2
        elif p in _STAGE_SCOPES and nxt is not None:
            out += [p, f"layer{3 if p.endswith('_l3') else 4}_{nxt}"]
            i += 2
        elif p == "downsample" and nxt is not None:
            out.append(("downsample_conv", "downsample_bn")[int(nxt)])
            i += 2
        else:
            out.append(p)
            i += 1
    return out


def _module_to_flax(params, stats, path, m, scale_only=False):
    """One leaf module's parameters and stats into the flax trees at
    ``path``: a convolution's kernel OIHW → HWIO, a Linear's (out, in) →
    (in, out), a BatchNorm's weight/bias/running stats → scale/bias/mean/var
    (no bias when ``scale_only``, the JAX heads' ``use_bias=False``), an
    instance norm's weight/bias → scale/bias, a GeM's ``p``."""
    if isinstance(m, nn.Conv2d):
        _put(params, path + ["kernel"], np.ascontiguousarray(_np(m.weight).transpose(2, 3, 1, 0)))
        if m.bias is not None:
            _put(params, path + ["bias"], _np(m.bias))
    elif isinstance(m, nn.Linear):
        _put(params, path + ["kernel"], np.ascontiguousarray(_np(m.weight).T))
        if m.bias is not None:
            _put(params, path + ["bias"], _np(m.bias))
    elif isinstance(m, nn.modules.batchnorm._BatchNorm):
        _put(params, path + ["scale"], _np(m.weight))
        if not scale_only:
            _put(params, path + ["bias"], _np(m.bias))
        _put(stats, path + ["mean"], _np(m.running_mean))
        _put(stats, path + ["var"], _np(m.running_var))
    elif isinstance(m, nn.InstanceNorm2d):
        _put(params, path + ["scale"], _np(m.weight))
        _put(params, path + ["bias"], _np(m.bias))
    elif isinstance(getattr(m, "p", None), nn.Parameter):
        _put(params, path + ["p"], _np(m.p))


def _resnet_to_flax(model, params, stats, prefix=(), scale_only=("feat_bn",)):
    """A ``ReIDResNet``/``FDResNet``/variant's leaves into the trees: the
    stem and stages of a ``ReIDResNet``/``FDResNet`` under ``base``."""
    in_base = ("conv1", "bn1", "layer1", "layer2", "layer3", "layer4")
    own_base = not hasattr(model, "base")
    for name, m in model.named_modules():
        if list(m.parameters(recurse=False)) or list(m.buffers(recurse=False)):
            parts = name.split(".")
            scope = flax_scope(parts)
            if own_base and parts[0] in in_base:
                scope = ["base"] + scope
            _module_to_flax(params, stats, list(prefix) + scope, m,
                            parts[-1].startswith(scale_only))


def flax_variables_from_model(model):
    """The port's model → ``{"params", "batch_stats"}`` numpy trees in the
    JAX package's layout, with its key set and shapes: the inverse of
    ``state_dict_from_flax`` for the ResNet family (``ReIDResNet``,
    ``FDResNet``), the variants, FD-GAN's ``SiameseNet`` and the dual_gan
    and FD-GAN generators and discriminators."""
    from .multi_branch import SiameseNet
    from .resnet import FDResNet, ReIDResNet
    from .resnet_variants import ResNetBip, ResNetBipD, ResNetMP

    params, stats = {}, {}
    if isinstance(model, SiameseNet):
        _resnet_to_flax(model.base_model, params, stats, ("base_model",), scale_only=())
        em = model.embed_model
        for name in ("bn", "classifier"):
            if getattr(em, name, None) is not None:
                _module_to_flax(params, stats, ["embed_model", name], getattr(em, name))
    elif isinstance(model, FDResNet):
        _resnet_to_flax(model, params, stats, scale_only=())
    elif isinstance(model, (ReIDResNet, ResNetBip, ResNetBipD, ResNetMP)):
        _resnet_to_flax(model, params, stats)
    else:
        from .dual_gan.convert import state_dict_to_jax

        return state_dict_to_jax(model)
    return {"params": params, "batch_stats": stats}


def state_dict_from_flax(model, variables):
    """A flax variables tree ``{"params", "batch_stats"}`` (numpy leaves, as
    a decoded msgpack checkpoint holds them) → the ``state_dict`` of the
    port's ``model``, through the converter of its kind: the ResNet family,
    the variants, FD-GAN's ``SiameseNet``, or any dual_gan / FD-GAN
    generator or discriminator."""
    from .multi_branch import SiameseNet
    from .resnet import FDResNet, ReIDResNet
    from .resnet_variants import ResNetBip, ResNetBipD, ResNetMP

    params, stats = variables["params"], variables.get("batch_stats", {})
    if isinstance(model, SiameseNet):
        return siamese_state_dict_from_jax(params, stats)
    if isinstance(model, (ReIDResNet, FDResNet)):
        return resnet_state_dict_from_jax(params, stats)
    if isinstance(model, (ResNetBip, ResNetBipD, ResNetMP)):
        return variant_state_dict_from_jax(params, stats)
    from .dual_gan.convert import state_dict_from_jax

    return state_dict_from_jax(model, params, stats)
