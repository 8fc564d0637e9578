"""Weights across: the JAX package's generator and discriminator variables
(numpy trees of ``params`` and ``batch_stats``) → the port's ``state_dict``.

The port's modules carry the flax module names, so a tree path maps onto a
``state_dict`` key path by path (``block0/conv1/conv/kernel`` →
``block0.conv1.conv.weight``); the leaf's layout follows the module it
lands in:

- ``nn.Conv2d``: HWIO kernel → OIHW;
- ``nn.ConvTranspose2d``: the flax ``ConvTranspose`` kernel (H, W, in, out),
  which flax correlates unflipped, → (in, out, H, W) flipped in H and W,
  the kernel that torch's transposed convolution applies flipped;
- ``nn.Linear``: a Dense (in, out) kernel, or an attention kernel (d_model,
  heads, head_dim) / output kernel (heads, head_dim, d_model), → (out, in);
  (heads, head_dim) biases flattened;
- BatchNorm and instance norm: scale/bias → weight/bias, mean/var →
  running_mean/var;
- ``AutoAttn``'s ``gamma`` and ``alpha`` as they are;
- spectral norm: ``SpectralNorm_0/conv/kernel/{u,sigma}`` → the conv
  block's ``u``/``sigma`` buffers.

A gradient tree converts the same way (pass it as ``params``). The mapping is
the one the ``load_flax`` methods of the test twins spell out module by
module (``tests/torch_gan_twins.py``).
"""

import numpy as np
import torch
from torch import nn

from ..convert import _t
from .ptm import MultiHeadAttention


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _param(module, name, a):
    if isinstance(module, nn.ConvTranspose2d) and name == "kernel":
        return np.flip(a, (0, 1)).transpose(2, 3, 0, 1)
    if isinstance(module, nn.Conv2d) and name == "kernel":
        return a.transpose(3, 2, 0, 1)
    if isinstance(module, nn.Linear):
        if name == "bias":
            return a.reshape(-1)
        if a.shape[0] == module.in_features:
            return a.reshape(module.in_features, -1).T
        return a.reshape(-1, module.out_features).T
    return a


_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias",
          "mean": "running_mean", "var": "running_var", "gamma": "gamma",
          "alpha": "alpha"}


def state_dict_from_jax(net, params, batch_stats=None):
    """The ``state_dict`` entries of ``net`` (any dual_gan generator, block
    or transformer, the ``ResDiscriminator``, ``VGG19``, or FD-GAN's
    ``CustomPoseGenerator`` or ``NLayerDiscriminator``) for the JAX
    ``params`` and ``batch_stats`` trees.
    BatchNorm modules also get a zero ``num_batches_tracked``."""
    sd = {}
    for path, a in _leaves(params):
        module = net.get_submodule(".".join(path[:-1]))
        sd[".".join(path[:-1] + (_NAMES[path[-1]],))] = _t(
            np.ascontiguousarray(_param(module, path[-1], a)))
    for path, a in _leaves(batch_stats or {}):
        if path[-2] == "SpectralNorm_0":      # conv/kernel/{u,sigma}
            key = ".".join(path[:-2] + (path[-1].rsplit("/", 1)[-1],))
        else:
            key = ".".join(path[:-1] + (_NAMES[path[-1]],))
            if path[-1] == "mean":
                sd[".".join(path[:-1] + ("num_batches_tracked",))] = torch.tensor(0)
        sd[key] = _t(a)
    return sd


def _kernel_to_jax(module, parent, name, w):
    """The inverse of ``_param``: the port's leaf → the flax leaf."""
    if isinstance(module, nn.ConvTranspose2d) and name == "weight":
        return np.flip(w.transpose(2, 3, 0, 1), (0, 1))
    if isinstance(module, nn.Conv2d) and name == "weight":
        return w.transpose(2, 3, 1, 0)
    if not isinstance(module, nn.Linear):
        return w
    if not isinstance(parent, MultiHeadAttention):
        return w.T if name == "weight" else w
    heads = (parent.nhead, parent.head_dim)
    if module is parent.out:      # (heads, head_dim, d_model) kernel, (d_model,) bias
        return w.T.reshape(*heads, -1) if name == "weight" else w
    return w.T.reshape(-1, *heads) if name == "weight" else w.reshape(heads)


def state_dict_to_jax(net):
    """The inverse of ``state_dict_from_jax``: ``net``'s weights →
    ``{"params", "batch_stats"}`` numpy trees in the JAX package's layout
    (path by path; spectral norm's ``u``/``sigma`` buffers →
    ``SpectralNorm_0/conv/kernel/{u,sigma}``; ``num_batches_tracked``
    dropped)."""
    params, stats = {}, {}

    def put(tree, path, leaf):
        for p in path[:-1]:
            tree = tree.setdefault(p, {})
        tree[path[-1]] = np.array(leaf, order="C")

    modules = dict(net.named_modules())
    for key, t in list(net.named_parameters()) + list(net.named_buffers()):
        path = key.split(".")
        owner = ".".join(path[:-1])
        module, leaf = modules[owner], path[-1]
        parent = modules[".".join(path[:-2])] if len(path) > 1 else None
        a = t.detach().cpu().numpy()
        if leaf == "num_batches_tracked":
            continue
        if leaf in ("u", "sigma"):
            put(stats, path[:-1] + ["SpectralNorm_0", f"conv/kernel/{leaf}"], a)
        elif leaf in ("running_mean", "running_var"):
            put(stats, path[:-1] + [leaf[len("running_"):]], a)
        else:
            weighted = isinstance(module, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))
            name = {"weight": "kernel" if weighted else "scale"}.get(leaf, leaf)
            put(params, path[:-1] + [name], _kernel_to_jax(module, parent, leaf, a))
    return {"params": params, "batch_stats": stats}
