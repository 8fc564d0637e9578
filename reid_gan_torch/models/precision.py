"""Mixed precision as the JAX package defines it (``dtype=jnp.bfloat16``,
the ``--fp16`` flag; ``reid_gan_tpu/models/resnet.py:137-138,183``,
``models/dual_gan/base_function.py:13-19``), not as ``torch.autocast``
does:

- parameters, gradients and optimiser state stay fp32;
- a convolution or dense layer with a ``compute_dtype`` casts its input,
  weight and bias to it and emits it (flax's ``promote_dtype(..., dtype=)``);
- a norm layer reduces in and emits at least fp32, whatever its input
  (``TorchBatchNorm`` and the instance norms ignore ``dtype``, ROADMAP C);
- everything else computes in the dtype its inputs promote to.

The layers here are the torch layers with these rules; without a
``compute_dtype`` (the default) a convolution or dense layer is torch's own,
and a norm layer's widening is a no-op on an fp32 or fp64 input.
``set_compute_dtype`` sets the compute dtype of every such layer in a net.
"""

import torch
import torch.nn.functional as F
from torch import nn


def widen(x):
    """``x`` in at least fp32 (an fp64 tensor stays fp64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def promote(*ts):
    """The tensors in their common dtype, as ``jnp`` promotes the operands
    of an einsum."""
    dtype = ts[0].dtype
    for t in ts[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return tuple(t.to(dtype) for t in ts)


class _Compute:
    compute_dtype = None

    def _run(self, fn, x, w, b, *args):
        """``fn(x, w, b, *args)`` in the compute dtype. On the CPU the same
        function is computed as fp32 products of the bf16-rounded operands,
        rounded once to bf16 (what the card's bf16 convolutions do, fp32
        accumulation): torch's CPU bf16 convolution gives wrong values at
        some shapes (a 4×4 stride-2 convolution of a 4×2 map)."""
        cd = self.compute_dtype
        if cd is None:
            return fn(x, w, b, *args)
        x, w, b = x.to(cd), w.to(cd), None if b is None else b.to(cd)
        if x.device.type == "cpu":
            return fn(widen(x), widen(w), None if b is None else widen(b), *args).to(cd)
        return fn(x, w, b, *args)


class Conv2d(_Compute, nn.Conv2d):
    def forward(self, x):
        return self._run(self._conv_forward, x, self.weight, self.bias)


class ConvTranspose2d(_Compute, nn.ConvTranspose2d):
    def forward(self, x):
        return self._run(F.conv_transpose2d, x, self.weight, self.bias, self.stride,
                         self.padding, self.output_padding, self.groups, self.dilation)


class Linear(_Compute, nn.Linear):
    def forward(self, x):
        return self._run(F.linear, x, self.weight, self.bias)


class BatchNorm1d(nn.BatchNorm1d):
    def forward(self, x):
        return super().forward(widen(x))


class BatchNorm2d(nn.BatchNorm2d):
    def forward(self, x):
        return super().forward(widen(x))


class InstanceNorm2d(nn.InstanceNorm2d):
    def forward(self, x):
        return super().forward(widen(x))


def set_compute_dtype(net, dtype):
    """Set the compute dtype (``torch.bfloat16``, or None for the parameters'
    own) of every convolution and dense layer of ``net`` that takes one;
    returns ``net``."""
    for m in net.modules():
        if isinstance(m, _Compute):
            m.compute_dtype = dtype
    return net

