"""BatchNorm over the whole mesh batch (the port's counterpart of
``reid_gan_tpu/ops/norm.py``'s ``TorchBatchNorm`` under a sharded ``jit``).

Under a data mesh the JAX package's BatchNorm reduces over the global batch:
XLA turns the mean over a sharded axis into a cross-device sum. The port's
ranks each hold their rows, so a train-mode BatchNorm must reduce over the
ranks explicitly:

- it normalises with the biased variance of the global batch (JAX's
  E[x²] − E[x]²), reduced in at least fp32, eps as the layer's (1e-5);
- it folds the global mean, and the global variance with Bessel's n/(n−1)
  for the global n, into the running stats with torch's momentum 0.1
  (flax's 0.9);
- its gradient is the gradient of the global batch's loss (each rank's loss
  is its rows' mean and the gradients are averaged over the ranks,
  ``parallel.all_reduce_grads``).

The reduction is one plain PyTorch function on every device
(``_GlobalBatchNorm``): an all-reduce of [Σx, n], then one of Σ(x − mean)²,
over the default process group (NCCL on the card, gloo on the CPU), and in
the backward one of [Σdy, Σdy·(x − mean)]; the host never waits on them.
The variance's second pass is what fp32 needs: E[x²] − E[x]² in one pass
loses every digit where a channel's mean is large beside its spread. In
eval mode it is the plain BatchNorm on the running stats. Without a mesh
nothing is swapped (``convert_global_bn``), and the single-card path keeps
cuDNN's BatchNorm.

Rows that every rank holds alike (the hard-mix decoder's one mixed feature
a group, computed on every rank) are already the whole batch: a global
reduction over them would count each R times, which leaves the mean and
the biased variance as they are but folds the running variance with
Bessel's n/(n−1) for R·n rows. Within ``local_stats(module)`` the global
BatchNorms under ``module`` normalise over the rank's rows alone, as the
single-card BatchNorm does, with no collective.
"""

import contextlib

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


def _all_reduce_sum(t):
    """The sum of ``t`` over the ranks of the default process group (a new
    tensor)."""
    out = t.clone()
    dist.all_reduce(out)
    return out


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm of ``x`` (N, C, ...) over every rank's rows, its
    running stats updated in place and its gradient written out.
    For the sum of the ranks' losses the input's gradient is
    scale·(dy − Σdy/n − x̂·Σ(dy·x̂)/n), both sums over every rank's rows (one
    all-reduce of 2C values); the weight's and the bias's are the rank's own
    Σ(dy·x̂) and Σdy, which ``parallel.all_reduce_grads`` averages as it does
    every gradient. It keeps x − mean for the backward, as cuDNN keeps x."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps):
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        shape = [1, c] + [1] * (x.dim() - 2)
        tot = _all_reduce_sum(torch.cat([x.sum(dims), x.new_full((1,), x.numel() // c)]))
        n = tot[c]
        mean = tot[:c] / n
        xc = x - mean.view(shape)
        var = _all_reduce_sum(torch.linalg.vector_norm(xc, 2, dims) ** 2) / n
        invstd = torch.rsqrt(var + eps)
        if running_mean is not None:
            bessel = n / torch.clamp_min(n - 1, 1)
            running_mean.mul_(1 - momentum).add_(momentum * mean.to(running_mean.dtype))
            running_var.mul_(1 - momentum).add_(
                momentum * (var * bessel).to(running_var.dtype))
        scale = invstd if weight is None else invstd * weight
        ctx.save_for_backward(xc, scale, invstd, n)
        ctx.affine = weight is not None
        if bias is None:
            return xc * scale.view(shape)
        return torch.addcmul(bias.view(shape), xc, scale.view(shape))

    @staticmethod
    def backward(ctx, dy):
        xc, scale, invstd, n = ctx.saved_tensors
        c = xc.shape[1]
        dims = [0] + list(range(2, xc.dim()))
        shape = [1, c] + [1] * (xc.dim() - 2)
        local = torch.cat([dy.sum(dims), (dy * xc).sum(dims)])  # Σdy, Σdy·(x − mean)
        tot = _all_reduce_sum(local)
        shift = -scale * tot[:c] / n
        slope = -scale * invstd * invstd * tot[c:] / n
        dx = torch.addcmul(shift.view(shape), dy, scale.view(shape))
        dx.addcmul_(xc, slope.view(shape))
        if not ctx.affine:
            return dx, None, None, None, None, None, None
        return dx, local[c:] * invstd, local[:c], None, None, None, None


class GlobalBatchNorm(nn.modules.batchnorm._BatchNorm):
    """A BatchNorm (1d or 2d: any (N, C, ...) input) whose train-mode
    statistics are the whole mesh batch's (the module's docstring). Its
    parameters and buffers have ``nn.BatchNorm*d``'s names, so state dicts
    load either way. The input is widened to at least fp32, as
    ``models.precision``'s BatchNorms do. With ``local`` set
    (``local_stats``) it is the plain train-mode BatchNorm of the rank's
    rows."""

    local = False

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f"expected an (N, C, ...) input, got {x.dim()}D")

    def forward(self, x):
        self._check_input_dim(x)
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        if self.track_running_stats:
            self.num_batches_tracked.add_(1)
        if self.local:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, True, self.momentum, self.eps)
        return _GlobalBatchNorm.apply(x, self.weight, self.bias, self.running_mean,
                                      self.running_var, self.momentum, self.eps)


def convert_global_bn(module, mesh):
    """Swap every ``nn.BatchNorm1d``/``nn.BatchNorm2d`` under ``module`` (the
    module itself too) for a ``GlobalBatchNorm`` over ``mesh`` that shares
    its parameters and buffers, so the state-dict keys, the optimiser's
    parameters and their ``requires_grad`` stay as they were. Without a
    mesh, returns ``module`` untouched. Returns the converted module."""
    if mesh is None:
        return module
    if isinstance(module, (nn.BatchNorm1d, nn.BatchNorm2d)):
        if module.momentum is None:
            raise NotImplementedError("a BatchNorm with a cumulative average "
                                      "(momentum None) under a data mesh")
        out = GlobalBatchNorm(module.num_features, module.eps, module.momentum,
                              module.affine, module.track_running_stats)
        if module.affine:
            out.weight, out.bias = module.weight, module.bias
        if module.track_running_stats:
            out.running_mean = module.running_mean
            out.running_var = module.running_var
            out.num_batches_tracked = module.num_batches_tracked
        out.train(module.training)
        return out
    for name, child in module.named_children():
        new = convert_global_bn(child, mesh)
        if new is not child:
            setattr(module, name, new)
    return module


@contextlib.contextmanager
def local_stats(module):
    """Within the block every ``GlobalBatchNorm`` under ``module`` normalises
    its input over the rank's own rows, with no collective (the module's
    docstring): for rows that every rank holds alike. A module without
    global BatchNorms (no mesh) runs as it is."""
    norms = [m for m in module.modules() if isinstance(m, GlobalBatchNorm)]
    for m in norms:
        m.local = True
    try:
        yield
    finally:
        for m in norms:
            m.local = False
