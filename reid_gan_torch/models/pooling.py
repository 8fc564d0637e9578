"""Pooling layers over NCHW feature maps (port of
``reid_gan_tpu/models/pooling.py``; parity: CC/clustercontrast/models/
pooling.py — GeM with trainable p is the default, factory at
pooling.py:216-226), GeM with its gradient (kernel K5, ``gem_pool``) and the
fused eval head ``gem_bn_l2n`` (kernel K2).
"""

import torch
from torch import nn

from ..kernels import GEM_BN_L2N, GEM_POOL


class GeneralizedMeanPooling(nn.Module):
    """f(X) = (mean(clip(X, eps)^p))^(1/p); p=1 → avg, p→∞ → max
    (pooling.py:57-94). ``trainable`` keeps p as the parameter ``p`` of shape
    (1,) (GeneralizedMeanPoolingP, pooling.py:97-103)."""

    def __init__(self, p=3.0, eps=1e-6, trainable=True):
        super().__init__()
        self.eps = eps
        if trainable:
            self.p = nn.Parameter(torch.full((1,), float(p)))
        else:
            self.p = float(p)

    def forward(self, x):
        if isinstance(self.p, nn.Parameter):
            return gem_pool(x, self.p, self.eps)
        x = torch.clamp(x, min=self.eps) ** self.p
        return torch.mean(x, dim=(2, 3)) ** (1.0 / self.p)


class GeneralizedMeanPoolingList(nn.Module):
    """GeM over a list of maps, avg-pool each then mean-stack
    (pooling.py:19-54)."""

    def __init__(self, eps=1e-6):
        super().__init__()
        self.eps = eps

    def forward(self, x_list):
        outs = [torch.mean(torch.clamp(x, min=self.eps), dim=(2, 3)) for x in x_list]
        return torch.mean(torch.stack(outs, -1), dim=-1)


class GeneralizedMeanPoolingFpn(nn.Module):
    """GeM per map in a list, concatenated (pooling.py:106-156)."""

    def __init__(self, p=3.0, eps=1e-6, trainable=True):
        super().__init__()
        self.eps = eps
        if trainable:
            self.p = nn.Parameter(torch.full((1,), float(p)))
        else:
            self.p = float(p)

    def forward(self, x_list):
        outs = [torch.mean(torch.clamp(x, min=self.eps) ** self.p, dim=(2, 3))
                ** (1.0 / self.p) for x in x_list]
        return torch.cat(outs, dim=1)


class AvgPool(nn.Module):
    def forward(self, x):
        return torch.mean(x, dim=(2, 3))


class MaxPool(nn.Module):
    def forward(self, x):
        return torch.amax(x, dim=(2, 3))


class AvgMaxPool(nn.Module):
    """avg + max (pooling.py:159-168)."""

    def forward(self, x):
        return torch.mean(x, dim=(2, 3)) + torch.amax(x, dim=(2, 3))


_POOLING = {
    "avg": AvgPool,
    "max": MaxPool,
    "gem": GeneralizedMeanPooling,
    "gemFpn": GeneralizedMeanPoolingFpn,
    "gemList": GeneralizedMeanPoolingList,
    "avg+max": AvgMaxPool,
}


def pooling_names():
    return sorted(_POOLING.keys())


def build_pooling_layer(kind, **kwargs):
    if kind not in _POOLING:
        raise KeyError(f"Unknown pooling layer: {kind}")
    return _POOLING[kind](**kwargs)


# ---------------------------------------------------------------------------
# GeM with a learned p, forward and backward (kernel K5)
# ---------------------------------------------------------------------------

def gem_pool_plain(fmap, p, eps=1e-6):
    """Plain PyTorch version of K5, differentiable by autograd:
    (N, C, H, W) map and (1,) p → (N, C)."""
    return torch.mean(torch.clamp(fmap, min=eps) ** p, dim=(2, 3)) ** (1.0 / p)


def _check_map(fmap, name):
    if fmap.dtype != torch.float32 or fmap.dim() != 4:
        raise ValueError(f"{name} takes an (N, C, H, W) float32 map, got "
                         f"{tuple(fmap.shape)} {fmap.dtype}")
    c = fmap.shape[1]
    if not fmap.is_contiguous(memory_format=torch.channels_last) or \
            fmap.data_ptr() % 16 or c % 4:
        raise ValueError(f"{name} needs a channels_last, 16-byte aligned map "
                         f"with C % 4 == 0 (C={c})")


def _check_vec(t, name, size, like):
    if t.dtype != torch.float32 or t.device != like.device or \
            t.numel() != size or not t.is_contiguous():
        raise ValueError(f"{name} must be {size} contiguous float32 values on "
                         f"{like.device}")


def _gem_forward_cuda(fmap, p, eps):
    _check_map(fmap, "gem_pool")
    _check_vec(p, "gem_pool: p", 1, fmap)
    n, c, h, w = fmap.shape
    out = torch.empty((n, c), dtype=torch.float32, device=fmap.device)
    smean = torch.empty_like(out)
    GEM_POOL(fmap.data_ptr(), p.data_ptr(), out.data_ptr(), smean.data_ptr(),
             n, h * w, c, eps, device=fmap.device)
    return out, smean


def _gem_backward_cuda(fmap, p, smean, out, grad, eps):
    grad = grad.contiguous()
    _check_vec(grad, "gem_pool: the output gradient", out.numel(), fmap)
    n, c, h, w = fmap.shape
    dx = torch.empty_like(fmap, memory_format=torch.channels_last)
    dp = torch.empty(1, dtype=torch.float32, device=fmap.device)
    partial = torch.empty(GEM_POOL.scratch_size(n, c), dtype=torch.float64,
                          device=fmap.device)
    GEM_POOL.backward(fmap.data_ptr(), p.data_ptr(), smean.data_ptr(),
                      out.data_ptr(), grad.data_ptr(), dx.data_ptr(),
                      dp.data_ptr(), partial.data_ptr(), n, h * w, c, eps,
                      device=fmap.device)
    return dx, dp


class _GemPool(torch.autograd.Function):
    """K5 on the card: the forward kernel keeps S for the backward kernel."""

    @staticmethod
    def forward(ctx, fmap, p, eps):
        out, smean = _gem_forward_cuda(fmap, p, eps)
        ctx.eps = eps
        ctx.save_for_backward(fmap, p, smean, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        fmap, p, smean, out = ctx.saved_tensors
        dx, dp = _gem_backward_cuda(fmap, p, smean, out, grad, ctx.eps)
        return dx, dp, None


def gem_pool(fmap, p, eps=1e-6):
    """GeM(p) of an (N, C, H, W) map with a learned (1,) p, with gradients
    for the map and for p (kernel K5 forward and backward on the card; the
    plain version, differentiated by autograd, on the CPU)."""
    if fmap.is_cuda:
        return _GemPool.apply(fmap, p, eps)
    if fmap.device.type != "cpu":
        raise ValueError(f"gem_pool: unsupported device {fmap.device}")
    return gem_pool_plain(fmap, p, eps)


# ---------------------------------------------------------------------------
# Fused eval head: GeM → scale-only feat_bn → L2 normalisation (kernel K2)
# ---------------------------------------------------------------------------

def l2n(x, eps=1e-12):
    """Row L2 normalisation with the epsilon outside the root
    (models/resnet.py:255-256)."""
    return x * torch.reciprocal(torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)) + eps)


def gem_bn_l2n_plain(fmap, p, weight, running_mean, running_var,
                     gem_eps=1e-6, bn_eps=1e-5):
    """Plain PyTorch version of K2: (N, C, H, W) fp32 map → (N, C)."""
    pooled = torch.mean(torch.clamp(fmap, min=gem_eps) ** p, dim=(2, 3)) ** (1.0 / p)
    z = (pooled - running_mean) * torch.reciprocal(
        torch.sqrt(running_var + bn_eps)) * weight
    return l2n(z)


def _gem_bn_l2n_cuda(fmap, p, weight, running_mean, running_var, gem_eps,
                     bn_eps):
    if fmap.dtype != torch.float32 or fmap.dim() != 4:
        raise ValueError(f"gem_bn_l2n takes an (N, C, H, W) float32 map, got "
                         f"{tuple(fmap.shape)} {fmap.dtype}")
    n, c, h, w = fmap.shape
    if not fmap.is_contiguous(memory_format=torch.channels_last) or \
            fmap.data_ptr() % 16 or c % 4 or c * 4 > 48 * 1024:
        raise ValueError("gem_bn_l2n needs a channels_last, 16-byte aligned "
                         f"map with C % 4 == 0 and C <= 12288 (C={c})")
    for name, t, size in (("p", p, 1), ("weight", weight, c),
                          ("running_mean", running_mean, c),
                          ("running_var", running_var, c)):
        if t.dtype != torch.float32 or t.device != fmap.device or \
                t.numel() != size or not t.is_contiguous():
            raise ValueError(f"gem_bn_l2n: {name} must be {size} contiguous "
                             f"float32 values on {fmap.device}")
    out = torch.empty((n, c), dtype=torch.float32, device=fmap.device)
    GEM_BN_L2N(fmap.data_ptr(), p.data_ptr(), weight.data_ptr(),
               running_mean.data_ptr(), running_var.data_ptr(), out.data_ptr(),
               n, h * w, c, gem_eps, bn_eps, device=fmap.device)
    return out


def gem_bn_l2n(fmap, p, weight, running_mean, running_var, gem_eps=1e-6,
               bn_eps=1e-5):
    """GeM(p) + eval BatchNorm without bias + L2 norm of a layer4 map
    (kernel K2 on the card)."""
    if fmap.is_cuda:
        return _gem_bn_l2n_cuda(fmap, p, weight, running_mean, running_var,
                                gem_eps, bn_eps)
    if fmap.device.type != "cpu":
        raise ValueError(f"gem_bn_l2n: unsupported device {fmap.device}")
    return gem_bn_l2n_plain(fmap, p, weight, running_mean, running_var,
                            gem_eps, bn_eps)


def eval_l2_head(fmap, gap, bn):
    """An eval head of pooling ``gap`` → BatchNorm ``bn`` on its running
    stats → L2 norm of an (N, C, H, W) map: kernel K2 (``gem_bn_l2n``) when
    ``gap`` is GeM with a learned p, else the three modules in turn."""
    if isinstance(gap, GeneralizedMeanPooling) and isinstance(gap.p, nn.Parameter):
        return gem_bn_l2n(fmap, gap.p, bn.weight, bn.running_mean, bn.running_var,
                          gap.eps, bn.eps)
    return l2n(bn(gap(fmap)))
