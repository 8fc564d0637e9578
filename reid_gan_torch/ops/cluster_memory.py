"""ClusterMemory: the cluster-contrast InfoNCE memory bank (port of
``reid_gan_tpu/ops/cluster_memory.py``; parity: CC/clustercontrast/models/
cm.py).

    logits = x_n @ Mᵀ / temp       (the bank carries no gradient)
    loss   = CE(logits, y), per sample
    M'     = momentum fold of the batch into M, after the optimizer step

``memory_loss`` is kernel K6 (``csrc/infonce.cu``) on the card, forward and
backward, through an ``autograd.Function`` whose gradient flows to ``x``
only. ``update_memory`` is kernel K7 (``csrc/bank_fold.cu``). On CPU tensors
each runs its plain PyTorch version. The bank is padded to a static number of
rows and the live ones are counted by ``num_valid``, a tensor on the bank's
device, so no call waits on the card.

Unlike the JAX function, ``update_memory`` updates the bank in place (the
JAX function returns a new state): that saves a copy of the bank per step.

The gradient memory (ClusterMemory_Gradient, cm.py:140-193) keeps trainable,
unnormalised clusters: ``gradient_memory_loss`` is K6 against the clusters
L2-normalised and detached, and ``update_gradient_clusters`` their SGD step
(plain PyTorch, returning a new state as the JAX functions do).
"""

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import BANK_FOLD, INFONCE


class MemoryState(NamedTuple):
    features: torch.Tensor      # (K_pad, D) centroid bank
    gan_features: torch.Tensor  # (K_pad, D) parallel GAN bank, or (0, D)
    num_valid: torch.Tensor     # () int32: live clusters <= K_pad


def init_memory(centroids, k_pad=None, gan_centroids=None, device=None):
    """A MemoryState from per-epoch centroids (already L2-normalised),
    zero-padded to ``k_pad`` rows, on ``device`` (default: the card). The
    bank is at least float32; float64 centroids stay float64."""
    device = resolve_device(device)
    c = torch.as_tensor(np.asarray(centroids) if not torch.is_tensor(centroids)
                        else centroids)
    c = c.to(device, torch.promote_types(c.dtype, torch.float32))
    k = c.shape[0]
    k_pad = k_pad or k
    feats = torch.nn.functional.pad(c, (0, 0, 0, k_pad - k))
    if gan_centroids is not None:
        g = torch.as_tensor(np.asarray(gan_centroids) if not torch.is_tensor(
            gan_centroids) else gan_centroids).to(device, c.dtype)
        gan = torch.nn.functional.pad(g, (0, 0, 0, k_pad - k))
    else:
        gan = torch.zeros((0, c.shape[1]), dtype=c.dtype, device=device)
    return MemoryState(feats.contiguous(), gan.contiguous(),
                       torch.tensor(k, dtype=torch.int32, device=device))


def _l2n(x, eps=1e-12):
    """Row L2 normalisation with the epsilon inside the root (not the
    model's ``_l2n``, which adds it outside)."""
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps)


# ---------------------------------------------------------------------------
# InfoNCE (kernel K6)
# ---------------------------------------------------------------------------

def memory_loss_plain(x, targets, state, temp=0.05, ex_f=None, group_size=1, row0=0):
    """Plain PyTorch version of K6 (``memory_loss``, cluster_memory.py:
    58-100), differentiable by autograd: returns (per-sample loss (B,),
    logits (B, K_pad[+T])). ``ex_f``: (T, D) extra negatives with the
    −10000 group self-mask of cm.py:158-182, row b's group being
    ``(row0 + b) // group_size``."""
    x = _l2n(x)
    bank = state.features.detach()
    logits = x @ bank.T
    col = torch.arange(bank.shape[0], device=x.device)[None]
    logits = torch.where(col < state.num_valid, logits, -torch.inf)
    if ex_f is not None:
        ex = _l2n(ex_f)
        t = ex.shape[0]
        lex = x @ ex.T
        row = (row0 + torch.arange(x.shape[0], device=x.device))[:, None] // group_size
        colx = torch.arange(t, device=x.device)[None]
        lex = lex + torch.where(row == colx, -10000.0, 0.0)
        logits = torch.cat([logits, lex], dim=1)
    logits = logits / temp
    logz = torch.logsumexp(logits, dim=1)
    picked = torch.gather(logits, 1, targets.long()[:, None])[:, 0]
    return logz - picked, logits


def _check_rows(t, name, device, cols=None):
    if t.dtype != torch.float32 or t.dim() != 2 or t.device != device or \
            not t.is_contiguous() or t.data_ptr() % 16 or t.shape[1] % 4 or \
            (cols is not None and t.shape[1] != cols):
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                         f"(rows, D) float32 tensor on {device} with D % 4 == 0"
                         + (f" and D == {cols}" if cols is not None else ""))


def _check_ids(t, name, n, device):
    if t.dtype != torch.int32 or t.shape != (n,) or t.device != device or \
            not t.is_contiguous():
        raise ValueError(f"{name} must be ({n},) contiguous int32 on {device}")


def _infonce_forward_cuda(x, bank, num_valid, targets, temp, ex, group_size, row0):
    dev = x.device
    _check_rows(x, "memory_loss: x", dev)
    _check_rows(bank, "memory_loss: the bank", dev, x.shape[1])
    _check_ids(targets, "memory_loss: targets", x.shape[0], dev)
    if num_valid.dtype != torch.int32 or num_valid.numel() != 1 or \
            num_valid.device != dev:
        raise ValueError(f"memory_loss: num_valid must be one int32 on {dev}")
    b, d = x.shape
    k = bank.shape[0]
    t = 0 if ex is None else ex.shape[0]
    if ex is not None:
        _check_rows(ex, "memory_loss: ex_f", dev, d)
        if t == 0 or group_size < 1 or row0 < 0:
            raise ValueError("memory_loss: ex_f needs at least one row, "
                             "group_size >= 1 and row0 >= 0")
    if b == 0 or k + t == 0:
        raise ValueError(f"memory_loss: needs at least one row of x and one "
                         f"column of logits, got B {b}, K {k}, T {t}")
    rnorm = torch.empty(b, dtype=torch.float32, device=dev)
    rexn = torch.empty(t, dtype=torch.float32, device=dev)
    logits = torch.empty((b, k + t), dtype=torch.float32, device=dev)
    part = torch.empty(INFONCE.scratch_size(b, k, t, d, 0), dtype=torch.float32,
                       device=dev)
    lse = torch.empty(b, dtype=torch.float32, device=dev)
    loss = torch.empty(b, dtype=torch.float32, device=dev)
    INFONCE(x.data_ptr(), bank.data_ptr(), num_valid.data_ptr(),
            targets.data_ptr(), b, k, d, temp, ex.data_ptr() if t else None, t,
            int(group_size), int(row0), rnorm.data_ptr(),
            rexn.data_ptr() if t else None,
            logits.data_ptr(), part.data_ptr(), lse.data_ptr(), loss.data_ptr(),
            device=dev)
    if ex is None:
        ex = x.new_empty((0, d))
    return loss, logits, (x, rnorm, ex, rexn, lse)


def _infonce_backward_cuda(saved, bank, num_valid, targets, logits, grad, temp):
    """dL/dx from the forward's ``saved`` tensors (x, 1/|x|, the extra
    negatives and their 1/|ex|, the row LSE)."""
    x, rnorm, ex, rexn, lse = saved
    b, d = x.shape
    t = ex.shape[0]
    grad = grad.contiguous()
    if grad.dtype != torch.float32 or grad.shape != (b,):
        raise ValueError(f"memory_loss: the loss gradient must be ({b},) float32")
    k = bank.shape[0]
    scratch = torch.empty(INFONCE.scratch_size(b, k, t, d, 1), dtype=torch.float32,
                          device=x.device)
    dx = torch.empty_like(x)
    INFONCE.backward(x.data_ptr(), rnorm.data_ptr(), bank.data_ptr(),
                     num_valid.data_ptr(), targets.data_ptr(), logits.data_ptr(),
                     lse.data_ptr(), grad.data_ptr(), b, k, d, temp,
                     ex.data_ptr() if t else None, rexn.data_ptr() if t else None, t,
                     scratch.data_ptr(), dx.data_ptr(), device=x.device)
    return dx


class _InfoNCE(torch.autograd.Function):
    """K6 on the card: the forward kernel keeps 1/|x|, the extra negatives'
    1/|ex|, the logits and the row LSE for the backward kernel, which takes
    x and ex as they are. ``ex`` (or None) gets no gradient."""

    @staticmethod
    def forward(ctx, x, bank, num_valid, targets, temp, ex, group_size, row0):
        loss, logits, saved = _infonce_forward_cuda(
            x, bank, num_valid, targets, temp, ex, group_size, row0)
        ctx.temp = temp
        ctx.save_for_backward(bank, num_valid, targets, logits, *saved)
        ctx.mark_non_differentiable(logits)
        return loss, logits

    @staticmethod
    def backward(ctx, grad, _grad_logits):
        bank, num_valid, targets, logits, *saved = ctx.saved_tensors
        dx = _infonce_backward_cuda(saved, bank, num_valid, targets, logits, grad,
                                    ctx.temp)
        return dx, None, None, None, None, None, None, None


def memory_loss(x, targets, state, temp=0.05, ex_f=None, group_size=1, row0=0):
    """Per-sample InfoNCE against the bank (cm.py:123-137; kernel K6 forward
    and backward on the card), with optional extra negatives ``ex_f`` (T, D)
    appended after the bank's columns, each masked by −10000 for its own
    group of ``group_size`` rows (cm.py:158-182); under a data mesh ``x`` is
    a rank's rows and ``row0`` the global index of its first, so that row b
    is masked for extra column ``(row0 + b) // group_size`` as it is in the
    whole batch. The gradient flows to ``x``
    only: the logits carry none (no caller of the JAX function
    differentiates them), nor does ``ex_f`` (the JAX step stops it). Returns
    (per-sample loss (B,), logits (B, K_pad[+T])), columns >= num_valid at
    −inf. On the CPU the plain version runs, differentiated by autograd."""
    ex = None if ex_f is None else ex_f.detach()
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"memory_loss: unsupported device {x.device}")
        return memory_loss_plain(x, targets, state, temp, ex, group_size, row0)
    return _InfoNCE.apply(x, state.features.detach(), state.num_valid,
                          targets.to(torch.int32), temp, ex, group_size, row0)


# ---------------------------------------------------------------------------
# Bank fold (kernel K7)
# ---------------------------------------------------------------------------

def _sequential_fold(bank, x, targets, momentum):
    """The batch-order fold (cluster_memory.py:149-158), in place. JAX's
    ``_occurrence_fold`` (:161-179) gives the same bank by another order of
    work, so the plain version keeps one."""
    for xi, yi in zip(x, targets.tolist()):
        row = momentum * bank[yi] + (1.0 - momentum) * xi
        bank[yi] = row * torch.rsqrt(torch.sum(row * row) + 1e-24)


def _hard_fold(bank, x, targets, momentum):
    """Per label, the slot with the least similarity to the pre-update row
    (the first one on an exact tie) updates it once (cluster_memory.py:
    182-203)."""
    sims = torch.sum(x * bank[targets], dim=-1)
    best = {}
    for i, (y, s) in enumerate(zip(targets.tolist(), sims.tolist())):
        if y not in best or s < best[y][0]:
            best[y] = (s, i)
    for y, (_, i) in best.items():
        upd = momentum * bank[y] + (1.0 - momentum) * x[i]
        bank[y] = upd * torch.rsqrt(torch.sum(upd * upd) + 1e-24)


def update_memory_plain(state, x, targets, momentum=0.2, use_hard=False,
                        gan_x=None):
    """Plain PyTorch version of K7 (``update_memory``, cluster_memory.py:
    103-130), in place. Returns ``state``."""
    with torch.no_grad():
        targets = targets.long()
        xh = _l2n(x.detach())
        if use_hard:
            _hard_fold(state.features, xh, targets, momentum)
            return state
        _sequential_fold(state.features, xh, targets, momentum)
        if gan_x is not None and state.gan_features.shape[0] > 0:
            _sequential_fold(state.gan_features, gan_x.detach(), targets,
                             momentum)
    return state


def _bank_fold_cuda(state, x, targets, momentum, use_hard, gan_x):
    bank, dev = state.features, state.features.device
    _check_rows(bank, "update_memory: the bank", dev)
    _check_rows(x, "update_memory: x", dev, bank.shape[1])
    _check_ids(targets, "update_memory: targets", x.shape[0], dev)
    gan = None
    if not use_hard and gan_x is not None and state.gan_features.shape[0] > 0:
        gan = state.gan_features
        _check_rows(gan, "update_memory: the GAN bank", dev)
        _check_rows(gan_x, "update_memory: gan_x", dev, gan.shape[1])
        if gan_x.shape[0] != x.shape[0]:
            raise ValueError(f"update_memory: gan_x has {gan_x.shape[0]} rows, x "
                             f"{x.shape[0]}")
    for t in (bank, gan):
        if t is not None and t.shape[1] > 4096:
            raise ValueError(f"update_memory: D = {t.shape[1]} > 4096")
    BANK_FOLD(bank.data_ptr(), x.data_ptr(),
              None if gan is None else gan.data_ptr(),
              None if gan is None else gan_x.data_ptr(), targets.data_ptr(),
              x.shape[0], bank.shape[0], bank.shape[1],
              0 if gan is None else gan.shape[0], 0 if gan is None else gan.shape[1],
              float(momentum), float(1.0 - momentum), int(use_hard), device=dev)


def update_memory(state, x, targets, momentum=0.2, use_hard=False, gan_x=None,
                  group_size=None):
    """Momentum fold of the batch into the bank, in place, after the
    optimizer step (cm.py:29-31, CM_Hard cm.py:58-70, CM_gan cm.py:99-103;
    kernel K7 on the card). ``x`` is L2-normalised first, ``gan_x`` is
    folded as it is, into the GAN bank in the same launch. ``group_size``
    (the sampler's instances per label) is taken for the JAX signature's
    sake: the JAX function picks its order of work by it, and the bank does
    not depend on it. The kernel walks each label's slots in batch order.
    Returns ``state``."""
    if not state.features.is_cuda:
        if state.features.device.type != "cpu":
            raise ValueError(f"update_memory: unsupported device "
                             f"{state.features.device}")
        return update_memory_plain(state, x, targets, momentum, use_hard, gan_x)
    with torch.no_grad():
        _bank_fold_cuda(state, x.detach().contiguous(),
                        targets.to(torch.int32).contiguous(), momentum, use_hard,
                        None if gan_x is None else gan_x.detach().contiguous())
    return state


# ---------------------------------------------------------------------------
# The gradient memory (ClusterMemory_Gradient) and memory_step
# ---------------------------------------------------------------------------

class GradientMemoryState(NamedTuple):
    clusters: torch.Tensor      # (K_pad, D) trainable centroids, not normalised
    num_valid: torch.Tensor     # () int32: live clusters <= K_pad


def init_gradient_memory(centroids, k_pad=None, device=None):
    """A GradientMemoryState from per-epoch centroids, zero-padded to
    ``k_pad`` rows, on ``device`` (default: the card) (cluster_memory.py:
    213-218). The clusters are at least float32; float64 centroids stay
    float64 (the JAX function casts them to float32)."""
    state = init_memory(centroids, k_pad, device=device)
    return GradientMemoryState(state.features, state.num_valid)


def gradient_memory_loss(x, targets, state, temp=0.05, ex_f=None, group_size=1,
                         row0=0):
    """The mean InfoNCE against the clusters L2-normalised and detached
    (cluster_memory.py:221-230; cm.py:158-182), with an empty GAN bank:
    ``memory_loss``, so K6 on the card. The clusters get no gradient from
    it. Returns (mean loss, logits)."""
    normed = _l2n(state.clusters.detach()).contiguous()
    proxy = MemoryState(normed, normed.new_zeros((0, normed.shape[1])),
                        state.num_valid)
    loss, logits = memory_loss(x, targets, proxy, temp, ex_f, group_size, row0)
    return loss.mean(), logits


def update_gradient_clusters(state, grads, p_ids, cluster_lr=0.1, eps=1e-16):
    """The clusters' SGD step (cm.py:184-193; cluster_memory.py:233-240):
    the rows flagged in the (K,) bool ``p_ids`` step along their gradient
    divided by its norm plus ``eps``, the others along their gradient as it
    is. Returns a new state."""
    with torch.no_grad():
        norms = torch.linalg.vector_norm(grads, dim=1, keepdim=True) + eps
        g = torch.where(p_ids[:, None], grads / norms, grads)
        return state._replace(clusters=state.clusters.detach() - cluster_lr * g)


def memory_step(x, targets, state, temp=0.05, momentum=0.2, use_hard=False,
                gan_x=None):
    """The per-sample loss and the bank fold in one call (cluster_memory.py:
    243-251): ``memory_loss`` (K6), then ``update_memory`` (K7, under no
    gradient, in place). For training, call ``memory_loss`` before the
    backward and ``update_memory`` after the optimizer step. Returns
    (per-sample loss, state)."""
    loss, _ = memory_loss(x, targets, state, temp)
    update_memory(state, x, targets, momentum, use_hard, gan_x)
    return loss, state
