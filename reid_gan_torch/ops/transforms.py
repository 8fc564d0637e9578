"""Image transforms: the eval transform (kernel K1), the train
augmentation (kernel K4), FD-GAN's train transform (kernel K14) and the GAN
input transform (kernel K9), uint8 NHWC staging batch → normalised NCHW
batch; and the re-encode transform of generated images (kernel K12).

Port of ``reid_gan_tpu/ops/transforms.py::reid_augment``. The eval branch
(``train=False``: to_float → resize → normalize) comes with the cast to the
extractor's dtype that ``engine/evaluators.py:47`` applies. The train branch
(``train=True``: flip → random sized rect crop → normalize → random erasing,
:152-157) is split in two, as the port's ground rule for random draws asks:
``sample_augment_params`` draws the per-image parameters from an explicit
``torch.Generator`` and ``train_augment`` applies them; its plain version
composes JAX's four stages, each with the draws given (``random_hflip``,
``random_sized_rect_crop``, ``normalize``, ``random_erasing``). The output is a
logical NCHW tensor in channels_last memory, so it feeds cuDNN's
channels_last convolutions without a copy.

The loader stages every batch at the target size (``data/loader.py``), so the
eval resize is a no-op and the crop always upsamples; a batch at any other
size raises.

On a CUDA tensor ``eval_transform`` launches kernel K1
(``csrc/eval_transform.cu``), ``train_augment`` kernel K4
(``csrc/train_augment.cu``), ``fd_augment`` kernel K14
(``csrc/fd_augment.cu``), ``gan_input_transform`` kernel K9
(``csrc/gan_input.cu``) and ``diff_transform`` kernel K12
(``csrc/diff_transform.cu``); on a CPU tensor each runs its plain PyTorch
version, the same arithmetic.
"""

import math

import numpy as np
import torch

from ..kernels import DIFF_TRANSFORM, EVAL_TRANSFORM, FD_AUGMENT, GAN_INPUT, TRAIN_AUGMENT

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# The JAX package's ImageNet constants are float32 arrays
# (``ops/transforms.py:26-27``): a float64 batch is normalised by their
# float32 values, which the plain K12 and K14 keep.
_MEAN_F32 = tuple(float(v) for v in np.float32(IMAGENET_MEAN))
_STD_F32 = tuple(float(v) for v in np.float32(IMAGENET_STD))


def to_float(img_u8):
    return img_u8.to(torch.float32) / 255.0


def normalize(x, mean=IMAGENET_MEAN, std=IMAGENET_STD, dim=1):
    """Per-channel ``(x - mean) / std`` of a batch with its channels on
    ``dim``: 1 for NCHW, -1 for NHWC (the train augmentation's stages, as
    JAX's ``normalize``, :36)."""
    shape = [1] * x.dim()
    shape[dim] = -1
    m = torch.tensor(mean, dtype=x.dtype, device=x.device).view(shape)
    s = torch.tensor(std, dtype=x.dtype, device=x.device).view(shape)
    return (x - m) / s


def eval_transform_plain(img_u8, dtype=torch.bfloat16):
    """Plain PyTorch version of K1: (N, H, W, 3) uint8 → (N, 3, H, W) in
    ``dtype``, channels_last."""
    x = to_float(img_u8.permute(0, 3, 1, 2))
    return normalize(x).to(dtype).contiguous(memory_format=torch.channels_last)


def _eval_transform_cuda(img_u8, dtype):
    if img_u8.dtype != torch.uint8 or img_u8.dim() != 4 or img_u8.shape[-1] != 3:
        raise ValueError(f"eval_transform takes (N, H, W, 3) uint8, got "
                         f"{tuple(img_u8.shape)} {img_u8.dtype}")
    if not img_u8.is_contiguous() or img_u8.data_ptr() % 4:
        raise ValueError("eval_transform needs a contiguous, 4-byte aligned "
                         "uint8 batch")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"eval_transform writes float32 or bfloat16, not {dtype}")
    n, h, w, c = img_u8.shape
    out = torch.empty((n, c, h, w), dtype=dtype, device=img_u8.device,
                      memory_format=torch.channels_last)
    EVAL_TRANSFORM(img_u8.data_ptr(), out.data_ptr(), img_u8.numel(),
                   int(dtype == torch.bfloat16), *IMAGENET_MEAN, *IMAGENET_STD,
                   device=img_u8.device)
    return out


def eval_transform(img_u8, height=256, width=128, dtype=torch.bfloat16):
    """The eval transform of a staged batch (kernel K1 on the card)."""
    if tuple(img_u8.shape[1:3]) != (height, width):
        raise ValueError(
            f"staged batch is {tuple(img_u8.shape[1:3])}, expected "
            f"{(height, width)}: the eval path takes batches staged at the "
            "target size")
    if img_u8.is_cuda:
        return _eval_transform_cuda(img_u8, dtype)
    if img_u8.device.type != "cpu":
        raise ValueError(f"eval_transform: unsupported device {img_u8.device}")
    return eval_transform_plain(img_u8, dtype)


# ---------------------------------------------------------------------------
# Train augmentation (kernel K4)
# ---------------------------------------------------------------------------

# Columns of the (N, 10) float32 parameter tensor, one row per image
FLIP, CROP_TOP, CROP_LEFT, CROP_H, CROP_W, ERASE, ERASE_TOP, ERASE_LEFT, \
    ERASE_H, ERASE_W = range(10)


def sample_augment_params(n, h, w, generator):
    """Per-image augmentation draws on ``generator``'s device, over the
    ranges of the JAX functions: flip with p 0.5 (``random_hflip``,
    :59-62); crop area in [0.64, 1]·HW and aspect h/w in [2, 3], clamped
    into the image (``random_sized_rect_crop``, :96-102); erase with p 0.5,
    area in [0.02, 0.4]·HW and log-aspect in [ln 0.3, ln(1/0.3)], sides
    rounded half to even and clipped, corner floored (``random_erasing``,
    :116-124). Returns (n, 10) float32 in the column order above."""
    dev = generator.device

    def u(lo=0.0, hi=1.0):
        return torch.rand(n, generator=generator, device=dev) * (hi - lo) + lo

    flip = (u() < 0.5).float()
    area = h * w * u(0.64, 1.0)
    aspect = u(2.0, 3.0)
    crop_h = torch.clamp(torch.sqrt(area * aspect), 1.0, float(h))
    crop_w = torch.clamp(torch.sqrt(area / aspect), 1.0, float(w))
    top = u() * (h - crop_h)
    left = u() * (w - crop_w)
    erase = (u() < 0.5).float()
    e_area = h * w * u(0.02, 0.4)
    e_aspect = torch.exp(u(math.log(0.3), math.log(1.0 / 0.3)))
    eh = torch.clamp(torch.round(torch.sqrt(e_area * e_aspect)), 1.0, float(h))
    ew = torch.clamp(torch.round(torch.sqrt(e_area / e_aspect)), 1.0, float(w))
    e_top = torch.floor(u() * (h - eh + 1))
    e_left = torch.floor(u() * (w - ew + 1))
    return torch.stack([flip, top, left, crop_h, crop_w, erase, e_top, e_left,
                        eh, ew], dim=1).float()


def _taps(out_size, size, top, crop):
    """``jax.image.scale_and_translate``'s linear weights for one axis of
    each image (jax/_src/image/scale.py:54-85, upsampling): the two source
    indices and their weights, (N, out_size) each. The jitted JAX function
    forms ``(o + 0.5) * inv - translation * inv`` as one fused multiply-add;
    the product and the difference are taken in float64 here, which is that
    fma's result, then rounded to float32 once."""
    scale = size / crop
    trans = -top * scale
    inv = 1.0 / scale
    o = torch.arange(out_size, dtype=torch.float32, device=crop.device)
    fma = (o[None] + 0.5).double() * inv[:, None].double() - \
        (trans * inv)[:, None].double()
    f = fma.float() - 0.5
    i0 = torch.floor(f)
    w0 = torch.clamp_min(1.0 - torch.abs(f - i0), 0.0)
    w1 = torch.clamp_min(1.0 - torch.abs(f - (i0 + 1.0)), 0.0)
    w0 = torch.where((i0 >= 0) & (i0 < size), w0, 0.0)
    w1 = torch.where((i0 + 1 >= 0) & (i0 + 1 < size), w1, 0.0)
    total = w0 + w1
    keep = torch.abs(total) > 1000.0 * torch.finfo(torch.float32).eps
    safe = torch.where(total != 0, total, 1.0)
    inside = (f >= -0.5) & (f <= size - 0.5)
    w0 = torch.where(keep & inside, w0 / safe, 0.0)
    w1 = torch.where(keep & inside, w1 / safe, 0.0)
    i0 = i0.long()
    return i0.clamp(0, size - 1), (i0 + 1).clamp(0, size - 1), w0, w1


def random_hflip(x, params):
    """JAX's ``random_hflip`` (:59-62) with its draws given: the NHWC
    images whose ``FLIP`` column is set, mirrored along W."""
    return torch.where((params[:, FLIP] != 0)[:, None, None, None], torch.flip(x, [2]), x)


def random_sized_rect_crop(x, params, out_h=256, out_w=128):
    """JAX's ``random_sized_rect_crop`` (:86-104) with its draws given: the
    rectangle of each NHWC image in the ``CROP_*`` columns resampled to
    (out_h, out_w) with ``jax.image.scale_and_translate``'s linear taps."""
    n, h, w, _ = x.shape
    ya, yb, wy0, wy1 = _taps(out_h, h, params[:, CROP_TOP], params[:, CROP_H])
    xa, xb, wx0, wx1 = _taps(out_w, w, params[:, CROP_LEFT], params[:, CROP_W])
    idx = torch.arange(n, device=x.device)[:, None, None]

    def px(ys, xs):
        return x[idx, ys[:, :, None], xs[:, None, :]]          # (N, oh, ow, C)

    wy0, wy1 = wy0[:, :, None, None], wy1[:, :, None, None]
    wx0, wx1 = wx0[:, None, :, None], wx1[:, None, :, None]
    return wy0 * (wx0 * px(ya, xa) + wx1 * px(ya, xb)) + \
        wy1 * (wx0 * px(yb, xa) + wx1 * px(yb, xb))


def random_erasing(x, params):
    """JAX's ``random_erasing`` (:108-134) with its draws given: the
    ``ERASE_*`` rectangle of each NHWC image whose ``ERASE`` column is set,
    filled with the image's per-channel mean."""
    _, h, w, _ = x.shape
    fill = x.mean(dim=(1, 2))                                   # (N, C)
    yy = torch.arange(h, device=x.device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, device=x.device, dtype=torch.float32)[None, None, :]
    p = params[:, :, None, None]
    inside = ((yy >= p[:, ERASE_TOP]) & (yy < p[:, ERASE_TOP] + p[:, ERASE_H])
              & (xx >= p[:, ERASE_LEFT]) & (xx < p[:, ERASE_LEFT] + p[:, ERASE_W])
              & (p[:, ERASE] != 0))
    return torch.where(inside[..., None], fill[:, None, None, :], x)


def train_augment_plain(img_u8, params):
    """Plain PyTorch version of K4: (N, H, W, 3) uint8 and (N, 10) params →
    (N, 3, H, W) float32, channels_last, at the staged size. JAX's stages in
    ``reid_augment``'s order (:152-157): flip, crop, normalize, erase."""
    _, h, w, _ = img_u8.shape
    x = random_sized_rect_crop(random_hflip(to_float(img_u8), params), params, h, w)
    return random_erasing(normalize(x, dim=-1), params).permute(0, 3, 1, 2)


def _check_params(img_u8, params):
    n = img_u8.shape[0]
    if params.shape != (n, 10) or params.dtype != torch.float32 or \
            params.device != img_u8.device or not params.is_contiguous():
        raise ValueError(f"train_augment: params must be ({n}, 10) contiguous "
                         f"float32 on {img_u8.device}")


def _train_augment_cuda(img_u8, params):
    if img_u8.dtype != torch.uint8 or img_u8.dim() != 4 or img_u8.shape[-1] != 3 \
            or not img_u8.is_contiguous():
        raise ValueError(f"train_augment takes a contiguous (N, H, W, 3) uint8 "
                         f"batch, got {tuple(img_u8.shape)} {img_u8.dtype}")
    _check_params(img_u8, params)
    n, h, w, c = img_u8.shape
    out = torch.empty((n, c, h, w), dtype=torch.float32, device=img_u8.device,
                      memory_format=torch.channels_last)
    partial = torch.empty(TRAIN_AUGMENT.scratch_size(n), dtype=torch.float32,
                          device=img_u8.device)
    TRAIN_AUGMENT(img_u8.data_ptr(), params.data_ptr(), out.data_ptr(),
                  partial.data_ptr(), n, h, w, *IMAGENET_MEAN, *IMAGENET_STD,
                  device=img_u8.device)
    return out


def train_augment(img_u8, params, height=256, width=128):
    """The train augmentation of a staged batch with given draws (kernel K4
    on the card): flip, linear crop-resize, ImageNet normalize, erase with
    the per-image channel mean of the normalized crop. float32 out."""
    if tuple(img_u8.shape[1:3]) != (height, width):
        raise ValueError(
            f"staged batch is {tuple(img_u8.shape[1:3])}, expected "
            f"{(height, width)}: the crop upsamples from a batch staged at "
            "the target size")
    if img_u8.is_cuda:
        return _train_augment_cuda(img_u8, params)
    if img_u8.device.type != "cpu":
        raise ValueError(f"train_augment: unsupported device {img_u8.device}")
    _check_params(img_u8, params)
    return train_augment_plain(img_u8, params)


# ---------------------------------------------------------------------------
# FD-GAN train transform (kernel K14)
# ---------------------------------------------------------------------------

# Columns of the (N, 9) parameter tensor, one row per image
FD_ERASE, FD_TOP, FD_LEFT, FD_EH, FD_EW, FD_FLIP, FD_FILL = 0, 1, 2, 3, 4, 5, 6
FD_PARAMS = 9


def sample_fd_augment_params(n, h, w, generator):
    """Per-image draws of FD-GAN's train transform on ``generator``'s device,
    over the ranges of the JAX function (``engine/fdgan.py:37-45`` through
    ``random_erasing``, ``ops/transforms.py:107-134``): erase with p 0.5,
    area in [0.02, 0.2]·HW, log-aspect in [ln 0.3, ln(1/0.3)], sides rounded
    half to even and clipped, corner floored; a flip with p 0.5; a fill RGB
    in [0, 1). Returns (n, 9) float32 in the column order above."""
    dev = generator.device

    def u(lo=0.0, hi=1.0, size=(n,)):
        return torch.rand(size, generator=generator, device=dev) * (hi - lo) + lo

    do = (u() < 0.5).float()
    area = h * w * u(0.02, 0.2)
    aspect = torch.exp(u(math.log(0.3), math.log(1.0 / 0.3)))
    eh = torch.clamp(torch.round(torch.sqrt(area * aspect)), 1.0, float(h))
    ew = torch.clamp(torch.round(torch.sqrt(area / aspect)), 1.0, float(w))
    top = torch.floor(u() * (h - eh + 1))
    left = torch.floor(u() * (w - ew + 1))
    flip = (u() < 0.5).float()
    fill = u(size=(n, 3))
    return torch.cat([torch.stack([do, top, left, eh, ew, flip], dim=1), fill],
                     dim=1).float().contiguous()


def fd_augment_plain(img_u8, params):
    """Plain PyTorch version of K14: (N, H, W, 3) uint8 and (N, 9) draws →
    ``normalize(flip(erase(x / 255, fill)))``, (N, 3, H, W) in channels_last
    memory, in the draws' dtype. float64 draws give the JAX function's
    result under x64: the pixels ``to_float`` in float32, the fill and the
    normalisation in float64, with the float32 ImageNet constants."""
    n, h, w, _ = img_u8.shape
    dt = params.dtype
    # a 0-d tensor on the batch's device, not a Python scalar: CUDA divides
    # by a host scalar as a product with its reciprocal, an ulp off JAX's
    # (and K14's) IEEE division
    x = (img_u8.to(torch.float32) /
         torch.full((), 255.0, device=img_u8.device)).to(dt)   # (N, H, W, 3)
    p = params[:, :, None, None]
    yy = torch.arange(h, dtype=dt, device=x.device)[None, :, None]
    xx = torch.arange(w, dtype=dt, device=x.device)[None, None, :]
    inside = ((p[:, FD_ERASE] != 0) & (yy >= p[:, FD_TOP]) &
              (yy < p[:, FD_TOP] + p[:, FD_EH]) & (xx >= p[:, FD_LEFT]) &
              (xx < p[:, FD_LEFT] + p[:, FD_EW]))
    x = torch.where(inside[..., None], params[:, None, None, FD_FILL:], x)
    x = torch.where((params[:, FD_FLIP] != 0)[:, None, None, None], torch.flip(x, [2]), x)
    mean = torch.tensor(_MEAN_F32, dtype=dt, device=x.device)
    std = torch.tensor(_STD_F32, dtype=dt, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def _fd_augment_cuda(img_u8, params):
    if img_u8.dtype != torch.uint8 or img_u8.dim() != 4 or img_u8.shape[-1] != 3 \
            or not img_u8.is_contiguous():
        raise ValueError(f"fd_augment takes a contiguous (N, H, W, 3) uint8 batch, "
                         f"got {tuple(img_u8.shape)} {img_u8.dtype}")
    n, h, w, c = img_u8.shape
    if params.shape != (n, FD_PARAMS) or params.dtype != torch.float32 or \
            params.device != img_u8.device or not params.is_contiguous():
        raise ValueError(f"fd_augment: params must be ({n}, {FD_PARAMS}) contiguous "
                         f"float32 on {img_u8.device}")
    out = torch.empty((n, c, h, w), dtype=torch.float32, device=img_u8.device,
                      memory_format=torch.channels_last)
    FD_AUGMENT(img_u8.data_ptr(), params.data_ptr(), out.data_ptr(), n, h, w,
               *IMAGENET_MEAN, *IMAGENET_STD, device=img_u8.device)
    return out


def fd_augment(img_u8, params):
    """FD-GAN's train transform of a uint8 batch with given draws (kernel K14
    on the card): erase on [0, 1] values with the drawn fill, then flip, then
    ImageNet normalise; no crop (``engine/fdgan.py:37-45``). With the erase
    flags 0 it is the target transform of the GAN stages. float32 NCHW in
    channels_last memory on the card; on the CPU in the draws' dtype."""
    if img_u8.is_cuda:
        return _fd_augment_cuda(img_u8, params)
    if img_u8.device.type != "cpu":
        raise ValueError(f"fd_augment: unsupported device {img_u8.device}")
    if params.shape != (img_u8.shape[0], FD_PARAMS):
        raise ValueError(f"fd_augment: params must be ({img_u8.shape[0]}, {FD_PARAMS})")
    return fd_augment_plain(img_u8, params)


# ---------------------------------------------------------------------------
# GAN input transform (kernel K9)
# ---------------------------------------------------------------------------

GAN_MEAN = 0.5
GAN_STD = 0.5


def gan_input_transform_plain(img_u8):
    """Plain PyTorch version of K9: (N, H, W, 3) uint8 → (N, 3, H, W)
    float32 in [-1, 1], ``(x / 255 - 0.5) / 0.5``, contiguous NCHW."""
    x = to_float(img_u8.permute(0, 3, 1, 2))
    return ((x - GAN_MEAN) / GAN_STD).contiguous()


def _gan_input_cuda(img_u8):
    if img_u8.dtype != torch.uint8 or img_u8.dim() != 4 or img_u8.shape[-1] != 3 \
            or not img_u8.is_contiguous():
        raise ValueError(f"gan_input_transform takes a contiguous (N, H, W, 3) "
                         f"uint8 batch, got {tuple(img_u8.shape)} {img_u8.dtype}")
    n, h, w, c = img_u8.shape
    out = torch.empty((n, c, h, w), dtype=torch.float32, device=img_u8.device)
    GAN_INPUT(img_u8.data_ptr(), out.data_ptr(), n * h * w, h * w,
              device=img_u8.device)
    return out


def gan_input_transform(img_u8, height=128, width=64):
    """The GAN branch's input (``ops/transforms.py:160-168``): to_float →
    resize (a no-op: the loader stages the GAN image at its size) → the
    (0.5, 0.5, 0.5) normalisation, as NCHW float32 (kernel K9 on the card)."""
    if tuple(img_u8.shape[1:3]) != (height, width):
        raise ValueError(
            f"staged GAN batch is {tuple(img_u8.shape[1:3])}, expected "
            f"{(height, width)}: the GAN path takes batches staged at the GAN size")
    if img_u8.is_cuda:
        return _gan_input_cuda(img_u8)
    if img_u8.device.type != "cpu":
        raise ValueError(f"gan_input_transform: unsupported device {img_u8.device}")
    return gan_input_transform_plain(img_u8)


# ---------------------------------------------------------------------------
# Re-encode transform of generated images (kernel K12)
# ---------------------------------------------------------------------------



def _inv_scale(size, out_size, dtype=torch.float32):
    """``1 / (out_size / size)``, rounded to float32 unless ``dtype`` is
    float64, as the JAX resize's Python-float scale enters its weight
    computation in the weights' dtype."""
    inv = 1.0 / (out_size / size)
    return inv if dtype == torch.float64 else float(np.float32(inv))


def cubic_resize_weights(size, out_size, dtype=torch.float32, device=None):
    """The (size, out_size) weight matrix of ``jax.image.resize(method=
    "bicubic")`` along one axis of an upsample (jax/_src/image/scale.py
    ``compute_weight_mat``): the Keys cubic kernel with a = −0.5 at
    ``|f − i|`` for the sample point ``f = (o + 0.5) / scale − 0.5``, each
    column divided by the sum of its in-image taps. Not ``F.interpolate``'s
    bicubic (a = −0.75, clamped indices)."""
    inv = _inv_scale(size, out_size, dtype)
    f = (torch.arange(out_size, dtype=dtype, device=device) + 0.5) * inv - 0.5
    x = torch.abs(f[None] - torch.arange(size, dtype=dtype, device=device)[:, None])
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = torch.where(x >= 2.0, 0.0, w)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (f >= -0.5) & (f <= size - 0.5)
    return torch.where(inside[None], w, 0.0)


def cubic_resize(x, height, width):
    """``jax.image.resize(method="bicubic")`` of a (N, C, H, W) map upsampled
    to (height, width): ``cubic_resize_weights`` along H, then W."""
    wh = cubic_resize_weights(x.shape[2], height, x.dtype, x.device)
    ww = cubic_resize_weights(x.shape[3], width, x.dtype, x.device)
    x = torch.einsum("nchw,hk->nckw", x, wh)
    return torch.einsum("nckw,wl->nckl", x, ww)


def diff_transform_plain(gen_img, height=256, width=128):
    """Plain PyTorch version of K12, differentiable: (N, 3, H, W) generated
    images in [-1, 1] → ``(x + 1) / 2`` → the JAX bicubic resize to
    (height, width), along H, then W → ImageNet normalise; NCHW in
    channels_last memory."""
    x = cubic_resize((gen_img + 1.0) / 2.0, height, width)
    return normalize(x, _MEAN_F32, _STD_F32).contiguous(memory_format=torch.channels_last)


def _diff_transform_cuda(gen_img, height, width):
    n, c, h, w = gen_img.shape
    if gen_img.dtype != torch.float32 or c != 3 or not gen_img.is_contiguous():
        raise ValueError(f"diff_transform takes a contiguous NCHW (N, 3, H, W) "
                         f"float32 batch, got {tuple(gen_img.shape)} {gen_img.dtype}")
    if height < h or width < w:
        raise ValueError(f"diff_transform upsamples: ({h}, {w}) → ({height}, {width})")
    out = torch.empty((n, c, height, width), dtype=torch.float32,
                      device=gen_img.device, memory_format=torch.channels_last)
    DIFF_TRANSFORM(gen_img.data_ptr(), out.data_ptr(), n, h, w, height, width,
                   _inv_scale(h, height), _inv_scale(w, width), *IMAGENET_MEAN,
                   *IMAGENET_STD, device=gen_img.device)
    return out


def diff_transform(gen_img, height=256, width=128):
    """The re-encode transform of generated images (``ops/transforms.py:
    171-180``): [-1, 1] → [0, 1] → bicubic upsample to (height, width) →
    ImageNet normalise, NCHW in channels_last memory (kernel K12 on the
    card, forward only: the hard-mix step runs it under no gradient and
    stops the gradient of its features; a CUDA input that requires a
    gradient raises). The plain version on the CPU is differentiable."""
    if gen_img.is_cuda:
        if gen_img.requires_grad:
            raise ValueError("diff_transform on the card is forward only: its "
                             "input must not require a gradient")
        return _diff_transform_cuda(gen_img, height, width)
    if gen_img.device.type != "cpu":
        raise ValueError(f"diff_transform: unsupported device {gen_img.device}")
    return diff_transform_plain(gen_img, height, width)
