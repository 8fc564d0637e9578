"""Eval image transform: uint8 NHWC staging batch → normalised NCHW batch.

Port of the eval branch of ``reid_gan_tpu/ops/transforms.py::reid_augment``
(``train=False``: to_float → resize → normalize), plus the cast to the
extractor's dtype that ``engine/evaluators.py:47`` applies. The output is a
logical NCHW tensor in channels_last memory, so it is the input's own element
order and feeds cuDNN's channels_last convolutions without a copy.

The loader stages every batch at the target size (``data/loader.py``), so the
resize is a no-op on this path and the port does not carry it: a batch at any
other size raises. Resizing comes with the training slice's augmentation.

On a CUDA tensor ``eval_transform`` launches kernel K1
(``csrc/eval_transform.cu``); on a CPU tensor it runs
``eval_transform_plain``, the same arithmetic in plain PyTorch.
"""

import torch

from ..kernels import EVAL_TRANSFORM

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def to_float(img_u8):
    return img_u8.to(torch.float32) / 255.0


def normalize(x, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """Per-channel ``(x - mean) / std`` of an NCHW batch."""
    m = torch.tensor(mean, dtype=x.dtype, device=x.device).view(1, -1, 1, 1)
    s = torch.tensor(std, dtype=x.dtype, device=x.device).view(1, -1, 1, 1)
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
            "target size (resizing comes with the training augmentation)")
    if img_u8.is_cuda:
        return _eval_transform_cuda(img_u8, dtype)
    if img_u8.device.type != "cpu":
        raise ValueError(f"eval_transform: unsupported device {img_u8.device}")
    return eval_transform_plain(img_u8, dtype)
