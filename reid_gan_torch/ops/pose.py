"""Pose keypoints → Gaussian heatmaps for the pose generator (port of
``reid_gan_tpu/ops/pose.py::cords_to_map`` and ``batch_cords_to_map``;
parity: CC/clustercontrast/utils/data/pose_utils.py:52-70).

18 COCO keypoints per image, ``(y, x)`` in the frame of the original image
and −1 where a joint is missing, are rescaled to the GAN frame by the
original size, floored, and rendered as ``exp(-d² / (2σ²))`` with σ 6; a
missing joint gives an all-zero map. The port returns NCHW maps ``(N, 18,
H, W)``, the layout its generator reads, where the JAX step transposes to
NHWC (engine/gan_trainers.py:169).

On a CUDA tensor ``batch_cords_to_map`` launches kernel K10
(``csrc/pose_maps.cu``); on a CPU tensor it runs the plain PyTorch version,
the same arithmetic. ``render_pose_peaks`` (FD-GAN's maps) is not ported yet
(ROADMAP B7).
"""

import torch

from ..kernels import POSE_MAPS

MISSING_VALUE = -1.0


def batch_cords_to_map_plain(cords, old_size, height=128, width=64, sigma=6.0):
    """Plain PyTorch version of K10: (N, K, 2) fp32 keypoints and (N, 2) fp32
    original sizes → (N, K, H, W) fp32 maps (``ops/pose.py:51-59``)."""
    cords = cords.to(torch.float32)
    old_size = old_size.to(torch.float32)
    missing = (cords[..., 0] == MISSING_VALUE) | (cords[..., 1] == MISSING_VALUE)
    y0 = torch.floor(cords[..., 0] / old_size[:, None, 0] * height)
    x0 = torch.floor(cords[..., 1] / old_size[:, None, 1] * width)
    yy = torch.arange(height, dtype=torch.float32, device=cords.device)
    xx = torch.arange(width, dtype=torch.float32, device=cords.device)
    d2 = (yy[None, None, :, None] - y0[..., None, None]) ** 2 + \
        (xx[None, None, None, :] - x0[..., None, None]) ** 2
    maps = torch.exp(-d2 / (2.0 * sigma ** 2))
    return torch.where(missing[..., None, None], 0.0, maps)


def _pose_maps_cuda(cords, old_size, height, width, sigma):
    n = cords.shape[0]
    if cords.dtype != torch.float32 or cords.dim() != 3 or cords.shape[2] != 2 \
            or not cords.is_contiguous():
        raise ValueError(f"batch_cords_to_map takes contiguous (N, K, 2) float32 "
                         f"keypoints, got {tuple(cords.shape)} {cords.dtype}")
    if old_size.dtype != torch.float32 or old_size.shape != (n, 2) or \
            old_size.device != cords.device or not old_size.is_contiguous():
        raise ValueError(f"batch_cords_to_map: old_size must be ({n}, 2) contiguous "
                         f"float32 on {cords.device}")
    k = cords.shape[1]
    out = torch.empty((n, k, height, width), dtype=torch.float32, device=cords.device)
    POSE_MAPS(cords.data_ptr(), old_size.data_ptr(), out.data_ptr(), n, k, height,
              width, 2.0 * sigma ** 2, device=cords.device)
    return out


def batch_cords_to_map(cords, old_size, height=128, width=64, sigma=6.0):
    """The pose maps of a batch (``ops/pose.py:89``; kernel K10 on the card):
    (N, K, 2) keypoints, (N, 2) original sizes → (N, K, height, width)."""
    if cords.is_cuda:
        return _pose_maps_cuda(cords, old_size, height, width, sigma)
    if cords.device.type != "cpu":
        raise ValueError(f"batch_cords_to_map: unsupported device {cords.device}")
    return batch_cords_to_map_plain(cords, old_size, height, width, sigma)


def cords_to_map(cords, old_size, height=128, width=64, sigma=6.0):
    """One image's maps (``ops/pose.py:41-59``): (K, 2) keypoints and (2,)
    original size → (K, height, width)."""
    return batch_cords_to_map(cords[None], old_size[None], height, width, sigma)[0]
