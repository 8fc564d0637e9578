"""Pose keypoints → Gaussian heatmaps for the pose generators (port of
``reid_gan_tpu/ops/pose.py::cords_to_map``, ``batch_cords_to_map`` and
``render_pose_peaks``; parity: CC/clustercontrast/utils/data/
pose_utils.py:52-70, FD/reid/utils/data/preprocessor.py:114-131).

18 COCO keypoints per image, ``(y, x)`` in the frame of the original image
and −1 where a joint is missing, are rescaled to the GAN frame by the
original size, floored, and rendered as ``exp(-d² / (2σ²))`` with σ 6; a
missing joint gives an all-zero map. The port returns NCHW maps ``(N, 18,
H, W)``, the layout its generator reads, where the JAX step transposes to
NHWC (engine/gan_trainers.py:169).

FD-GAN's maps (``render_pose_peaks``) are 256×128 truncated Gaussians at
landmarks already scaled to the frame, with a σ, an erased channel and a
horizontal flip per sample: the JAX step's vmap over the batch and its
joint flip with the target (models/fdgan/model.py:229-250) in one call,
NCHW ``(N, 18, H, W)``, the layout the port's ``CustomPoseGenerator`` and
``NLayerDiscriminator`` read.

On a CUDA tensor ``batch_cords_to_map`` launches kernel K10
(``csrc/pose_maps.cu``) and ``render_pose_peaks`` kernel K13
(``csrc/pose_peaks.cu``); on a CPU tensor each runs its plain PyTorch
version, the same arithmetic.
"""

import torch

from ..kernels import POSE_MAPS, POSE_PEAKS

MISSING_VALUE = -1.0

# COCO-18 skeleton and joint colours (CC/clustercontrast/utils/data/
# pose_utils.py:14-20), for ``data/pose_viz.py``
LIMB_SEQ = [
    [1, 2], [1, 5], [2, 3], [3, 4], [5, 6], [6, 7], [1, 8], [8, 9],
    [9, 10], [1, 11], [11, 12], [12, 13], [1, 0], [0, 14], [14, 16],
    [0, 15], [15, 17], [2, 16], [5, 17],
]

COLORS = [
    [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0], [170, 255, 0],
    [85, 255, 0], [0, 255, 0], [0, 255, 85], [0, 255, 170], [0, 255, 255],
    [0, 170, 255], [0, 85, 255], [0, 0, 255], [85, 0, 255], [170, 0, 255],
    [255, 0, 255], [255, 0, 170], [255, 0, 85],
]


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


def render_pose_peaks_plain(landmark, sigma, erase, flip, height=256, width=128):
    """Plain PyTorch version of K13 (``ops/pose.py:62-86`` vmapped, then the
    flip of models/fdgan/model.py:246-250): (N, K, 2) landmarks (y, x) in the
    frame, −1 missing; (N,) σ, erased channel (−1 none) and flip → (N, K, H,
    W) float32 peak-normalised truncated Gaussians, radius ⌊4σ + 0.5⌋."""
    lm = landmark.to(torch.float32)
    sig = sigma.to(torch.float32)[:, None, None, None]
    k = lm.shape[1]
    missing = (lm[..., 0] == -1) | (lm[..., 1] == -1)
    erased = torch.arange(k, device=lm.device)[None] == erase.to(torch.int64)[:, None]
    yy = torch.arange(height, dtype=torch.float32, device=lm.device)
    xx = torch.arange(width, dtype=torch.float32, device=lm.device)
    dy = yy[None, None, :, None] - lm[..., 0, None, None]
    dx = xx[None, None, None, :] - lm[..., 1, None, None]
    maps = torch.exp(-(dy * dy + dx * dx) / (2.0 * (sig * sig)))
    radius = torch.floor(4.0 * sig + 0.5)
    maps = torch.where((torch.abs(dy) <= radius) & (torch.abs(dx) <= radius), maps, 0.0)
    maps = torch.where((missing | erased)[..., None, None], 0.0, maps)
    return torch.where(flip.to(torch.bool)[:, None, None, None], torch.flip(maps, [3]), maps)


def _pose_peaks_cuda(landmark, sigma, erase, flip, height, width):
    n = landmark.shape[0]
    if landmark.dtype != torch.float32 or landmark.dim() != 3 or landmark.shape[2] != 2 \
            or not landmark.is_contiguous():
        raise ValueError(f"render_pose_peaks takes contiguous (N, K, 2) float32 "
                         f"landmarks, got {tuple(landmark.shape)} {landmark.dtype}")
    for name, t, dtype in (("sigma", sigma, torch.float32), ("erase", erase, torch.int32),
                           ("flip", flip, torch.int32)):
        if t.dtype != dtype or t.shape != (n,) or t.device != landmark.device or \
                not t.is_contiguous():
            raise ValueError(f"render_pose_peaks: {name} must be ({n},) contiguous "
                             f"{dtype} on {landmark.device}")
    k = landmark.shape[1]
    out = torch.empty((n, k, height, width), dtype=torch.float32, device=landmark.device)
    POSE_PEAKS(landmark.data_ptr(), sigma.data_ptr(), erase.data_ptr(), flip.data_ptr(),
               out.data_ptr(), n, k, height, width, device=landmark.device)
    return out


def render_pose_peaks(landmark, sigma, erase, flip, height=256, width=128):
    """FD-GAN's pose maps of a batch (kernel K13 on the card): (N, K, 2)
    landmarks, (N,) σ (float32), erased channel (int32, −1 none) and flip
    (int32, nonzero mirrors) → (N, K, height, width) float32, NCHW."""
    if landmark.is_cuda:
        return _pose_peaks_cuda(landmark, sigma, erase, flip, height, width)
    if landmark.device.type != "cpu":
        raise ValueError(f"render_pose_peaks: unsupported device {landmark.device}")
    return render_pose_peaks_plain(landmark, sigma, erase, flip, height, width)
