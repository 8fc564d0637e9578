"""Pose skeleton rendering for visual dumps, host-side numpy (port of
``reid_gan_tpu/data/pose_viz.py``; parity: CC/clustercontrast/utils/data/
pose_utils.py: ``map_to_cord`` :29-49, ``draw_pose_from_cords`` :73-94 with
the COCO-18 ``LIMB_SEQ``/``COLORS`` of :14-20, ``draw_pose_from_map``
:97-99). Renders 18-channel maps as skeleton images for the HTML gallery."""

import numpy as np

from ..ops.pose import COLORS, LIMB_SEQ

MISSING_VALUE = -1


def map_to_cord(pose_map, threshold=0.1):
    """(H, W, K) heatmaps → (18, 2) peak (y, x) coordinates, −1 where a
    channel's peak is at or below ``threshold`` (or missing)."""
    k = min(pose_map.shape[-1], 18)
    coords = np.full((18, 2), MISSING_VALUE, np.int64)
    for i in range(k):
        m = pose_map[..., i]
        if m.max() > threshold:
            coords[i] = np.unravel_index(np.argmax(m), m.shape)
    return coords


def _draw_line(img, mask, y0, x0, y1, x1, color):
    """A DDA line, rounded to pixels (in place of skimage.draw.line_aa)."""
    n = int(max(abs(y1 - y0), abs(x1 - x0))) + 1
    ys = np.linspace(y0, y1, n).round().astype(int)
    xs = np.linspace(x0, x1, n).round().astype(int)
    valid = (ys >= 0) & (ys < img.shape[0]) & (xs >= 0) & (xs < img.shape[1])
    img[ys[valid], xs[valid]] = color
    mask[ys[valid], xs[valid]] = True


def _draw_disk(img, mask, y, x, radius, color):
    h, w = img.shape[:2]
    yy, xx = np.ogrid[:h, :w]
    sel = (yy - y) ** 2 + (xx - x) ** 2 <= radius ** 2
    img[sel] = color
    mask[sel] = True


def draw_pose_from_cords(pose_joints, img_size, radius=2, draw_joints=True):
    """(18, 2) joints → (uint8 (H, W, 3) colours, bool (H, W) mask): the
    limbs between present joints in white (with ``draw_joints``), then a
    disk of ``radius`` in each present joint's colour."""
    colors = np.zeros(img_size + (3,), np.uint8)
    mask = np.zeros(img_size, bool)
    if draw_joints:
        for f, t in LIMB_SEQ:
            if MISSING_VALUE in pose_joints[f] or MISSING_VALUE in pose_joints[t]:
                continue
            _draw_line(colors, mask, *pose_joints[f], *pose_joints[t],
                       color=(255, 255, 255))
    for i, joint in enumerate(pose_joints):
        if MISSING_VALUE in joint:
            continue
        _draw_disk(colors, mask, joint[0], joint[1], radius, COLORS[i])
    return colors, mask


def draw_pose_from_map(pose_map, threshold=0.1, **kwargs):
    """``draw_pose_from_cords`` of ``map_to_cord(pose_map, threshold)``."""
    cords = map_to_cord(pose_map, threshold=threshold)
    return draw_pose_from_cords(cords, pose_map.shape[:2], **kwargs)
