"""Images held in memory in place of decoded files, for the loader's
``cache`` (``Preprocessor(cache=)``, the CLIs' ``run(image_cache=)``): an
object with ``get(fpath, height, width)`` → ``(uint8 HWC image, original
(H, W))`` and ``budget``. They let a run feed the loader without Pillow,
which the card's machine lacks.

- ``InMemoryImages``: arrays staged at the re-ID size and the GAN size,
  indexed by a file name's last ``_`` field.
- ``NamedImages``: each name's image at its own size (a synthetic set's
  ``images``), resized on the way out as the decode cache resizes a decoded
  file (``pil_bilinear``).
"""

import os.path as osp

import numpy as np


class InMemoryImages:
    """Stands in for the loader's decode cache: file name → a staged uint8
    image of a numpy array (``imgs`` at the re-ID size, ``gan_imgs`` at the
    GAN size) and the original size ``old_size``. The index is the name's
    last ``_`` field. Budget 0, so the loader gathers per item."""
    budget = 0

    def __init__(self, imgs, gan_imgs=None, old_size=(256.0, 128.0)):
        self.imgs, self.gan_imgs = imgs, gan_imgs
        self.old_size = np.asarray(old_size, np.float32)

    def get(self, fpath, height, width):
        i = int(osp.basename(fpath).split(".")[0].rsplit("_", 1)[-1])
        src = self.imgs if height == self.imgs.shape[1] else self.gan_imgs
        return src[i], self.old_size


class NamedImages:
    """Stands in for the loader's decode cache: base name → a uint8 HWC
    image at its own size, which is the original size; ``get`` resizes it
    to (height, width) with ``pil_bilinear``, as the decode cache resizes a
    decoded file. Its ``budget`` (bytes, the decode cache's default) lets
    the loader pack the set into one array and gather each batch from it
    (``Preprocessor.batchable``)."""
    budget = 4 << 30

    def __init__(self, images):
        self.images = images
        self._resized = {}

    def get(self, fpath, height, width):
        name = osp.basename(fpath)
        key = (name, height, width)
        hit = self._resized.get(key)
        if hit is None:
            img = self.images[name]
            # each (name, size) resized once, as the decode cache decodes once
            hit = pil_bilinear(img, height, width), np.asarray(img.shape[:2], np.float32)
            self._resized[key] = hit
        return hit


_PRECISION_BITS = 22          # Pillow's fixed point for 8-bit resampling


def _coefficients(n_in, n_out):
    """Pillow's bilinear (triangle) resampling weights from ``n_in`` to
    ``n_out`` samples, widened by the scale when shrinking, normalised per
    output and rounded to its fixed point (libImaging/Resample.c,
    precompute_coeffs and normalize_coeffs_8bpc): an (n_out, n_in) int64
    matrix."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = filterscale                  # the triangle's support is 1
    out = np.zeros((n_out, n_in), np.int64)
    for j in range(n_out):
        center = (j + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        x = (np.arange(lo, hi) - center + 0.5) / filterscale
        w = np.maximum(1.0 - np.abs(x), 0.0)
        if w.sum() != 0.0:
            w = w / w.sum()
        out[j, lo:hi] = np.where(w < 0, -0.5 + w * (1 << _PRECISION_BITS),
                                 0.5 + w * (1 << _PRECISION_BITS)).astype(np.int64)
    return out


def _resample(img, coef, axis):
    moved = np.moveaxis(img.astype(np.int64), axis, -1)
    acc = moved @ coef.T + (1 << (_PRECISION_BITS - 1))
    return np.moveaxis(np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8), -1, axis)


def pil_bilinear(img, height, width):
    """``np.asarray(Image.fromarray(img).resize((width, height),
    Image.BILINEAR))`` for a uint8 HWC image, bit for bit, in numpy: the
    horizontal pass first, rounded to uint8, then the vertical; the image
    itself at its own size."""
    h, w = img.shape[:2]
    if (h, w) == (height, width):
        return img
    if w != width:
        img = _resample(img, _coefficients(w, width), 1)
    if h != height:
        img = _resample(img, _coefficients(h, height), 0)
    return img
