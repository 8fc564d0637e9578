"""Port parity: the train augmentation (kernel K4's plain version) against the
JAX package's ``reid_augment(train=True)``, with JAX's random draws recomputed
from the same key in its split order and fed to ``train_augment``; crops at
the borders and chosen erase rectangles against the JAX pieces; and the
ranges of ``sample_augment_params``.

Tolerances, on normalised fp32 values (|x| < 2.7). Against the JAX pieces
fed the same crop rectangle: 1e-5, rounding alone; the port forms the source
coordinate (o + 0.5) * inv - translation * inv as the one fused multiply-add
that XLA compiles there, so the linear weights agree bit for bit. Against
the whole jitted ``reid_augment``: at most 1e-4 and a mean of at most 2e-6.
There XLA compiles the draws and the crop into one program and may round
the rectangle differently from the same draws made alone (the draws agree
bit for bit, the crops of some images do not): an ulp of a coordinate near
60 is 3.8e-6, a linear weight moves by as much, and a pixel step of 1 by
that over the smallest std, 0.225 (2.9e-5 seen at most)."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp


def _close(got, ref, max_err, mean_err):
    err = np.abs(got - ref)
    assert err.max() <= max_err, err.max()
    assert err.mean() <= mean_err, err.mean()


def _jax_draws(key, n, h, w):
    """The draws of reid_augment(key, train=True) (transforms.py:152-156 →
    :61, :96-102, :116-124), as the port's (n, 10) parameter rows."""
    k1, k2, k3 = jax.random.split(key, 3)
    flip = jax.random.bernoulli(k1, 0.5, (n,))
    ka, kb, kc, kd = jax.random.split(k2, 4)
    area = h * w * jax.random.uniform(ka, (n,), minval=0.64, maxval=1.0)
    aspect = jax.random.uniform(kb, (n,), minval=2.0, maxval=3.0)
    ch = jnp.clip(jnp.sqrt(area * aspect), 1.0, float(h))
    cw = jnp.clip(jnp.sqrt(area / aspect), 1.0, float(w))
    top = jax.random.uniform(kc, (n,)) * (h - ch)
    left = jax.random.uniform(kd, (n,)) * (w - cw)
    keys = jax.random.split(k3, 5)
    erase = jax.random.bernoulli(keys[0], 0.5, (n,))
    e_area = h * w * jax.random.uniform(keys[1], (n,), minval=0.02, maxval=0.4)
    e_aspect = jnp.exp(jax.random.uniform(keys[2], (n,), minval=jnp.log(0.3),
                                          maxval=jnp.log(1.0 / 0.3)))
    eh = jnp.clip(jnp.round(jnp.sqrt(e_area * e_aspect)), 1, h)
    ew = jnp.clip(jnp.round(jnp.sqrt(e_area / e_aspect)), 1, w)
    et = jnp.floor(jax.random.uniform(keys[3], (n,)) * (h - eh + 1))
    el = jnp.floor(jax.random.uniform(keys[4], (n,)) * (w - ew + 1))
    cols = (flip, top, left, ch, cw, erase, et, el, eh, ew)
    return np.stack([np.asarray(c, np.float32) for c in cols], axis=1)


def _batch(n, h, w, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3)).astype(np.uint8)


def _port(img, params):
    from reid_gan_torch.ops.transforms import train_augment

    out = train_augment(torch.from_numpy(img), torch.from_numpy(params),
                        img.shape[1], img.shape[2])
    assert out.dtype == torch.float32
    assert out.is_contiguous(memory_format=torch.channels_last)
    return out.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_train_augment_matches_reid_augment(seed):
    """Batch 16 at 64x32 through both, for four keys: flips, crops and
    erases as JAX draws them (each key has images with and without flip and
    erase)."""
    from reid_gan_tpu.ops.transforms import reid_augment

    n, h, w = 16, 64, 32
    img = _batch(n, h, w, seed)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(reid_augment(key, jnp.asarray(img), height=h, width=w,
                                  train=True))
    params = _jax_draws(key, n, h, w)
    assert 0 < params[:, 0].sum() < n and 0 < params[:, 5].sum() < n
    _close(_port(img, params), ref, max_err=1e-4, mean_err=2e-6)


def _jax_pieces(img, params):
    """The JAX package's flip → _crop_resize_one → normalize, and the
    masked mean fill of random_erasing (:125-134), for chosen parameters."""
    from reid_gan_tpu.ops.transforms import _crop_resize_one, hflip, normalize, to_float

    n, h, w, _ = img.shape
    x = to_float(jnp.asarray(img))
    p = jnp.asarray(params)
    x = jnp.where((p[:, 0] != 0)[:, None, None, None], hflip(x), x)
    x = jax.jit(jax.vmap(_crop_resize_one, in_axes=(0, 0, 0, 0, 0, None, None)),
                static_argnums=(5, 6))(x, p[:, 1], p[:, 2], p[:, 3], p[:, 4], h, w)
    x = normalize(x)
    yy = jnp.arange(h, dtype=jnp.float32)[None, :, None]
    xx = jnp.arange(w, dtype=jnp.float32)[None, None, :]
    q = p[:, :, None, None]
    inside = ((yy >= q[:, 6]) & (yy < q[:, 6] + q[:, 8]) & (xx >= q[:, 7])
              & (xx < q[:, 7] + q[:, 9]) & (q[:, 5] != 0))
    return np.asarray(jnp.where(inside[..., None], jnp.mean(x, axis=(1, 2),
                                                            keepdims=True), x))


def test_train_augment_at_the_borders_matches_jax():
    """Crops flush with each border and each corner, the whole image, a
    1x1 crop, a flipped crop; erase rectangles of one pixel, of the whole
    image and at the far corner; no flip and no erase."""
    h, w = 32, 16
    rows = [  # flip, top, left, crop_h, crop_w, erase, e_top, e_left, e_h, e_w
        (0, 0.0, 0.0, 20.5, 7.25, 0, 0, 0, 1, 1),          # top-left corner
        (0, 11.5, 8.75, 20.5, 7.25, 1, 31, 15, 1, 1),      # bottom-right; 1 px
        (1, 0.0, 8.75, 20.5, 7.25, 1, 0, 0, 32, 16),       # top-right; whole
        (0, 11.5, 0.0, 20.5, 7.25, 0, 0, 0, 1, 1),         # bottom-left
        (0, 0.0, 0.0, 32.0, 16.0, 0, 0, 0, 1, 1),          # the whole image
        (1, 0.0, 0.0, 32.0, 16.0, 1, 3, 2, 5, 4),          # flipped whole
        (0, 5.3, 3.1, 1.0, 1.0, 0, 0, 0, 1, 1),            # a 1x1 crop
        (1, 2.25, 1.5, 27.0, 13.0, 1, 20, 9, 12, 7),       # erase at far corner
    ]
    params = np.asarray(rows, np.float32)
    img = _batch(len(rows), h, w, 7)
    _close(_port(img, params), _jax_pieces(img, params), max_err=1e-5,
           mean_err=1e-6)


def test_sample_augment_params_stays_in_range():
    """4,096 draws: flips and erases near one half; crop area in
    [0.64, 1]·HW and aspect h/w in [2, 3] before the clamp, rectangles
    inside the image; erase sides whole numbers in range and corners so the
    rectangle fits."""
    from reid_gan_torch.ops.transforms import sample_augment_params

    n, h, w = 4096, 256, 128
    p = sample_augment_params(n, h, w, torch.Generator().manual_seed(0)).numpy()
    assert p.shape == (n, 10) and p.dtype == np.float32
    assert set(np.unique(p[:, 0])) == {0.0, 1.0} and abs(p[:, 0].mean() - 0.5) < 0.05
    assert set(np.unique(p[:, 5])) == {0.0, 1.0} and abs(p[:, 5].mean() - 0.5) < 0.05
    top, left, ch, cw = p[:, 1], p[:, 2], p[:, 3], p[:, 4]
    assert (ch >= 1).all() and (ch <= h).all() and (cw >= 1).all() and (cw <= w).all()
    assert (top >= 0).all() and (top + ch <= h + 1e-3).all()
    assert (left >= 0).all() and (left + cw <= w + 1e-3).all()
    free = ch < h                      # not clamped: the drawn area survives
    assert ((ch * cw)[free] >= 0.64 * h * w * (1 - 1e-5)).all()
    assert ((ch * cw)[free] <= h * w * (1 + 1e-5)).all()
    assert ((ch / cw)[free] >= 2 - 1e-4).all()
    et, el, eh, ew = p[:, 6], p[:, 7], p[:, 8], p[:, 9]
    for v, hi in ((eh, h), (ew, w)):
        assert (v == np.round(v)).all() and (v >= 1).all() and (v <= hi).all()
    assert (et == np.floor(et)).all() and (et >= 0).all() and (et + eh <= h).all()
    assert (el == np.floor(el)).all() and (el >= 0).all() and (el + ew <= w).all()
    small = (eh < h) & (ew < w) & (eh > 1) & (ew > 1)
    aspect = eh[small] / ew[small]
    assert aspect.min() > 0.3 / 2 and aspect.max() < 2 / 0.3
    assert math.isclose(float(np.log(eh * ew / (h * w)).mean()),
                        float(np.log(np.linspace(0.02, 0.4, 10001)).mean()),
                        abs_tol=0.1)


def test_train_augment_rejects_a_batch_off_target_size():
    from reid_gan_torch.ops.transforms import train_augment

    params = torch.zeros((2, 10))
    with pytest.raises(ValueError, match="target size"):
        train_augment(torch.zeros((2, 16, 8, 3), dtype=torch.uint8), params, 32, 16)
