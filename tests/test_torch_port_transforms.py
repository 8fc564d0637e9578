"""Port parity: the eval transform (kernel K1's plain version) against the
JAX package's ``reid_augment(train=False)``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp


def _batch(n=3, h=16, w=8, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3)).astype(np.uint8)


def _jax_eval(img):
    from reid_gan_tpu.ops.transforms import reid_augment

    x = reid_augment(jax.random.PRNGKey(0), jnp.asarray(img),
                     height=img.shape[1], width=img.shape[2], train=False)
    return np.asarray(x)


def test_eval_transform_fp32_matches_jax():
    """fp32 output, NHWC order of the channels_last memory: atol 1e-6 (both
    sides divide in fp32 in the same order)."""
    from reid_gan_torch.ops.transforms import eval_transform

    img = _batch()
    ref = _jax_eval(img)
    out = eval_transform(torch.from_numpy(img), 16, 8, dtype=torch.float32)
    assert out.shape == (3, 3, 16, 8)
    assert out.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, atol=1e-6,
                               rtol=0)


def test_eval_transform_bf16_matches_jax_cast():
    """bf16 output against the JAX extractor's ``astype(bfloat16)``
    (evaluators.py:47): the same fp32 values round the same way, so the
    tolerance is one bf16 step at |x| < 4 (2**-6) for a value that sits on a
    rounding boundary, and at most 0.1% of the values may take it."""
    from reid_gan_torch.ops.transforms import eval_transform

    img = _batch(seed=1)
    ref = np.asarray(jnp.asarray(_jax_eval(img)).astype(jnp.bfloat16)
                     .astype(jnp.float32))
    out = eval_transform(torch.from_numpy(img), 16, 8)
    assert out.dtype == torch.bfloat16
    got = out.float().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=2.0 ** -6, rtol=0)
    assert np.mean(got != ref) <= 1e-3


def test_eval_transform_rejects_batch_off_target_size():
    from reid_gan_torch.ops.transforms import eval_transform

    with pytest.raises(ValueError, match="target size"):
        eval_transform(torch.from_numpy(_batch()), 32, 16)
