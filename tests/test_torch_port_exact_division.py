"""The divisions that kernel K4 computes as a product and one fma correction
(``reid_gan_torch/csrc/train_augment.cu``: ``unit`` and ``normalise``) give the
IEEE quotients bit for bit: every byte over 255, and a sample of every
float32 a in [-1, 1] over each ImageNet std value. The whole range is checked
by ``scripts/torch_exact_division.py``; the fp32 arithmetic is emulated in
numpy, exactly, so the check runs on the CPU."""

import importlib.util
import os.path as osp

import numpy as np
import pytest

_SCRIPT = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "scripts",
                   "torch_exact_division.py")
_spec = importlib.util.spec_from_file_location("torch_exact_division", _SCRIPT)
exact = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(exact)


def test_byte_over_255_is_the_ieee_quotient():
    assert exact.byte_mismatches() == 0


@pytest.mark.parametrize("s", [float(v) for v in exact.IMAGENET_STD])
def test_normalising_quotient_is_the_ieee_quotient(s):
    bad, checked = exact.quotient_mismatches(np.float32(s), step=1009)
    assert bad == 0 and checked > 600_000


def test_fma_emulation_rounds_once():
    """The emulated fma rounds b d + c once. (2^-24 (1 + 2^-23)) (1 - 2^-23)
    + (1 + 2^-23) lies 2^-70 below the float32 midpoint 1 + 2^-23 + 2^-24:
    rounded once it is 1 + 2^-23, while rounding to float64 first lands on
    the midpoint and then on the even 1 + 2^-22."""
    b = np.array([2.0 ** -24 * (1 + 2.0 ** -23)], dtype=np.float32)
    d = np.array([1 - 2.0 ** -23], dtype=np.float32)
    c = np.array([1 + 2.0 ** -23], dtype=np.float32)
    naive = (b.astype(np.float64) * d + c).astype(np.float32)
    assert naive[0] == np.float32(1 + 2.0 ** -22)
    assert exact.fma32(b, d, c)[0] == np.float32(1 + 2.0 ** -23)
