"""Checks that the divisions K4 (``reid_gan_torch/csrc/train_augment.cu``)
replaces with products give the IEEE quotients bit for bit.

* ``unit(b)``: b / 255 as ``q = b * y``, ``q + (b - 255 q) * y`` (fma), with
  ``y = RN(1 / 255)``, for every byte b.
* ``normalise``: a / s as the same one-step correction with ``y = RN(1 / s)``,
  for the three ImageNet std values s and every float32 a with
  2^-40 <= |a| <= 1, and a = 0 (the normalised crop's a = v - mean lies in
  [-0.49, 0.6]).

The fp32 arithmetic is emulated exactly: products of two float32 values are
exact in float64; an fma's sum is rounded to float64 first, so a sum within
two float64 ulps of a float32 rounding midpoint is redone in exact rationals.
Run on the CPU; the whole range takes some minutes:

    python scripts/torch_exact_division.py            # every float
    python scripts/torch_exact_division.py --step 4099  # every 4099th float
"""

import argparse
from fractions import Fraction

import numpy as np

IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def _round_exact(x):
    """The float32 nearest to the Fraction x, ties to even."""
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.array(c).view(np.uint32)) & 1))


def fma32(a, b, c):
    """fma(a, b, c) of float32 arrays, rounded once to float32."""
    p = a.astype(np.float64) * b.astype(np.float64)
    s = p + c.astype(np.float64)
    out = s.astype(np.float32)
    near = (np.abs(s - out.astype(np.float64)) >=
            0.5 * np.abs(np.spacing(out)).astype(np.float64) - 2 * np.abs(np.spacing(s)))
    for i in np.nonzero(near)[0]:
        out[i] = _round_exact(Fraction(float(a[i])) * Fraction(float(b[i])) +
                              Fraction(float(c[i])))
    return out


def corrected_quotient(a, s):
    """q = a * y, then fma(fma(-s, q, a), y, q), y = RN(1 / s): float32."""
    a = np.asarray(a, dtype=np.float32)
    y = np.full_like(a, np.float32(1.0) / np.float32(s))
    ss = np.full_like(a, np.float32(s))
    q = a * y
    return fma32(fma32(-ss, q, a), y, q)


def byte_mismatches():
    b = np.arange(256, dtype=np.float32)
    return int(np.count_nonzero(corrected_quotient(b, 255.0) != b / np.float32(255.0)))


def quotient_mismatches(s, step=1, chunk=1 << 22):
    """Mismatches against IEEE a / s over every `step`-th float32 a with
    2^-40 <= |a| <= 1 (both signs), and a = 0; returns (mismatches, checked)."""
    s = np.float32(s)
    lo = int(np.float32(2.0 ** -40).view(np.uint32))
    hi = int(np.float32(1.0).view(np.uint32))
    bad, checked = int(corrected_quotient([0.0], s)[0] != 0.0), 1
    for start in range(lo, hi + 1, chunk * step):
        bits = np.arange(start, min(start + chunk * step, hi + 1), step, dtype=np.uint32)
        for sign in (1, -1):
            a = bits.view(np.float32) * np.float32(sign)
            q = corrected_quotient(a, s)
            bad += int(np.count_nonzero(q.view(np.uint32) != (a / s).view(np.uint32)))
            checked += a.size
    return bad, checked


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--step", type=int, default=1, help="check every STEP-th float")
    args = ap.parse_args()
    print(f"b / 255: {byte_mismatches()} mismatches of 256 bytes")
    for s in IMAGENET_STD:
        bad, checked = quotient_mismatches(s, args.step)
        print(f"a / {s}: {bad} mismatches of {checked:,} floats", flush=True)


if __name__ == "__main__":
    main()
