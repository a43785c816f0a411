"""The plain reference of a KZG commitment over an SRS of known secret tau:
sum_i c_i tau^i G = p(tau) G, with p's coefficients given as 16-bit limbs
in Montgomery form (limbs x 2^-256 mod r), as the benchmark makes them."""

from __future__ import annotations

import functools

import numpy as np

from benchmark.reference import bls12_377 as curve

R = curve.R


@functools.lru_cache(maxsize=2)
def powers(tau: int, n: int) -> tuple:
    out, acc = [], 1
    for _ in range(n):
        out.append(acc)
        acc = acc * tau % R
    return tuple(out)


def commitment(mont_limbs: np.ndarray, tau: int) -> bytes:
    """The 97-byte encoding of p(tau) G for (16, n) Montgomery limbs."""
    arr = np.ascontiguousarray(np.asarray(mont_limbs).astype("<u2").T)
    n = arr.shape[0]
    buf = arr.tobytes()
    pw = powers(tau, n)
    total = sum(int.from_bytes(buf[32 * i:32 * i + 32], "little") * pw[i] for i in range(n))
    return curve.to_bytes(curve.mul(total % R * curve.FR_MONT_RINV))
