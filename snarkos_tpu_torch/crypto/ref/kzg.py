"""Host KZG verification over BLS12-377 (the port's own copy of the SRS and
the verifier of ``snarkos_tpu/crypto/ref/kzg.py``).

    verify(C, z, y, W):  e(C - y G, H) == e(W, tau H - z H)

Commitments and openings are computed on the device (``ops/kzg.py``); this
module holds the SRS's host side, the pairing equations (the ground truth of
``ops/kzg.batch_verify``) and ``commit`` / ``open_at``, the plain host
references of the device commitment.
"""

from __future__ import annotations

from dataclasses import dataclass

from snarkos_tpu_torch.crypto import params
from snarkos_tpu_torch.crypto.ref import g1, ntt, pairing

R = params.FR_MODULUS


@dataclass
class SRS:
    """Structured reference string: the G1 powers and the two G2 points the
    verifier needs."""

    powers_g1: list  # [G, tau G, ..., tau^d G] as Jacobian tuples
    h: tuple  # G2 generator (affine Fq2 pair)
    tau_h: tuple  # tau * H

    @classmethod
    def setup(cls, degree: int, tau: int | None = None, seed: int = 0x5EED) -> "SRS":
        """Test-only trusted setup on the host (double-and-add a power; fine
        for test degrees). The default tau is the JAX package's."""
        if tau is None:
            tau = pow(params.FR_GENERATOR, seed + 12345, R)
        powers, acc = [], 1
        for _ in range(degree + 1):
            powers.append(g1.scalar_mul(acc, g1.GENERATOR))
            acc = acc * tau % R
        h = pairing.G2_GENERATOR
        return cls(powers_g1=powers, h=h, tau_h=pairing.g2_scalar_mul(tau, h))


def commit(srs: SRS, coeffs: list[int]):
    """sum_i coeffs[i] tau^i G on the host (``g1.msm``): the plain
    reference of the device commitment (``ops/kzg.commit``), which every
    path with a device takes."""
    assert len(coeffs) <= len(srs.powers_g1)
    return g1.msm(coeffs, srs.powers_g1[: len(coeffs)])


def open_at(srs: SRS, coeffs: list[int], z: int):
    """(y, witness) with y = p(z) and witness = commit(q), q = (p - y) / (X -
    z) by synthetic division."""
    y = ntt.poly_eval(coeffs, z)
    q = [0] * (len(coeffs) - 1)
    carry = 0
    for i in range(len(coeffs) - 1, 0, -1):
        carry = (coeffs[i] + carry * z) % R
        q[i - 1] = carry
    witness = commit(srs, q) if q else g1.INFINITY
    return y, witness


def verify(srs: SRS, commitment, z: int, y: int, witness) -> bool:
    """e(C - y G, H) == e(W, tau H - z H)."""
    lhs_g1 = g1.add(commitment, g1.neg(g1.scalar_mul(y, g1.GENERATOR)))
    rhs_g2 = pairing.g2_add(srs.tau_h, pairing.g2_neg(pairing.g2_scalar_mul(z, srs.h)))
    # e(lhs, H) * e(-W, rhs) == 1
    return pairing.pairing_check(
        [
            (g1.affine(lhs_g1), srs.h),
            (g1.affine(g1.neg(witness)), rhs_g2),
        ]
    )


def batch_verify(srs: SRS, openings, rng_seed: int = 1) -> bool:
    """Random-linear-combination batch verification of (C, z, y, W) tuples:
        prod_i e(C_i - y_i G + z_i W_i, H)^(gamma^i) * e(-W_i, tau H)^(gamma^i) == 1
    with gamma = 5^(rng_seed + 7)."""
    gamma = pow(5, rng_seed + 7, R)
    acc_left = g1.INFINITY  # sum gamma^i (C_i - y_i G + z_i W_i)
    acc_w = g1.INFINITY  # sum gamma^i W_i
    coeff = 1
    for commitment, z, y, witness in openings:
        term = g1.add(commitment, g1.neg(g1.scalar_mul(y, g1.GENERATOR)))
        term = g1.add(term, g1.scalar_mul(z, witness))
        acc_left = g1.add(acc_left, g1.scalar_mul(coeff, term))
        acc_w = g1.add(acc_w, g1.scalar_mul(coeff, witness))
        coeff = coeff * gamma % R
    return pairing.pairing_check(
        [
            (g1.affine(acc_left), srs.h),
            (g1.affine(g1.neg(acc_w)), srs.tau_h),
        ]
    )
