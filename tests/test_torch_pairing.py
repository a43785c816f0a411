"""The port's host pairing (crypto/ref/pairing.py, pure Python) against the
golden vectors and the JAX package's reference: the Fq2/Fq12 tower, G2
scalar multiples, and e(G, H)."""

import json
import os
import random

import pytest

from snarkos_tpu.crypto.ref import pairing as jpairing
from snarkos_tpu_torch.crypto import params
from snarkos_tpu_torch.crypto.ref import g1, pairing

FIX = json.load(open(os.path.join(os.path.dirname(__file__), "fixtures", "golden.json")))
Q = params.FQ_MODULUS


def _flat(v):
    if isinstance(v, (tuple, list)):
        return [s for x in v for s in _flat(x)]
    return [str(v)]


def _f12(rng):
    return tuple((rng.randrange(Q), rng.randrange(Q)) for _ in range(6))


def test_tower_matches_jax():
    rng = random.Random(5)
    for _ in range(3):
        a, b = _f12(rng), _f12(rng)
        assert pairing.f12_mul(a, b) == jpairing.f12_mul(a, b)
        assert pairing.f12_inv(a) == jpairing.f12_inv(a)
        assert pairing.f12_mul(a, pairing.f12_inv(a)) == pairing.F12_ONE
        assert pairing.f2_inv(a[0]) == jpairing.f2_inv(a[0])
    assert pairing.FINAL_EXP == jpairing.FINAL_EXP


def test_g2_scalar_mul_matches_golden():
    for row in FIX["g2_multiples"]:
        q = pairing.g2_scalar_mul(int(row["k"]), pairing.G2_GENERATOR)
        assert [str(c) for c in q[0]] == row["x"]
        assert [str(c) for c in q[1]] == row["y"]
        assert pairing.g2_on_curve(q)
    assert pairing.g2_scalar_mul(params.FR_MODULUS, pairing.G2_GENERATOR) is None
    assert pairing.g2_scalar_mul(7, None) is None
    h = pairing.G2_GENERATOR
    assert pairing.g2_add(h, pairing.g2_neg(h)) is None


def test_pairing_matches_golden():
    e = pairing.pairing(g1.affine(g1.GENERATOR), pairing.G2_GENERATOR)
    assert _flat(e) == FIX["pairing_e_g1_g2"]
    assert pairing.miller_loop(g1.INFINITY, pairing.G2_GENERATOR) == pairing.F12_ONE


@pytest.mark.slow
def test_pairing_bilinear_and_check():
    """e(aG, bH) equals the golden value, and pairing_check accepts
    e(aG, bH) e(-abG, H) and rejects e(aG, bH) e(-G, H)."""
    row = FIX["pairing_bilinear_ab"]
    a, b = row["a"], row["b"]
    aG = g1.affine(g1.scalar_mul(a, g1.GENERATOR))
    bH = pairing.g2_scalar_mul(b, pairing.G2_GENERATOR)
    assert _flat(pairing.pairing(aG, bH)) == row["value"]
    abG = g1.affine(g1.neg(g1.scalar_mul(a * b, g1.GENERATOR)))
    assert pairing.pairing_check([(aG, bH), (abG, pairing.G2_GENERATOR)])
    negG = g1.affine(g1.neg(g1.GENERATOR))
    assert not pairing.pairing_check([(aG, bH), (negG, pairing.G2_GENERATOR)])
