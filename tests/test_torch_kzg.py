"""The port's KZG eval/quotient and geometric powers (plain PyTorch on the
CPU) against the JAX package: its ops/ntt.geometric_powers, and its host
KZG (crypto/ref/kzg.py synthetic division, crypto/ref/ntt.py evaluation)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snarkos_tpu.crypto import params
from snarkos_tpu.crypto.ref import ntt as jref_ntt
from snarkos_tpu.ops import ntt as jntt
from snarkos_tpu_torch.ops import kzg
from snarkos_tpu_torch.ops.fieldspec import FR
from snarkos_tpu_torch.ops.ntt import geometric_powers

# the plain versions run many small tensor ops: intra-op threads only add
# contention when test workers share the CPU
torch.set_num_threads(1)

R = params.FR_MODULUS


def _enc(vals):
    return torch.from_numpy(np.ascontiguousarray(FR.encode_fast(vals, mont=True)))


def _quotient(coeffs, z):
    """Synthetic division of (p(X) - p(z)) by (X - z), as crypto/ref/kzg.py
    open_at computes it, zero-padded to len(coeffs)."""
    q = [0] * (len(coeffs) - 1)
    carry = 0
    for i in range(len(coeffs) - 1, 0, -1):
        carry = (coeffs[i] + carry * z) % R
        q[i - 1] = carry
    return q + [0]


def test_geometric_powers_match_jax():
    base = _enc([0x1234567890ABCDEF])
    want = np.asarray(jntt.geometric_powers(jnp.asarray(base.numpy()), 64))
    np.testing.assert_array_equal(geometric_powers(base, 64).numpy(), want)
    np.testing.assert_array_equal(geometric_powers(base, 1).numpy(), want[:, :1])


def test_geometric_powers_batched_blocks():
    """A (L, B, 1) base, and more than one block of 2^12 powers."""
    bases = [3, R - 1, 0x5EED]
    got = geometric_powers(_enc(bases).unsqueeze(-1), 4100)
    for i, b in enumerate(bases):
        vals = FR.decode_fast(got[:, i, :].numpy(), mont=True)
        assert vals[:3] == [1, b % R, b * b % R]
        assert vals[4097:] == [pow(b, k, R) for k in range(4097, 4100)]


def test_eval_and_quotient_multi_matches_synthetic_division():
    rng = random.Random(8)
    n, B = 64, 3
    coeffs = [[rng.randrange(R) for _ in range(n)] for _ in range(B)]
    zs = [rng.randrange(1, R) for _ in range(B)]
    c = torch.stack([_enc(row) for row in coeffs], dim=1)  # (L, B, n)
    ys, q = kzg.eval_and_quotient_multi(c, zs)
    assert ys == [jref_ntt.poly_eval(row, z) for row, z in zip(coeffs, zs)]
    for i in range(B):
        np.testing.assert_array_equal(q[:, i].numpy(), _enc(_quotient(coeffs[i], zs[i])).numpy())


def test_eval_and_quotient_single_and_zero_point():
    rng = random.Random(9)
    coeffs = [rng.randrange(R) for _ in range(16)]
    y, q = kzg.eval_and_quotient(_enc(coeffs), 77)
    assert y == jref_ntt.poly_eval(coeffs, 77) == kzg.poly_eval(_enc(coeffs), 77)
    np.testing.assert_array_equal(q.numpy(), _enc(_quotient(coeffs, 77)).numpy())
    # z = 0: y = c_0, q = the shifted coefficients
    ys, q = kzg.eval_and_quotient_multi(torch.stack([_enc(coeffs)] * 2, dim=1), [0, 5])
    assert ys == [coeffs[0], jref_ntt.poly_eval(coeffs, 5)]
    np.testing.assert_array_equal(q[:, 0].numpy(), _enc(coeffs[1:] + [0]).numpy())


def test_host_commit_and_open_match_jax():
    """The port's plain host ``crypto/ref/kzg.commit`` / ``open_at`` (the
    Varuna prover's default without a device) against the JAX package's, on
    a degree-8 SRS, with the same affine points and evaluations; the opening
    verifies on the port's host pairing."""
    from snarkos_tpu.crypto.ref import g1 as jref_g1, kzg as jref_kzg
    from snarkos_tpu_torch.crypto.ref import g1 as ref_g1, kzg as ref_kzg

    tau = pow(params.FR_GENERATOR, 0xDEADBEEF, R)
    srs = ref_kzg.SRS.setup(8, tau=tau)
    jsrs = jref_kzg.SRS(powers_g1=list(srs.powers_g1), h=srs.h, tau_h=srs.tau_h)
    rng = random.Random(18)
    coeffs = [rng.randrange(R) for _ in range(9)]
    z = rng.randrange(R)
    assert ref_g1.affine(ref_kzg.commit(srs, coeffs)) == \
        jref_g1.affine(jref_kzg.commit(jsrs, coeffs))
    y, w = ref_kzg.open_at(srs, coeffs, z)
    jy, jw = jref_kzg.open_at(jsrs, coeffs, z)
    assert y == jy and ref_g1.affine(w) == jref_g1.affine(jw)
    assert ref_kzg.open_at(srs, coeffs[:1], z) == (coeffs[0], ref_g1.INFINITY)
    assert ref_kzg.verify(srs, ref_kzg.commit(srs, coeffs), z, y, w)
