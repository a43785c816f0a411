"""The port's batched Poseidon sponge (plain PyTorch on the CPU) against the
JAX package's host Poseidon and the golden vectors; a slow test compares it
limb for limb with the JAX package's ops/poseidon.hash_fixed."""

import json
import os
import random

import numpy as np
import pytest
import torch

from snarkos_tpu.crypto import params
from snarkos_tpu.crypto.ref import poseidon as jref
from snarkos_tpu_torch.crypto.ref import poseidon as ref
from snarkos_tpu_torch.ops import poseidon
from snarkos_tpu_torch.ops.fieldspec import FR

# the plain versions run many small tensor ops: intra-op threads only add
# contention when test workers share the CPU
torch.set_num_threads(1)

FIX = json.load(open(os.path.join(os.path.dirname(__file__), "fixtures", "golden.json")))
DOMAIN = "snarkos_tpu.puzzle.coeff"


def _inputs(rows):
    """rows: per lane a list of field elements -> (n, L, B) Montgomery."""
    n = len(rows[0])
    return torch.stack([torch.from_numpy(np.ascontiguousarray(
        FR.encode_fast([r[k] for r in rows], mont=True))) for k in range(n)])


def _decode(t):
    return FR.decode_fast(t.numpy(), mont=True)


def test_host_copy_matches_jax_package():
    """The port's own copy of the host sponge and its Grain-LFSR constants."""
    for rate in (2, 4):
        assert ref.poseidon_params(rate) == jref.poseidon_params(rate)
    rng = random.Random(4)
    for n in (1, 2, 3, 5):
        xs = [rng.randrange(params.FR_MODULUS) for _ in range(n)]
        assert ref.hash_many(xs, 2, 2, "d") == jref.hash_many(xs, 2, 2, "d")


def test_hash_fixed_matches_reference_and_golden():
    rng = random.Random(5)
    rows = [[1, 2, 3]] + [[rng.randrange(params.FR_MODULUS) for _ in range(3)]
                          for _ in range(7)]
    out = poseidon.hash_fixed(_inputs(rows), rate=2)
    got = _decode(out[0])
    assert str(got[0]) == FIX["poseidon"]["rate2_hash1_123"]
    assert got == [jref.hash1(r, rate=2) for r in rows]


def test_hash_fixed_domain_and_outputs():
    out = poseidon.hash_fixed(_inputs([[42]]), rate=2, domain="snarkos_tpu.test")
    assert str(_decode(out[0])[0]) == FIX["poseidon"]["rate2_domain"]
    out = poseidon.hash_fixed(_inputs([[9, 8, 7, 6, 5]]), rate=4, num_outputs=2)
    assert str(_decode(out[1])[0]) == FIX["poseidon"]["rate4_hash1"]


def test_counter_mode_leaves():
    """The prover's leaf shape: (seed, counter) pairs under the coefficient
    domain, as the JAX package's host reference hashes them."""
    seed = 123456789
    rows = [[seed, i] for i in range(6)]
    got = _decode(poseidon.hash_fixed(_inputs(rows), rate=2, domain=DOMAIN)[0])
    assert got == [jref.hash_many(r, rate=2, domain=DOMAIN)[0] for r in rows]


@pytest.mark.slow
def test_hash_fixed_limb_exact_against_jax():
    import jax.numpy as jnp

    from snarkos_tpu.ops import poseidon as jpos

    rng = random.Random(6)
    rows = [[rng.randrange(params.FR_MODULUS) for _ in range(2)] for _ in range(8)]
    x = _inputs(rows)
    want = np.asarray(jpos.hash_fixed(jnp.asarray(x.numpy()), rate=2, domain=DOMAIN))
    np.testing.assert_array_equal(poseidon.hash_fixed(x, rate=2, domain=DOMAIN).numpy(), want)
