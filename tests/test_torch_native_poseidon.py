"""The port's host Poseidon sponge (csrc/host/poseidon377.cpp through
snarkos_tpu_torch/utils/native.py) on the CPU: case for case the JAX
package's tests/test_poseidon_native.py, each held against the port's plain
sponge (``poseidon.hash_many_plain``) and the JAX package's
``crypto.ref.poseidon.hash_many`` on the same inputs, exactly; the JAX
file's throughput case becomes a parity case over every rate 1-16 (the
engine takes 1-8, the plain version the rest, on both sides)."""

import ctypes
import random

import pytest

from snarkos_tpu.crypto.ref import poseidon as jposeidon
from snarkos_tpu_torch.crypto import params
from snarkos_tpu_torch.crypto.ref import poseidon as P
from snarkos_tpu_torch.utils import native

R = params.FR_MODULUS


@pytest.mark.parametrize("rate", [2, 4])
@pytest.mark.parametrize("n", [0, 1, 2, 5, 9])
def test_hash_many_parity(rate, n):
    rng = random.Random(1000 * rate + n)
    inputs = [rng.randrange(R) for _ in range(n)]
    for m in (1, 3):
        for dom in ("", "snarkos_tpu.transcript"):
            want = P.hash_many_plain(inputs, rate, m, dom)
            assert native.poseidon_hash_many(inputs, rate, m, P._domain_to_field(dom)) == want
            assert P.hash_many(inputs, rate, m, dom) == want
            assert jposeidon.hash_many(inputs, rate, m, dom) == want


def test_module_routing_matches():
    """hash_many (the engine at these rates) equals the plain sponge and the
    JAX package's, through hash1 and hash_to_scalar too."""
    inputs = [3, 1, 4, 1, 5, 9, 2, 6]
    assert P.hash_many(inputs, 2, 2, "d") == P.hash_many_plain(inputs, 2, 2, "d")
    assert P.hash_many(inputs, 2, 2, "d") == jposeidon.hash_many(inputs, 2, 2, "d")
    assert P.hash1([7, 8], 2) == P.hash_many_plain([7, 8], 2, 1, "")[0] == jposeidon.hash1([7, 8], 2)
    s = params.FR_MODULUS - 12345
    assert P.hash_to_scalar([7, 8], s) == jposeidon.hash_to_scalar([7, 8], s)


def test_large_input_reduction():
    """Inputs >= r (and below 0) are reduced mod r on both paths alike."""
    for x in (R + 12345, 3 * R - 1, -5):
        assert P.hash1([x], 2) == P.hash_many_plain([x % R], 2, 1, "")[0]
        assert P.hash1([x], 2) == jposeidon.hash1([x], 2)


@pytest.mark.parametrize("rate", range(1, 17))
def test_every_rate_matches_jax(rate):
    """Rates 1-8 on the engine, 9-16 on the plain sponge: the port's
    hash_many is the JAX package's at each, absorbing over two blocks and
    squeezing over two."""
    rng = random.Random(rate)
    inputs = [rng.randrange(R) for _ in range(rate + 1)]
    got = P.hash_many(inputs, rate, rate + 1, "rates")
    assert got == jposeidon.hash_many(inputs, rate, rate + 1, "rates")
    if rate <= native.POSEIDON_MAX_RATE:
        assert got == P.hash_many_plain(inputs, rate, rate + 1, "rates")
    else:
        with pytest.raises(ValueError, match="rates 1-8"):
            native.poseidon_hash_many(inputs, rate, 1, 0)


def test_permute_entry_matches_plain():
    """The engine's raw permutation (``poseidon377_permute``) is the plain
    ``permute`` at every width it takes."""
    rng = random.Random(3)
    for rate in range(1, native.POSEIDON_MAX_RATE + 1):
        lib = native._poseidon(rate)
        state = [rng.randrange(R) for _ in range(rate + 1)]
        buf = ctypes.create_string_buffer(b"".join(x.to_bytes(32, "little") for x in state),
                                          32 * (rate + 1))
        assert lib.poseidon377_permute(rate, buf) == 0
        got = [int.from_bytes(buf.raw[32 * i:32 * (i + 1)], "little") for i in range(rate + 1)]
        assert got == P.permute(state, rate) == jposeidon.permute(state, rate)
