"""The port's host pairing engine (csrc/host/pairing377.cpp through
snarkos_tpu_torch/utils/native.py) on the CPU: case for case the JAX
package's tests/test_pairing_native.py, each held against the port's plain
versions (``pairing.multi_pairing_plain``, ``g2_scalar_mul_plain``) and the
JAX package's public functions on the same inputs, exactly.

Beyond the JAX cases: eight threads on a freshly loaded copy of the engine
(its constants not yet set) all get the right answer, and a point off its
curve gets the JAX package's answer through the plain version. Two
pure-Python pairings in all (the bit-exact case and the off-curve one), and
one on the JAX side (the off-curve reference answer).
"""

import ctypes
import random
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor

from snarkos_tpu.crypto.ref import pairing as jpairing
from snarkos_tpu.crypto.ref import poseidon as jposeidon
from snarkos_tpu_torch.crypto import params
from snarkos_tpu_torch.crypto.ref import g1, pairing, poseidon
from snarkos_tpu_torch.ops import _build
from snarkos_tpu_torch.utils import native

Q = params.FQ_MODULUS
R = params.FR_MODULUS
G = (params.G1_GENERATOR_X, params.G1_GENERATOR_Y)
H = pairing.G2_GENERATOR
NEG_G = (G[0], (-G[1]) % Q)


def _mul_g(a):
    return g1.affine(g1.scalar_mul(a, g1.from_affine(G)))


def _bilinear_pairs(a, b=None):
    """e(a G, H) e(-G, b H): 1 iff a == b."""
    return [(_mul_g(a), H), (NEG_G, pairing.g2_scalar_mul(a if b is None else b, H))]


def test_single_pairing_bit_exact():
    plain = pairing.multi_pairing_plain([(G, H)])  # the one plain pairing of this case
    assert native.multi_pairing([(G, H)]) == plain
    assert pairing.multi_pairing([(G, H)]) == plain
    assert jpairing.multi_pairing([(G, H)]) == plain


def test_bilinearity_native_only():
    a = 0xDEADBEEFCAFEF00D
    pairs = _bilinear_pairs(a)
    assert native.pairing_check(pairs) is True
    assert jpairing.pairing_check(pairs) is True
    aP, aQ = pairs[0][0], pairs[1][1]
    assert native.multi_pairing([(aP, H)]) == native.multi_pairing([(G, aQ)])
    assert native.multi_pairing([(aP, H)]) == jpairing.multi_pairing([(aP, H)])


def test_tampered_product_fails():
    pairs = _bilinear_pairs(12345678901234567, 12345678901234568)
    assert native.pairing_check(pairs) is False
    assert pairing.pairing_check(pairs) is False
    assert jpairing.pairing_check(pairs) is False


def test_off_curve_rejected():
    bad = (G[0], (G[1] + 1) % Q)
    assert native.pairing_check([(bad, H)]) is None
    assert native.multi_pairing([(bad, H)]) is None
    bad_g2 = ((H[0][0], H[0][1]), (H[1][0], (H[1][1] + 1) % Q))
    assert native.pairing_check([(G, bad_g2)]) is None
    assert native.g2_scalar_mul(3, bad_g2) is None


def test_infinity_pairs():
    for pairs in ([(None, H)], [(G, None)], [(g1.INFINITY, H)]):
        assert native.pairing_check(pairing._normalize_pairs(pairs)) is True
        assert pairing.pairing_check(pairs) is True
        assert jpairing.pairing_check(pairs) is True
    assert native.multi_pairing([(None, H)]) == pairing.F12_ONE
    assert pairing.multi_pairing([(None, H)]) == jpairing.multi_pairing([(None, H)])


def test_g2_scalar_mul_parity():
    rng = random.Random(7)
    for k in (0x1234567890ABCDEF1234567890ABCDEF, rng.randrange(R), R - 1):
        want = pairing.g2_scalar_mul_plain(k, H)
        assert native.g2_scalar_mul(k, H) == want
        assert pairing.g2_scalar_mul(k, H) == want
        assert jpairing.g2_scalar_mul(k, H) == want
        assert pairing.g2_on_curve(want)
    assert native.g2_scalar_mul(R, H) is native.G2_INF
    assert pairing.g2_scalar_mul(R, H) is None is jpairing.g2_scalar_mul(R, H)


def test_g2_scalar_mul_small_values():
    assert native.g2_scalar_mul(1, H) == H == pairing.g2_scalar_mul_plain(1, H)
    two = native.g2_scalar_mul(2, H)
    assert two == pairing.g2_add(H, H) == jpairing.g2_scalar_mul(2, H)
    assert native.g2_scalar_mul(5, None) is native.G2_INF
    assert pairing.g2_scalar_mul(5, None) is None


def test_module_routing():
    """pairing_check and multi_pairing agree with each other, with the
    F12_ONE convention and with the JAX package, on affine and Jacobian G1
    inputs."""
    a = 999
    pairs = _bilinear_pairs(a)
    assert pairing.pairing_check(pairs) is True
    assert pairing.multi_pairing(pairs) == pairing.F12_ONE == jpairing.multi_pairing(pairs)
    jac = g1.scalar_mul(a, g1.from_affine(G))
    assert pairing.pairing_check([(jac, H), pairs[1]]) is True
    assert jpairing.pairing_check([(jac, H), pairs[1]]) is True


def test_two_pair_check_parity():
    """The JAX file's latency case as a parity case: the 2-pair admission
    check, accepted and rejected, as the JAX package answers it."""
    good = _bilinear_pairs(777)
    bad = _bilinear_pairs(777, 778)
    for pairs, want in ((good, True), (bad, False)):
        assert native.pairing_check(pairs) is want
        assert pairing.pairing_check(pairs) is want
        assert jpairing.pairing_check(pairs) is want
    assert pairing.multi_pairing(bad) == jpairing.multi_pairing(bad)


def test_threads_on_a_freshly_loaded_engine(tmp_path, monkeypatch):
    """Eight threads enter a new copy of the pairing and sponge engines at
    once (ctypes releases the GIL): the pairing's constants are set once
    and each rate's tables registered once, and every thread gets the
    right answers. dlopen of a loaded path returns the loaded library, so
    the copies lie under another path."""
    good, bad = _bilinear_pairs(31337), _bilinear_pairs(31337, 31338)
    rng = random.Random(11)
    jobs = [([rng.randrange(R) for _ in range(5)], 1 + i % 4) for i in range(8)]
    want_hash = [jposeidon.hash_many(x, rate, 2, "t") for x, rate in jobs]
    assert want_hash == [poseidon.hash_many_plain(x, rate, 2, "t") for x, rate in jobs]
    fresh = {}
    for name in ("pairing377", "poseidon377"):
        native.engine(name)  # built
        copy = tmp_path / f"lib{name}-copy.so"
        shutil.copy(_build.host_lib_path(name), copy)
        fresh[name] = native.bind(name, ctypes.CDLL(str(copy)))
    monkeypatch.setattr(native, "_LIBS", {**native._LIBS, **fresh})
    start = threading.Barrier(8)

    def work(i):
        start.wait()
        x, rate = jobs[i]
        return (pairing.pairing_check(good), pairing.pairing_check(bad),
                poseidon.hash_many(x, rate, 2, "t"))

    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(work, range(8)))
    assert got == [(True, False, want_hash[i]) for i in range(8)]
    assert {(str(tmp_path / "libposeidon377-copy.so"), r) for r in (1, 2, 3, 4)} <= native._RATES


def test_off_curve_gives_the_jax_answer():
    """A G1 point off the curve: the engine refuses it (rc < 0) on both
    sides, and the plain versions answer; the port's answer is the JAX
    package's. A G2 point off the twist likewise in g2_scalar_mul."""
    bad = (G[0], (G[1] + 1) % Q)
    want = jpairing.pairing_check([(bad, H)])  # the JAX package's plain path
    assert pairing.pairing_check([(bad, H)]) == want  # the port's plain path
    bad_g2 = ((H[0][0], H[0][1]), (H[1][0], (H[1][1] + 1) % Q))
    assert pairing.g2_scalar_mul(5, bad_g2) == jpairing.g2_scalar_mul(5, bad_g2)
    assert pairing.g2_scalar_mul(5, bad_g2) == pairing.g2_scalar_mul_plain(5, bad_g2)
