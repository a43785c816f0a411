"""The port's host G1 engine (csrc/host/g1_msm.cpp through
snarkos_tpu_torch/utils/native.py) and its hashing and limb helpers on the
CPU: case for case the JAX package's tests/test_aux.py::test_native_accel,
then the engine's MSMs at the shapes the node folds (8 and 18 points,
``varuna._combine_comms``), the fixed-base generator and the host KZG setup
and commitment, each held against the port's plain versions (``g1.msm``,
``g1.scalar_mul``) and the JAX package's public functions, exactly (affine
normal forms; Jacobian limbs where both sides run the same engine code).

Then the build's fault rule: with no compiler on PATH an engine load
raises ``RuntimeError``, nothing falls back to Python, and a role's
``__init__`` raises before it builds a ledger or binds a socket; a source
that does not compile raises with the compiler's log.
"""

import hashlib
import os
import random
import socket

import numpy as np
import pytest

from snarkos_tpu.crypto.ref import g1 as jg1, kzg as jkzg
from snarkos_tpu.utils import native as jnative
from snarkos_tpu_torch.crypto import params
from snarkos_tpu_torch.crypto.ref import g1, kzg, pairing, poseidon
from snarkos_tpu_torch.node import cli, roles, types
from snarkos_tpu_torch.ops import _build
from snarkos_tpu_torch.utils import native

R = params.FR_MODULUS
MASK64 = (1 << 64) - 1


def test_native_accel():
    data = b"transmission-id-bytes" * 2
    expect = hashlib.sha256(hashlib.sha256(data).digest()).digest()
    assert native.sha256d(data) == expect == jnative.sha256d(data)
    ids = [os.urandom(33) for _ in range(10)]
    want = [hashlib.sha256(hashlib.sha256(i).digest()).digest()[0] % 3 for i in ids]
    assert native.assign_to_worker(ids, 3) == want == jnative.assign_to_worker(ids, 3)
    assert native.sha256d_batch(ids) == jnative.sha256d_batch(ids)
    arr = np.random.default_rng(5).integers(0, 1 << 16, (16, 20)).astype(np.int32)
    packed = native.limbs_to_bytes(arr)
    assert packed == jnative.limbs_to_bytes(arr)
    assert np.array_equal(native.bytes_to_limbs(packed, 16), arr)
    assert np.array_equal(native.bytes_to_limbs(packed, 16), jnative.bytes_to_limbs(packed, 16))


def _msm_inputs(n, seed):
    """n scalars (a zero, r - 1 and random ones) and n affine points (k G for
    random k, one point twice), from a seed."""
    rng = random.Random(seed)
    scalars = [rng.randrange(R) for _ in range(n)]
    scalars[0], scalars[1] = 0, R - 1
    points = [g1.affine(g1.scalar_mul(rng.randrange(1, R), g1.GENERATOR)) for _ in range(n)]
    points[-1] = points[-2]
    return scalars, points


@pytest.mark.parametrize("n", [8, 18])
def test_g1_msm_matches_plain_and_jax(n):
    scalars, points = _msm_inputs(n, n)
    got = native.g1_msm(scalars, points)
    want = g1.affine(g1.msm(scalars, [g1.from_affine(p) for p in points]))
    assert g1.affine(got) == want
    assert jg1.affine(jg1.msm(scalars, [jg1.from_affine(p) for p in points])) == want
    assert g1.affine(native.g1_msm_mt(scalars, points, 4)) == want
    if jnative.have_g1():  # where the JAX package's engine loads: the same limbs
        assert got == jnative.g1_msm(scalars, points)


def test_g1_msm_edges():
    assert native.g1_msm([], []) == g1.INFINITY
    G = g1.affine(g1.GENERATOR)
    assert native.g1_msm([0, 0], [G, G]) == g1.INFINITY
    assert native.g1_msm([1, R - 1], [G, G])[2] == 0
    scalars, points = _msm_inputs(64, 64)
    want = g1.affine(native.g1_msm(scalars, points))
    for threads in (0, 1, 3):
        assert g1.affine(native.g1_msm_mt(scalars, points, threads)) == want
    if jnative.have_g1():
        assert g1.affine(jnative.g1_msm_mt(scalars, points, 3)) == want


def _splitmix64(state):
    z = state = (state + 0x9E3779B97F4A7C15) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return z ^ (z >> 31)


def test_g1_fixed_base_gen_matches_plain_and_jax():
    seed, n = 0xC0FFEE, 9
    out = native.g1_fixed_base_gen(seed, n)
    assert out.shape == (n, 12) and out.dtype == np.uint64
    for i in range(n):
        k = _splitmix64((seed + i * 0x9E3779B97F4A7C15) & MASK64) | 1
        x, y = g1.affine(g1.scalar_mul(k, g1.GENERATOR))
        limbs = [int(v) for v in out[i]]
        assert sum(v << (64 * j) for j, v in enumerate(limbs[:6])) == x
        assert sum(v << (64 * j) for j, v in enumerate(limbs[6:])) == y
    if jnative.have_g1():  # where the JAX package's engine loads
        assert np.array_equal(out, jnative.g1_fixed_base_gen(seed, n))
    assert native.g1_fixed_base_gen(seed, 0).shape == (0, 12)


def test_srs_setup_and_commit_match_plain_and_jax():
    """From 64 powers up the setup runs on the engine (z = 1), as the JAX
    package's; the host commitment is the engine's MSM over them."""
    tau = 0x1234567
    srs = kzg.SRS.setup(63, tau=tau)
    jsrs = jkzg.SRS.setup(63, tau=tau)
    assert srs.powers_g1 == jsrs.powers_g1 and srs.tau_h == jsrs.tau_h
    assert all(p[2] == 1 for p in srs.powers_g1)
    for i in (0, 1, 2, 62, 63):
        assert g1.affine(srs.powers_g1[i]) == g1.affine(g1.scalar_mul(pow(tau, i, R), g1.GENERATOR))
    small = kzg.SRS.setup(4, tau=tau)
    assert [g1.affine(p) for p in small.powers_g1] == [g1.affine(p) for p in srs.powers_g1[:5]]
    coeffs = [random.Random(2).randrange(R) for _ in range(20)]
    got = kzg.commit(srs, coeffs)
    assert got == jkzg.commit(jsrs, coeffs)
    assert g1.affine(got) == g1.affine(g1.msm(coeffs, srs.powers_g1[:20]))


def test_missing_compiler_raises(tmp_path, monkeypatch):
    """No g++ and no c++ on PATH, no engine built yet: the load raises, the
    callers that need an engine raise instead of running the plain
    versions, and a Validator raises in ``__init__`` before it builds a
    ledger or binds a socket."""
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", str(tmp_path / "host"))
    monkeypatch.setattr(_build.shutil, "which", lambda *_a, **_k: None)
    monkeypatch.setattr(native, "_LIBS", {})
    for name in _build.HOST_SOURCES:
        with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
            native.engine(name)
    G = g1.affine(g1.GENERATOR)
    with pytest.raises(RuntimeError, match="compiler"):
        pairing.pairing_check([(G, pairing.G2_GENERATOR)])
    with pytest.raises(RuntimeError, match="compiler"):
        poseidon.hash1([1, 2])
    with pytest.raises(RuntimeError, match="compiler"):
        native.g1_msm([1], [G])
    comm = types.Committee.new(1, {"aleo1" + "11" * 32: 100})
    acct = cli.AccountView(cli.dev_account(0))
    binds = []
    monkeypatch.setattr(socket.socket, "bind", lambda self, *a: binds.append(a))
    monkeypatch.setattr(roles, "Ledger", lambda *a, **k: binds.append("ledger"))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        roles.Validator(acct, comm, device="cpu")
    assert binds == []
    assert sorted(os.listdir(tmp_path / "host")) == [".lock"]


def test_failed_build_raises_with_the_log(tmp_path, monkeypatch):
    """A source the compiler refuses: the build raises ``RuntimeError``
    with the compiler's log, and leaves no library behind."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "poseidon377.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(_build, "HOST_CSRC", str(src))
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", str(tmp_path / "host"))
    with pytest.raises(RuntimeError, match="poseidon377.cpp \\(exit [1-9]") as err:
        _build.build((), ("poseidon377",))
    assert "error" in str(err.value)
    assert not os.path.exists(_build.host_lib_path("poseidon377"))
