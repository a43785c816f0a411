"""The port's NTT over Fr (plain PyTorch on the CPU) against the JAX
package's host reference ``crypto/ref/ntt.py`` and ``golden.json``'s
``ntt_16``, limb for limb (tolerance 0); a model of the two CUDA entries'
index math (``csrc/ntt.cu``) over Z_r; and, in the slow tier, the port
against the JAX package's ``ops/ntt.py`` itself, its arrays handed across
with ``convert.fr`` (n = 4096 takes the JAX four-step path)."""

import json
import os
import random

import numpy as np
import pytest
import torch

from snarkos_tpu.crypto.ref import ntt as jref
from snarkos_tpu_torch import convert
from snarkos_tpu_torch.crypto.ref import ntt as ref
from snarkos_tpu_torch.ops import ntt
from snarkos_tpu_torch.ops.fieldspec import FR

# the plain versions run many small tensor ops: intra-op threads only add
# contention when test workers share the CPU
torch.set_num_threads(1)

P = FR.p
FIX = json.load(open(os.path.join(os.path.dirname(__file__), "fixtures", "golden.json")))
CPU = torch.device("cpu")
# the two CPU routes: ``ntt`` through the kernels' plain versions (n^-1
# folded into the gather), and ``ntt_plain``, the JAX package's stage loop
ROUTES = {"ntt": ntt.ntt, "ntt_plain": ntt.ntt_plain}


def _enc(vals):
    return torch.from_numpy(np.ascontiguousarray(FR.encode_fast(vals, mont=True)))


def _dec(t):
    return FR.decode_fast(t.numpy(), mont=True)


def _rand(rng, n):
    return [rng.randrange(P) for _ in range(n)]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("n", [2, 16, 128])
def test_forward_matches_reference(route, n):
    vals = _rand(random.Random(n), n)
    assert _dec(ROUTES[route](_enc(vals))) == jref.ntt(vals)


@pytest.mark.parametrize("route", ROUTES)
def test_inverse_matches_reference(route):
    vals = _rand(random.Random(64), 64)
    assert _dec(ROUTES[route](_enc(vals), invert=True)) == jref.intt(vals)


@pytest.mark.parametrize("n", [16, 128])
def test_roundtrip(n):
    vals = _rand(random.Random(n + 1), n)
    a = _enc(vals)
    assert torch.equal(ntt.intt(ntt.ntt(a)), a)
    assert torch.equal(ntt.ntt_plain(ntt.ntt_plain(a), invert=True), a)


@pytest.mark.parametrize("invert", [False, True])
def test_batched(invert):
    """(16, 4, 32): each row an independent transform, on both routes."""
    rng = random.Random(32 + invert)
    rows = [_rand(rng, 32) for _ in range(4)]
    a = torch.stack([_enc(row) for row in rows], dim=1)
    for out in (ntt.ntt_batched(a, invert), ntt.ntt_plain(a, invert)):
        assert out.shape == a.shape
        for i, row in enumerate(rows):
            assert _dec(out[:, i]) == jref.ntt(row, invert)


@pytest.mark.parametrize("route", ROUTES)
def test_edge_values(route):
    vals = [0, 1, P - 1, P - 2] + [0] * 12
    a = _enc(vals)
    assert _dec(ROUTES[route](a)) == jref.ntt(vals)
    assert _dec(ROUTES[route](a, invert=True)) == jref.intt(vals)
    vals = [P - 1, P - 2, 1, 0] * 4
    assert _dec(ROUTES[route](_enc(vals))) == jref.ntt(vals)


def test_golden_ntt_16():
    g = FIX["ntt_16"]
    got = _dec(ntt.ntt(_enc([int(v) for v in g["input"]])))
    assert got == [int(v) for v in g["output"]]


def test_host_reference_matches_jax_package():
    """The port's own copy of crypto/ref/ntt.py: roots of unity of every
    order 2^k <= 2^22, bit reversal, and the transforms."""
    for k in range(23):
        assert ref.root_of_unity(1 << k) == jref.root_of_unity(1 << k)
    rng = random.Random(3)
    for bits in (1, 5, 12, 22):
        for x in [0, (1 << bits) - 1] + [rng.randrange(1 << bits) for _ in range(4)]:
            assert ref.bit_reverse(x, bits) == jref.bit_reverse(x, bits)
    vals = _rand(rng, 32)
    assert ref.ntt(vals) == jref.ntt(vals) and ref.intt(vals) == jref.intt(vals)
    assert ref.poly_eval(vals, 7) == jref.poly_eval(vals, 7)


@pytest.mark.parametrize("invert", [False, True])
def test_master_table_is_powers_of_omega(invert):
    n = 1 << 10
    omega = ref.root_of_unity(n)
    if invert:
        omega = pow(omega, -1, P)
    table = ntt._master_table(n, invert, CPU)
    assert table.shape == (FR.nlimbs, n // 2) and table.is_contiguous()
    assert _dec(table) == [pow(omega, i, P) for i in range(n // 2)]


# -- a model of csrc/ntt.cu's index math over Z_r ------------------------------


def _brev32(x):
    return int(f"{x:032b}"[::-1], 2)


def _model(rows, invert):
    """fr_ntt_bitrev then fr_ntt_stage for s = 0 .. log n - 1, thread by
    thread, on the flat (rows n) array of each limb row, over Z_r."""
    B, n = len(rows), len(rows[0])
    log_n = n.bit_length() - 1
    omega = ref.root_of_unity(n)
    if invert:
        omega = pow(omega, -1, P)
    master = [pow(omega, i, P) for i in range(n // 2)]
    scale = pow(n, -1, P) if invert else 1
    flat = [v for row in rows for v in row]
    a = [0] * (B * n)
    for e in range(B * n):  # fr_ntt_bitrev: thread e
        i = e & (n - 1)
        a[e] = flat[(e - i) + (_brev32(i) >> (32 - log_n))] * scale % P
    half, log_half = n >> 1, log_n - 1
    for s in range(log_n):  # fr_ntt_stage: thread t
        touched = []
        for t in range(B * half):
            r, k = t >> log_half, t & (half - 1)
            j = k & ((1 << s) - 1)
            i0 = r * n + ((k >> s) << (s + 1)) + j
            i1 = i0 + (1 << s)
            w = a[i1] * master[j << (log_half - s)] % P
            a[i0], a[i1] = (a[i0] + w) % P, (a[i0] - w) % P
            touched += [i0, i1]
        assert sorted(touched) == list(range(B * n))  # each element once a stage
    return [a[b * n:(b + 1) * n] for b in range(B)]


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("shape", [(1, 64), (4, 32)])
def test_kernel_index_model(shape, invert):
    B, n = shape
    rng = random.Random(B * n + invert)
    rows = [_rand(rng, n) for _ in range(B)]
    rows[0][:4] = [0, 1, P - 1, P - 2]
    assert _model(rows, invert) == [jref.ntt(row, invert) for row in rows]


def test_sizes():
    """n == 1 returns its input on every entry; a size that is not a power
    of two raises."""
    a = _enc([5])
    assert ntt.ntt(a) is a and ntt.intt(a) is a and ntt.ntt_plain(a) is a
    b = a.reshape(FR.nlimbs, 1, 1)
    assert ntt.ntt_batched(b) is b
    with pytest.raises(ValueError, match="power of two"):
        ntt.ntt(_enc(list(range(12))))
    with pytest.raises(ValueError, match="power of two"):
        ntt.ntt_batched(_enc(list(range(12))).reshape(FR.nlimbs, 1, 12))


def test_convert_fr_checks_limbs():
    a = FR.encode_fast([1, 2, 3, 4], mont=True)
    assert torch.equal(convert.fr(a, "cpu"), torch.from_numpy(np.array(a)))
    assert convert.fr(a.reshape(FR.nlimbs, 2, 2), "cpu").shape == (FR.nlimbs, 2, 2)
    with pytest.raises(ValueError, match="limbs"):
        convert.fr(np.full((FR.nlimbs, 2), 1 << 16, dtype=np.int32), "cpu")
    with pytest.raises(ValueError, match="expected"):
        convert.fr(np.zeros((2, FR.nlimbs, 4), dtype=np.int32), "cpu")
    with pytest.raises(ValueError, match="int32"):
        convert.fr(np.zeros((FR.nlimbs, 4), dtype=np.int64), "cpu")


# -- the slow tier: the JAX package's ops/ntt.py itself -------------------------


def _jax_pair(fn, vals_arr):
    import jax.numpy as jnp

    return convert.fr(vals_arr, "cpu"), convert.fr(np.asarray(fn(jnp.asarray(vals_arr))), "cpu")


@pytest.mark.slow
@pytest.mark.parametrize("n", [16, 128, 4096])
def test_ntt_matches_jax(n):
    from snarkos_tpu.ops import ntt as jntt

    arr = FR.random(n, np.random.default_rng(n))
    a, want = _jax_pair(jntt.ntt, arr)
    assert torch.equal(ntt.ntt(a), want)
    assert torch.equal(ntt.ntt_plain(a), want)


@pytest.mark.slow
def test_intt_matches_jax():
    from snarkos_tpu.ops import ntt as jntt

    a, want = _jax_pair(jntt.intt, FR.random(64, np.random.default_rng(64)))
    assert torch.equal(ntt.intt(a), want)


@pytest.mark.slow
def test_ntt_batched_matches_jax():
    from snarkos_tpu.ops import ntt as jntt

    arr = FR.random(4 * 32, np.random.default_rng(32)).reshape(FR.nlimbs, 4, 32)
    a, want = _jax_pair(jntt.ntt_batched, arr)
    assert torch.equal(ntt.ntt_batched(a), want)
