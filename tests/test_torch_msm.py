"""The port's MSM engine on the CPU: the combinatorics with a mock group on
the serial-chain and wide-chain layouts, held against the JAX package's
``_fused_msm_body`` on the same mock group (tests/test_msm.py's fused-engine
tests), the signed digits against the JAX package, the engine routing, and
real G1 multi-MSMs against host sums."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snarkos_tpu.crypto import params
from snarkos_tpu.crypto.ref import g1 as ref
from snarkos_tpu.ops import msm as jmsm
from snarkos_tpu_torch.ops import g1, msm, msm_kernels
from snarkos_tpu_torch.ops.fieldspec import FQ, FR

# the plain versions run many small tensor ops: intra-op threads only add
# contention when test workers share the CPU
torch.set_num_threads(1)

RNG = random.Random(1234)
MOCK_MOD = 1_000_000_007


def _limbs(scalars):
    return torch.from_numpy(FR.encode(scalars, mont=False))


def _mock3_group():
    """Z_M^3 with componentwise addition as a stand-in for (x, y, z)."""

    def identity(n):
        return tuple(torch.zeros((1, n), dtype=torch.int32) for _ in range(3))

    def add(a, b):
        return tuple(((x.long() + y) % MOCK_MOD).to(torch.int32) for x, y in zip(a, b))

    def select(mask, a, b):
        return tuple(torch.where(mask.unsqueeze(0), x, y) for x, y in zip(a, b))

    return msm.GroupOps(identity=identity, add=add, select=select)


def _mock3_scan(xs, ys, flags, lanes, chunk):
    """Wide-chain mock scan over chunk * K virtual chains: chain (r, k)
    advances along i at rows j = i chunk + r; input point (x, y) contributes
    (x, y, 1)."""
    L, m, K = xs.shape
    mv = m // chunk
    fl = flags.reshape(1, mv, chunk, K)
    outs = []
    for v in (xs, ys, torch.ones_like(xs)):
        vv = v.reshape(L, mv, chunk, K).long()
        carry = torch.zeros((L, chunk, K), dtype=torch.int64)
        rows = []
        for i in range(mv):
            carry = torch.where(fl[:, i] != 0, vv[:, i], (carry + vv[:, i]) % MOCK_MOD)
            rows.append(carry)
        outs.append(torch.stack(rows, dim=1).reshape(L, m, K).to(torch.int32))
    return tuple(outs)


def _mock3_scan_serial(xs, ys, flags, lanes, chunk):
    """Serial-chain mock scan: chain k owns rows j = 0..m-1 of lane k (the
    wide scan with chunk 1)."""
    return _mock3_scan(xs, ys, flags, lanes, 1)


def _jax_mock3_group():
    """``_mock3_group`` in jnp (int32: a sum of two residues stays below 2^31)."""

    def identity(n):
        return tuple(jnp.zeros((1, n), jnp.int32) for _ in range(3))

    def add(a, b):
        return tuple((x + y) % MOCK_MOD for x, y in zip(a, b))

    def select(mask, a, b):
        return tuple(jnp.where(mask[None], x, y) for x, y in zip(a, b))

    def gather(p, idx):
        return tuple(jnp.take(t, idx, axis=-1) for t in p)

    return jmsm.GroupOps(identity=identity, add=add, select=select, gather=gather)


def _jax_mock3_scan(serial):
    """tests/test_msm.py's mock scans in jnp (the JAX engine traces them)."""

    def run(xs, ys, flags, lanes, chunk):
        L, m, K = xs.shape
        rows_ = 1 if serial else chunk
        mv = m // rows_
        fl = flags.reshape(1, mv, rows_, K)
        outs = []
        for v in (xs, ys, jnp.ones_like(xs)):
            vv = v.reshape(L, mv, rows_, K)
            carry = jnp.zeros((L, rows_, K), jnp.int32)
            rows = []
            for i in range(mv):
                carry = jnp.where(fl[:, i] != 0, vv[:, i], (carry + vv[:, i]) % MOCK_MOD)
                rows.append(carry)
            outs.append(jnp.stack(rows, axis=1).reshape(L, m, K))
        return tuple(outs)

    return run


def _both_engines(x_arr, ycat, packed, c, lanes, chunk, serial, nbatch=1):
    """The port's and the JAX package's _fused_msm_body on the same mock group,
    scan and inputs: each component must agree exactly."""
    out = msm._fused_msm_body(x_arr, ycat, packed, c, lanes, chunk, group=_mock3_group(),
                              scan_fn=_mock3_scan_serial if serial else _mock3_scan,
                              serial=serial, nbatch=nbatch)
    want = jmsm._fused_msm_body(
        jnp.asarray(x_arr.numpy()), jnp.asarray(ycat.numpy()), jnp.asarray(packed.numpy()), c,
        lanes, chunk, use_pallas=False, group=_jax_mock3_group(),
        scan_fn=_jax_mock3_scan(serial), serial=serial, nbatch=nbatch)
    for got, ref_ in zip(out, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref_))
    return out


@pytest.mark.parametrize("serial", [False, True])
@pytest.mark.parametrize("c", [4, 6])
@pytest.mark.parametrize("n,lanes,chunk", [(16, 4, 2), (64, 8, 4), (100, 4, 2)])
def test_fused_engine_mock_group(c, n, lanes, chunk, serial):
    """sum_i k_i y_i in the y-component of the mock group (signs enter via
    the [y | -y] gather), in the wide-chain and serial-chain layouts, equal
    to the JAX engine component for component."""
    scalars = [RNG.randrange(params.FR_MODULUS) for _ in range(n)]
    scalars[0] = 0
    ys = [RNG.randrange(1, MOCK_MOD) for _ in range(n)]
    xs = [RNG.randrange(1, MOCK_MOD) for _ in range(n)]
    tile = lanes * chunk
    n_pad = -(-n // tile) * tile
    xs_p = xs + [xs[0]] * (n_pad - n)
    ys_p = ys + [ys[0]] * (n_pad - n)
    sc_p = scalars + [0] * (n_pad - n)
    x_arr = torch.tensor(xs_p, dtype=torch.int32).reshape(1, n_pad)
    ycat = torch.tensor(ys_p + [(MOCK_MOD - y) % MOCK_MOD for y in ys_p],
                        dtype=torch.int32).reshape(1, 2 * n_pad)
    packed = msm.signed_window_digits(_limbs(sc_p), c)
    out = _both_engines(x_arr, ycat, packed, c, lanes, chunk, serial)
    assert int(out[1][0, 0]) == sum(k * y for k, y in zip(scalars, ys)) % MOCK_MOD


@pytest.mark.parametrize("serial", [False, True])
@pytest.mark.parametrize("nbatch,c,nper,lanes,chunk",
                         [(2, 4, 16, 4, 2), (3, 6, 64, 8, 4), (4, 4, 20, 4, 2)])
def test_fused_engine_multi_mock_group(nbatch, c, nper, lanes, chunk, serial):
    """nbatch > 1 multi-MSM (shared base, per-batch bucket ranges): each
    batch's y-component total matches its own scalar set, and the output
    equals the JAX engine's, in both layouts."""
    tile = lanes * chunk
    nper_pad = nper if (nbatch * nper) % tile == 0 else -(-nper // tile) * tile
    scalars = [[RNG.randrange(params.FR_MODULUS) for _ in range(nper)] for _ in range(nbatch)]
    scalars[0][0] = 0
    xs = [RNG.randrange(1, MOCK_MOD) for _ in range(nper)]
    ys = [RNG.randrange(1, MOCK_MOD) for _ in range(nper)]
    xs_p = xs + [xs[0]] * (nper_pad - nper)
    ys_p = ys + [ys[0]] * (nper_pad - nper)
    n = nbatch * nper_pad
    x_arr = torch.tensor(xs_p * nbatch, dtype=torch.int32).reshape(1, n)
    y_tiled = ys_p * nbatch
    ycat = torch.tensor(y_tiled + [(MOCK_MOD - y) % MOCK_MOD for y in y_tiled],
                        dtype=torch.int32).reshape(1, 2 * n)
    sc_flat = []
    for s in scalars:
        sc_flat += s + [0] * (nper_pad - nper)
    packed = msm.signed_window_digits(_limbs(sc_flat), c)
    out = _both_engines(x_arr, ycat, packed, c, lanes, chunk, serial, nbatch)
    for i in range(nbatch):
        expect = sum(k * y for k, y in zip(scalars[i], ys)) % MOCK_MOD
        assert int(out[1][0, i]) == expect, f"batch {i}"


def test_engine_routing_above_serial_max_n(monkeypatch):
    """Above SERIAL_MAX_N points the multi-MSM takes the wide complete engine
    (B5) and the single MSM the fast one (B6), rerun on the complete engine
    exactly when the exception flag is set."""
    calls = []
    exc = [0]

    def body(x, ycat, packed, c, lanes, chunk, fast=False, serial=True, nbatch=1):
        calls.append((x.shape[-1], serial, fast, nbatch))
        acc = tuple(torch.zeros((24, nbatch), dtype=torch.int32) for _ in range(3))
        return (acc, torch.tensor(exc[0], dtype=torch.int32)) if fast else acc

    monkeypatch.setattr(msm, "_fused_msm_body", body)
    big = msm_kernels.SERIAL_MAX_N + 8
    zeros = torch.zeros((24, big), dtype=torch.int32)
    msm.msm_affine_multi(zeros[:, :big // 2], zeros[:, :big // 2],
                         torch.zeros((16, 2, big // 2), dtype=torch.int32))
    msm.msm_affine_multi(zeros[:, :8], zeros[:, :8], torch.zeros((16, 2, 8), dtype=torch.int32))
    assert [(serial, fast) for _, serial, fast, _ in calls] == [(False, False), (True, False)]
    assert calls[0][3] == 2
    calls.clear()
    msm.msm_affine(zeros, zeros, torch.zeros((16, big), dtype=torch.int32))
    assert [(serial, fast) for _, serial, fast, _ in calls] == [(False, True)]
    assert calls[0][0] % (msm._default_lanes(big) * msm_kernels.CHUNK) == 0  # padded to the tile
    calls.clear()
    exc[0] = 1
    msm.msm_affine(zeros, zeros, torch.zeros((16, big), dtype=torch.int32))
    assert [(serial, fast) for _, serial, fast, _ in calls] == [(False, True), (False, False)]
    calls.clear()
    msm.msm_affine(zeros[:, :8], zeros[:, :8], torch.zeros((16, 8), dtype=torch.int32))
    assert [(serial, fast) for _, serial, fast, _ in calls] == [(True, False)]


def test_non_affine_bases_raise():
    """Non-affine bases go to the generic engine, which raises where N is not
    a multiple of its K = min(4096, N) lanes (the JAX engine's reshape fails
    there too)."""
    p = g1.infinity((4097,))
    with pytest.raises(ValueError, match="multiple"):
        msm.msm(p, torch.zeros((16, 4097), dtype=torch.int32))


def test_non_affine_bases_take_the_generic_engine(monkeypatch):
    """Bases with z != 1, and identity bases (z = 0), go to the generic engine
    ``_msm_jacobian`` at its defaults, never to the fused one; affine bases
    do not. The generic engine's G1 sums are held against the host sum in
    test_torch_msm_generic.py."""
    rng = random.Random(21)
    pts = [ref.affine(ref.scalar_mul(rng.randrange(1, params.FR_MODULUS), ref.GENERATOR)) + (1,)
           for _ in range(4)]
    lam = [rng.randrange(2, FQ.p) for _ in range(4)]
    rescaled = [(p[0] * s * s % FQ.p, p[1] * s ** 3 % FQ.p, p[2] * s % FQ.p)
                for p, s in zip(pts, lam)]
    scalars = _limbs([rng.randrange(params.FR_MODULUS) for _ in range(4)])
    calls = []
    monkeypatch.setattr(msm, "_msm_jacobian", lambda p, k: calls.append((p, k)) or "generic")
    monkeypatch.setattr(msm, "msm_affine", None)  # a call would raise
    for bases in (rescaled, [pts[0], ref.INFINITY, pts[2], pts[3]], [ref.INFINITY] * 4):
        enc = g1.encode_points(bases)
        assert msm.msm(enc, scalars) == "generic"
        assert calls.pop()[0] is enc
    monkeypatch.setattr(msm, "msm_affine", lambda x, y, k: "affine")
    assert msm.msm(g1.encode_points(pts), scalars) == "affine"
    assert calls == []


@pytest.mark.parametrize("c", [4, 5, 6, 13])
def test_signed_window_digits_match_jax(c):
    scalars = [0, 1, params.FR_MODULUS - 1, (1 << 252) - 1] + [
        RNG.randrange(params.FR_MODULUS) for _ in range(12)]
    limbs = FR.encode(scalars, mont=False)
    got = msm.signed_window_digits(torch.from_numpy(limbs), c)
    want = np.asarray(jmsm.signed_window_digits(jnp.asarray(limbs), c))
    np.testing.assert_array_equal(got.numpy(), want)
    assert msm.fused_window_bits(4096) == jmsm.fused_window_bits(4096) == 6


def _affine_base(n, rng, repeat=None):
    pts = [ref.affine(ref.scalar_mul(rng.randrange(1, params.FR_MODULUS), ref.GENERATOR))
           for _ in range(n)]
    if repeat:
        pts[repeat[1]] = pts[repeat[0]]
    x = torch.from_numpy(np.ascontiguousarray(FQ.encode_fast([p[0] for p in pts], mont=True)))
    y = torch.from_numpy(np.ascontiguousarray(FQ.encode_fast([p[1] for p in pts], mont=True)))
    return pts, x, y


def _host_msm(scalars, pts):
    acc = ref.INFINITY
    for k, p in zip(scalars, pts):
        acc = ref.add(acc, ref.scalar_mul(k, ref.from_affine(p)))
    return ref.affine(acc)


def _check_multi(nb, npts, **kw):
    rng = random.Random(99)
    pts, x, y = _affine_base(npts, rng, repeat=(1, 2))
    S = [[rng.randrange(params.FR_MODULUS) for _ in range(npts)] for _ in range(nb)]
    S[0][0] = 0
    S[-1][1] = params.FR_MODULUS - 1
    limbs = _limbs([s for row in S for s in row]).reshape(16, nb, npts)
    got = g1.decode_points(msm.msm_affine_multi(x, y, limbs, **kw))
    assert [ref.affine(p) for p in got] == [_host_msm(row, pts) for row in S]


@pytest.mark.parametrize("serial", [True, False])
def test_msm_affine_multi_g1_tiny(serial, monkeypatch):
    """Real G1, nbatch 2 x 4 points (zero scalar, r - 1, a repeated point),
    on a narrow chain layout so the plain versions finish in seconds; the
    wide engine (B5's plain version, SERIAL_MAX_N lowered) at 2 x 2 virtual
    chains."""
    if not serial:
        monkeypatch.setattr(msm_kernels, "SERIAL_MAX_N", 4)
    _check_multi(2, 4, c=4, lanes=2, chunk=2)


@pytest.mark.slow
@pytest.mark.parametrize("nb", [2, 1])
def test_msm_affine_multi_g1_default_layout(nb):
    """nbatch 2 x 64 points and nbatch 1 at the default layout (K = 128)."""
    _check_multi(nb, 64)


@pytest.mark.slow
def test_msm_single_g1():
    rng = random.Random(5)
    pts, x, y = _affine_base(16, rng)
    scalars = [rng.randrange(params.FR_MODULUS) for _ in range(16)]
    out = msm.msm(g1.JacobianPoints(x, y, torch.from_numpy(np.ascontiguousarray(
        FQ.encode_fast([1] * 16, mont=True)))), _limbs(scalars))
    assert ref.affine(g1.decode_points(out)[0]) == _host_msm(scalars, pts)
