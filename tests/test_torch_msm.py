"""The port's MSM engine on the CPU: the combinatorics with a mock group
(mirroring tests/test_msm.py's fused-engine tests on the serial-chain path),
the signed digits against the JAX package, and real G1 multi-MSMs against
host sums."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snarkos_tpu.crypto import params
from snarkos_tpu.crypto.ref import g1 as ref
from snarkos_tpu.ops import msm as jmsm
from snarkos_tpu_torch.ops import g1, msm
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


def _mock3_scan_serial(xs, ys, flags, lanes, chunk):
    """Serial-chain mock scan: chain k owns rows j = 0..m-1 of lane k; input
    point (x, y) contributes (x, y, 1)."""
    L, m, K = xs.shape
    outs = []
    for v in (xs, ys, torch.ones_like(xs)):
        carry = torch.zeros((L, K), dtype=torch.int64)
        rows = []
        for j in range(m):
            reset = flags[:, j, :] != 0
            carry = torch.where(reset, v[:, j, :].long(), (carry + v[:, j, :]) % MOCK_MOD)
            rows.append(carry)
        outs.append(torch.stack(rows, dim=1).to(torch.int32))
    return tuple(outs)


@pytest.mark.parametrize("c", [4, 6])
@pytest.mark.parametrize("n,lanes,chunk", [(16, 4, 2), (64, 8, 4), (100, 4, 2)])
def test_fused_engine_mock_group(c, n, lanes, chunk):
    """sum_i k_i y_i in the y-component of the mock group (signs enter via
    the [y | -y] gather), serial-chain layout."""
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
    out = msm._fused_msm_body(x_arr, ycat, packed, c, lanes, chunk, group=_mock3_group(),
                              scan_fn=_mock3_scan_serial, serial=True)
    assert int(out[1][0, 0]) == sum(k * y for k, y in zip(scalars, ys)) % MOCK_MOD


@pytest.mark.parametrize("nbatch,c,nper,lanes,chunk",
                         [(2, 4, 16, 4, 2), (3, 6, 64, 8, 4), (4, 4, 20, 4, 2)])
def test_fused_engine_multi_mock_group(nbatch, c, nper, lanes, chunk):
    """nbatch > 1 multi-MSM (shared base, per-batch bucket ranges): each
    batch's y-component total matches its own scalar set."""
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
    out = msm._fused_msm_body(x_arr, ycat, packed, c, lanes, chunk, group=_mock3_group(),
                              scan_fn=_mock3_scan_serial, serial=True, nbatch=nbatch)
    for i in range(nbatch):
        expect = sum(k * y for k, y in zip(scalars[i], ys)) % MOCK_MOD
        assert int(out[1][0, i]) == expect, f"batch {i}"


def test_unported_paths_raise():
    x = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="B5"):
        msm._fused_msm_body(x, x.repeat(1, 2), torch.zeros((2, 8), dtype=torch.int32), 4, 4,
                            2, group=_mock3_group(), serial=False)
    big = torch.zeros((16, 1, msm.msm_kernels.SERIAL_MAX_N + 1), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="B5"):
        msm.msm_affine_multi(torch.zeros((24, big.shape[-1]), dtype=torch.int32),
                             torch.zeros((24, big.shape[-1]), dtype=torch.int32), big)


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


def test_msm_affine_multi_g1_tiny():
    """Real G1, nbatch 2 x 4 points (zero scalar, r - 1, a repeated point),
    on a narrow chain layout so the plain versions finish in seconds."""
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
