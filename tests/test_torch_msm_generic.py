"""The port's generic MSM engine (``msm_generic``, ``_seg_scan_chunked``) on
the CPU: on tests/test_msm.py's mock group against the JAX package's
``msm_generic`` with many steps a lane (m > 1), its chunked segmented scan
against a serial scan where segments cross lanes, and, in the slow tier,
real G1 with identities at the lane boundaries against the host sum."""

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

MOCK_MOD = 1_000_000_007


def _mock_group():
    """Integers mod MOCK_MOD, one (1, N) int32 component (tests/test_msm.py)."""

    def identity(n):
        return (torch.zeros((1, n), dtype=torch.int32),)

    def add(a, b):
        return (((a[0].long() + b[0]) % MOCK_MOD).to(torch.int32),)

    def select(mask, a, b):
        return (torch.where(mask.unsqueeze(0), a[0], b[0]),)

    return msm.GroupOps(identity=identity, add=add, select=select)


def _jax_mock_group():
    def identity(n):
        return (jnp.zeros((1, n), jnp.int32),)

    def add(a, b):
        return ((a[0] + b[0]) % MOCK_MOD,)

    def select(mask, a, b):
        return (jnp.where(mask[None], a[0], b[0]),)

    def gather(p, idx):
        return tuple(jnp.take(t, idx, axis=-1) for t in p)

    return jmsm.GroupOps(identity=identity, add=add, select=select, gather=gather)


@pytest.mark.parametrize("c,n,chunk_lanes", [(4, 16, 4), (5, 24, 8), (4, 64, 8)])
def test_msm_generic_mock_matches_jax(c, n, chunk_lanes):
    """sum_i k_i x_i over Z_M through the whole engine, with m = n / K > 1
    steps a lane and zero scalars: equal to the JAX engine and the sum."""
    rng = random.Random(c * 1000 + n)
    scalars = [rng.randrange(params.FR_MODULUS) for _ in range(n)]
    scalars[1] = scalars[n // 2] = 0
    xs = [rng.randrange(MOCK_MOD) for _ in range(n)]
    limbs = FR.encode(scalars, mont=False)
    pts = np.array([xs], dtype=np.int32)
    got = msm.msm_generic(_mock_group(), (torch.from_numpy(pts),), torch.from_numpy(limbs), c,
                          chunk_lanes)
    want = jmsm.msm_generic(_jax_mock_group(), (jnp.asarray(pts),), jnp.asarray(limbs), c,
                            chunk_lanes)
    assert got[0].shape == (1, 1)
    assert int(got[0][0, 0]) == int(np.asarray(want[0])[0, 0]) == \
        sum(k * x for k, x in zip(scalars, xs)) % MOCK_MOD


def _serial_seg_scan(flags, vals):
    out, acc = [], 0
    for f, v in zip(flags, vals):
        acc = v if f else (acc + v) % MOCK_MOD
        out.append(acc)
    return out


@pytest.mark.parametrize("heads", ["first only", "one lane start", "mid lanes"])
def test_seg_scan_chunked_crosses_lanes(heads):
    """The chunked scan at K = 4 lanes of m = 6 steps equals a serial
    segmented scan: a segment running over several lanes (the pass-1 seed
    is flag 0, the lane-0 carry flag 1), a head at a lane start, heads
    mid-lane."""
    n, K = 24, 4
    rng = random.Random(len(heads))
    vals = [rng.randrange(MOCK_MOD) for _ in range(n)]
    flags = [0] * n
    flags[0] = 1
    if heads == "one lane start":
        flags[12] = 1
    elif heads == "mid lanes":
        flags[3] = flags[4] = flags[15] = 1
    group = _mock_group()
    seg = msm._default_seg_combine(group)
    got = msm._seg_scan_chunked(seg, group, torch.tensor([flags], dtype=torch.int32),
                                (torch.tensor([vals], dtype=torch.int32),), K)
    assert got[0][0].tolist() == _serial_seg_scan(flags, vals)


def test_default_window_bits_matches_jax():
    for n in (1, 8, 16, 300, 4096, 1 << 16, 1 << 20):
        assert msm.default_window_bits(n) == jmsm.default_window_bits(n)
    assert msm.default_window_bits(1 << 16) == 13


@pytest.mark.slow
def test_msm_generic_g1_lane_boundaries():
    """Real G1 (plain versions): 8 Jacobian bases, z != 1, identities at the
    start and end of lane 1 and at the start of lane 3 (K = 4 lanes of
    m = 2), a zero scalar, c = 4: equal to the host sum."""
    rng = random.Random(77)
    pts = []
    for _ in range(8):
        p = ref.scalar_mul(rng.randrange(1, params.FR_MODULUS), ref.GENERATOR)
        s = rng.randrange(2, FQ.p)
        pts.append((p[0] * s * s % FQ.p, p[1] * s ** 3 % FQ.p, p[2] * s % FQ.p))
    for i in (2, 3, 6):
        pts[i] = ref.INFINITY
    scalars = [rng.randrange(params.FR_MODULUS) for _ in range(8)]
    scalars[5] = 0
    out = msm._msm_jacobian(g1.encode_points(pts),
                            torch.from_numpy(FR.encode(scalars, mont=False)), c=4, chunk_lanes=4)
    acc = ref.INFINITY
    for k, p in zip(scalars, pts):
        acc = ref.add(acc, ref.scalar_mul(k, p))
    assert ref.affine(g1.decode_points(out)[0]) == ref.affine(acc)
