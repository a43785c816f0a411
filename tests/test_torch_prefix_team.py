"""Kernels B3 and B4 of the port as redesigned for the card, on the CPU:
B3's one-launch segmented prefix (``seg_prefix_plain``) against the
Hillis-Steele round loop of the MSM engine, limb for limb; the routing of
``_hillis_steele_prefix``; the projective comparison ``g1.same_points``; and
a model of B4's three-phase team scan (``csrc/bucket_scan_serial.cu``,
written here with the plain curve additions) against the serial scan it
replaces. The slow tier holds B3's plain version against the JAX package's
prefix scan with its G1 operator."""

import dataclasses
import random

import numpy as np
import pytest
import torch

from snarkos_tpu.crypto import params
from snarkos_tpu.crypto.ref import g1 as ref
from snarkos_tpu_torch.ops import g1, g1_kernels, msm, msm_kernels
from snarkos_tpu_torch.ops import modarith as fa
from snarkos_tpu_torch.ops.fieldspec import FQ

# the plain versions run many small tensor ops: intra-op threads only add
# contention when test workers share the CPU
torch.set_num_threads(1)

Q = params.FQ_MODULUS


def _multiples(n, seed):
    """n distinct multiples of a random point (Jacobian, z = 1)."""
    rng = random.Random(seed)
    h = ref.scalar_mul(rng.randrange(1, params.FR_MODULUS), ref.GENERATOR)
    out, acc = [], h
    for _ in range(n):
        out.append(ref.from_affine(ref.affine(acc)))
        acc = ref.add(acc, h)
    return out


def _rescale(p, rng):
    """Another Jacobian representative of the same point."""
    if not p[2]:
        return p
    x, y = ref.affine(p)
    lam = rng.randrange(1, Q)
    return (x * lam * lam % Q, y * lam ** 3 % Q, lam)


def _odd_identity(rng):
    return (rng.randrange(Q), rng.randrange(Q), 0)


# -- g1.same_points ---------------------------------------------------------------


def test_same_points():
    rng = random.Random(3)
    P = _multiples(4, 30)
    a = [_rescale(P[0], rng), _odd_identity(rng), _rescale(P[1], rng), P[2], ref.INFINITY, P[3]]
    b = [_rescale(P[0], rng), _odd_identity(rng), _rescale(ref.neg(P[1]), rng), ref.INFINITY,
         P[2], _rescale(P[0], rng)]
    got = g1.same_points(g1.encode_points(a), g1.encode_points(b))
    assert got.tolist() == [True, True, False, False, False, False]
    # batch shape kept: (L, m, K) in, (m, K) out
    pa, pb = g1.encode_points(a[:4]), g1.encode_points(a[:4])
    grid = g1.same_points(*(g1.JacobianPoints(*(t.reshape(24, 2, 2) for t in (p.x, p.y, p.z)))
                            for p in (pa, pb)))
    assert grid.shape == (2, 2) and bool(grid.all())


# -- B3: the one-launch segmented prefix ----------------------------------------


def _prefix_state(width, seed):
    """(flags, x, y, z) over ``width`` lanes: random heads, rescaled points,
    and edge lanes where a round meets P == Q, P == -Q or an identity with
    arbitrary X, Y (lanes past the width are dropped)."""
    rng = random.Random(seed)
    pool = _multiples(8, seed)
    pts = [_rescale(pool[rng.randrange(8)], rng) for _ in range(width)]
    heads = np.random.default_rng(seed).integers(0, 5, size=width) == 0
    A, B = pool[0], pool[1]
    edges = {
        2: _odd_identity(rng),                          # identity operand
        3: A, 4: _rescale(A, rng),                      # round 0: P == Q
        5: B, 6: _rescale(ref.neg(B), rng),             # round 0: P == -Q
        # round 1 (distance 2) at lane 11: (A + B) + (A + B)
        8: A, 9: B, 10: _rescale(A, rng), 11: _rescale(B, rng),
        # round 1 at lane 15: (A + B) + (-A - B)
        12: A, 13: B, 14: _rescale(ref.neg(A), rng), 15: _rescale(ref.neg(B), rng),
    }
    for e, p in edges.items():
        if e < width:
            pts[e] = p
            heads[e] = e in (3, 5, 8, 12)
    enc = g1.encode_points(pts)
    flags = torch.from_numpy(heads.astype(np.int32)).reshape(1, width)
    return (flags, enc.x, enc.y, enc.z), pts, heads


@pytest.mark.parametrize("width", [1, 5, 33, 64])
def test_seg_prefix_plain_matches_round_loop(width):
    state, pts, heads = _prefix_state(width, 100 + width)
    got = g1_kernels.seg_prefix_plain(state)
    loop_group = dataclasses.replace(msm.g1_group("cpu"), seg_prefix=None)
    want = msm._hillis_steele_prefix(g1_kernels.seg_combine_plain, loop_group, state, width, 3)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the wrapper on a CPU tensor is the plain version
    for g, w in zip(g1_kernels.seg_prefix(state), got):
        assert torch.equal(g, w)
    # and the values are the segmented inclusive sums
    out = g1.decode_points(g1.JacobianPoints(*got[1:]))
    acc = ref.INFINITY
    for e in range(width):
        acc = pts[e] if heads[e] else ref.add(acc, pts[e])
        assert ref.affine(out[e]) == ref.affine(acc), e
    assert got[0][0].tolist() == np.maximum.accumulate(heads.astype(np.int32)).tolist()


def _mock_group(**kw):
    mod = 1_000_003

    def identity(n):
        return (torch.zeros((1, n), dtype=torch.int64),)

    def add(a, b):
        return ((a[0] + b[0]) % mod,)

    def select(mask, a, b):
        return (torch.where(mask.unsqueeze(0), a[0], b[0]),)

    return msm.GroupOps(identity=identity, add=add, select=select, **kw), mod


def test_hillis_steele_prefix_takes_group_seg_prefix():
    """A group's seg_prefix replaces the round loop; without one the loop
    runs (the mock groups of the engine tests)."""
    flags = torch.tensor([[1, 0, 0, 1, 0, 0, 0]], dtype=torch.int32)
    vals = torch.tensor([[5, 7, 11, 13, 17, 19, 23]], dtype=torch.int64)
    calls = []

    def seg_prefix(state):
        calls.append(state)
        return "whole prefix"

    group, _ = _mock_group(seg_prefix=seg_prefix)
    seg = msm._default_seg_combine(group)
    assert msm._hillis_steele_prefix(seg, group, (flags, vals), 7, 1) == "whole prefix"
    assert len(calls) == 1 and calls[0][1] is vals

    group, mod = _mock_group()
    out = msm._hillis_steele_prefix(msm._default_seg_combine(group), group, (flags, vals), 7, 1)
    assert out[1].tolist() == [[5, 12, 23, 13, 30, 49, 72]]
    assert out[0].tolist() == [[1, 1, 1, 1, 1, 1, 1]]


# -- B4: the team scan ----------------------------------------------------------------


def _team_scan_model(xs, ys, flags, T):
    """B4's three phases as the kernel runs them, vectorised over the T * K
    threads (thread t of chain k is lane t K + k): sub-run scans from the
    identity, the exclusive segmented scan of the sub-run sums over t, and
    the rescan from the carries, with the plain g1.madd / g1.add."""
    L, m, K = xs.shape
    s = -(-m // T)
    lanes = T * K
    t_of = torch.arange(T).repeat_interleave(K)
    k_of = torch.arange(K).repeat(T)
    one = fa.broadcast_const(FQ, 1, (lanes,))
    zeros = g1.JacobianPoints(*(torch.zeros((L, lanes), dtype=torch.int32) for _ in range(3)))

    def scan(acc, out=None):
        head = torch.zeros(lanes, dtype=torch.bool)
        for i in range(s):
            j = t_of * s + i
            valid = j < m
            jc = j.clamp(max=m - 1)
            qx, qy = xs[:, jc, k_of], ys[:, jc, k_of]
            reset = valid & (flags[0, jc, k_of] != 0)
            step = g1.madd(acc, qx, qy, one=one)
            acc = g1.select_points(reset, g1.JacobianPoints(qx, qy, one.expand_as(qx)),
                                   g1.select_points(valid, step, acc))
            head |= reset
            if out is not None:
                for o, c in zip(out, (acc.x, acc.y, acc.z)):
                    o[:, j[valid], k_of[valid]] = c[:, valid]
        return acc, head

    F, H = scan(zeros)
    d = 1
    while d < T:  # inclusive segmented Hillis-Steele over t
        upd = (t_of >= d) & ~H
        src = (torch.arange(lanes) - d * K).clamp(min=0)
        a = g1.JacobianPoints(F.x[:, src], F.y[:, src], F.z[:, src])
        F = g1.select_points(upd, g1.add(a, F), F)
        H = torch.where(upd, H[src], H)
        d <<= 1
    prev = (torch.arange(lanes) - K).clamp(min=0)
    carry = g1.select_points(t_of > 0, g1.JacobianPoints(F.x[:, prev], F.y[:, prev], F.z[:, prev]),
                             zeros)
    out = tuple(torch.zeros((L, m, K), dtype=torch.int32) for _ in range(3))
    scan(carry, out)
    return out


# per case: rows m, chains K, team T, and per chain (head rows, {row: (copy of
# row, negated)}). s = ceil(m / T) rows a thread.
TEAM_CASES = {
    # s = 3, sub-runs [0-2] [3-5] [6-8] [9]: heads at every sub-run start;
    # one segment over all four; P | P over 2|3 and P | -P over 5|6
    "m10_K3_T4": (10, 3, 4, [({0, 3, 6, 9}, {}), ({0}, {}),
                             ({0, 2, 5}, {3: (2, False), 6: (5, True)})]),
    # s = 1: a boundary between every two rows
    "m8_K2_T8": (8, 2, 8, [({0, 3, 5}, {4: (3, False), 6: (5, True)}),
                           ({0, 2}, {})]),
    # s = 2: threads 5-7 own no rows; P | -P over 5|6, P | P over 7|8
    "m10_K3_T8": (10, 3, 8, [({0, 2, 4, 6, 8}, {}), ({0}, {}),
                             ({0, 5, 7}, {6: (5, True), 8: (7, False)})]),
}


@pytest.mark.parametrize("case", sorted(TEAM_CASES))
def test_team_scan_model_same_points_as_serial(case):
    m, K, T, chains = TEAM_CASES[case]
    rng = random.Random(len(case) + m * K * T)
    pool = [ref.affine(p) for p in _multiples(12, m + K + T)]
    pts = [[pool[rng.randrange(12)] for _ in range(K)] for _ in range(m)]
    heads = [[0] * K for _ in range(m)]
    for k, (hrows, copies) in enumerate(chains):
        for j in hrows:
            heads[j][k] = 1
        for j, (src, neg) in copies.items():
            x, y = pts[src][k]
            pts[j][k] = (x, (-y) % Q if neg else y)
    xs = torch.stack([g1.encode_points([ref.from_affine(pts[j][k]) for k in range(K)]).x
                      for j in range(m)], dim=1)
    ys = torch.stack([g1.encode_points([ref.from_affine(pts[j][k]) for k in range(K)]).y
                      for j in range(m)], dim=1)
    flags = torch.tensor([heads], dtype=torch.int32)
    got = g1.JacobianPoints(*_team_scan_model(xs, ys, flags, T))
    want = g1.JacobianPoints(*msm_kernels.bucket_scan_serial_plain(xs, ys, flags))
    same = g1.same_points(got, want)
    assert same.shape == (m, K)
    assert bool(same.all()), same.logical_not().nonzero().tolist()
    # the edges really are there: P + P and P + (-P) inside a segment
    zs = g1.decode_points(want)
    assert any(z[2] == 0 for z in zs), "no P + (-P) in the case"


@pytest.mark.slow
@pytest.mark.parametrize("width", [8, 33])
def test_seg_prefix_plain_limb_exact_against_jax(width):
    """B3's plain version limb for limb against the JAX package's
    ``_hillis_steele_prefix`` with its G1 group and operator (XLA:CPU
    compiles the G1 add in minutes)."""
    import jax.numpy as jnp

    from snarkos_tpu.ops import g1 as jg1
    from snarkos_tpu.ops import msm as jmsm

    state, _, _ = _prefix_state(width, 7 + width)

    def identity(n):
        p = jg1.infinity((n,))
        return (p.x, p.y, p.z)

    def add(a, b):
        out = jg1.add(jg1.JacobianPoints(*a), jg1.JacobianPoints(*b))
        return (out.x, out.y, out.z)

    def select(mask, a, b):
        return tuple(jnp.where(mask[None], x, y) for x, y in zip(a, b))

    def gather(p, idx):
        return tuple(jnp.take(t, idx, axis=-1) for t in p)

    jgroup = jmsm.GroupOps(identity=identity, add=add, select=select, gather=gather)
    want = jmsm._hillis_steele_prefix(jmsm._default_seg_combine(jgroup), jgroup,
                                      tuple(jnp.asarray(t.numpy()) for t in state), width, 3)
    got = g1_kernels.seg_prefix_plain(state)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
