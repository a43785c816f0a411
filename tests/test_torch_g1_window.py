"""Kernel B2's window entry points on the CPU: ``horner_plain`` (acc =
2^c acc + t) and ``bucket_fixup_plain`` (a window's bucket sums) against the
compositions of ``g1.add`` calls that they replace in the MSM's window loop,
limb for limb, with identity lanes and P == +-Q; and the routing of
``_fused_msm_body`` through a group's ``horner`` and ``bucket_fixup``."""

import dataclasses
import random

import numpy as np
import pytest
import torch

from snarkos_tpu.crypto import params
from snarkos_tpu.crypto.ref import g1 as ref
from snarkos_tpu_torch.ops import g1, g1_kernels, msm
from snarkos_tpu_torch.ops.fieldspec import FR

# the plain versions run many small tensor ops: intra-op threads only add
# contention when test workers share the CPU
torch.set_num_threads(1)

Q = params.FQ_MODULUS
MOCK_MOD = 1_000_000_007


def _rescale(p, rng):
    """Another Jacobian representative of the same point."""
    if not p[2]:
        return p
    x, y = ref.affine(p)
    lam = rng.randrange(1, Q)
    return (x * lam * lam % Q, y * lam ** 3 % Q, lam)


def _odd_identity(rng):
    return (rng.randrange(Q), rng.randrange(Q), 0)


def _loop_group():
    """The G1 group without the fused entry points: the window loop's adds."""
    return dataclasses.replace(msm.g1_group("cpu"), horner=None, bucket_fixup=None)


def _coords(p):
    return (p.x, p.y, p.z)


def _assert_limbs(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("c", [1, 3])
def test_horner_plain_is_c_self_adds_then_an_add(c):
    """Lanes: finite acc and t; an identity acc with arbitrary X, Y (kept
    through the doublings); an identity t; 2^c acc == t and 2^c acc == -t
    (the final add meets P == Q and P == -Q); both identities."""
    rng = random.Random(40 + c)
    pts = [ref.scalar_mul(rng.randrange(1, params.FR_MODULUS), ref.GENERATOR) for _ in range(4)]
    acc = [_rescale(pts[0], rng), _odd_identity(rng), _rescale(pts[1], rng),
           _rescale(pts[2], rng), _rescale(pts[3], rng), _odd_identity(rng)]
    t = [_rescale(pts[3], rng), _rescale(pts[1], rng), _odd_identity(rng),
         _rescale(ref.scalar_mul(1 << c, pts[2]), rng),
         _rescale(ref.neg(ref.scalar_mul(1 << c, pts[3])), rng), ref.INFINITY]
    a, b = g1.encode_points(acc), g1.encode_points(t)
    got = g1_kernels.horner_plain(a, b, c)
    want = msm._horner(_loop_group(), _coords(a), _coords(b), c)
    _assert_limbs(_coords(got), want)
    _assert_limbs(_coords(g1_kernels.horner(a, b, c)), want)  # the wrapper on the CPU
    out = g1.decode_points(got)
    for i, (p, q) in enumerate(zip(acc, t)):
        assert ref.affine(out[i]) == ref.affine(ref.add(ref.scalar_mul(1 << c, p), q)), i
    assert int(got.z[:, 4].abs().sum()) == 0 and int(got.z[:, 3].abs().sum()) != 0


def test_bucket_fixup_plain_is_the_gathers_add_and_selects():
    """Scan values (24, 4, 3) and carries (24, 6) of rescaled points and
    identities; buckets that take their tail alone, add a carry (finite, an
    identity, P == Q, P == -Q), or are not live."""
    rng = random.Random(50)
    pool = [ref.scalar_mul(rng.randrange(1, params.FR_MODULUS), ref.GENERATOR) for _ in range(5)]
    scan_pts = [_rescale(pool[rng.randrange(5)], rng) for _ in range(12)]
    scan_pts[5] = _odd_identity(rng)
    carry_pts = [_rescale(pool[rng.randrange(5)], rng) for _ in range(6)]
    carry_pts[2] = _odd_identity(rng)
    carry_pts[3] = _rescale(scan_pts[7], rng)             # P == Q
    carry_pts[4] = _rescale(ref.neg(scan_pts[9]), rng)    # P == -Q
    enc = g1.encode_points(scan_pts)
    scan = tuple(t.reshape(24, 4, 3) for t in _coords(enc))
    carry = _coords(g1.encode_points(carry_pts))
    flat = torch.tensor([0, 7, 9, 5, 5, 11, 3, 2, 7])
    chain_of = torch.tensor([0, 3, 4, 2, 1, 2, 5, 0, 3])
    needs_carry = torch.tensor([0, 1, 1, 1, 1, 1, 0, 1, 1], dtype=torch.bool)
    live = torch.tensor([1, 1, 1, 1, 1, 1, 1, 0, 0], dtype=torch.bool)
    got = g1_kernels.bucket_fixup_plain(scan, flat, carry, chain_of, needs_carry, live)
    want = msm._bucket_sums(_loop_group(), scan, flat, carry, chain_of, needs_carry, live)
    _assert_limbs(_coords(got), want)
    _assert_limbs(_coords(g1_kernels.bucket_fixup(scan, flat, carry, chain_of, needs_carry,
                                                  live)), want)
    out = g1.decode_points(got)
    for b in range(flat.shape[0]):
        s = scan_pts[int(flat[b])]
        if needs_carry[b]:
            s = ref.add(s, carry_pts[int(chain_of[b])])
        assert ref.affine(out[b]) == (ref.affine(s) if live[b] else ref.affine(ref.INFINITY)), b
    inf = g1.infinity((2,))  # not live: g1.infinity's limbs
    _assert_limbs((got.x[:, 7:], got.y[:, 7:], got.z[:, 7:]), _coords(inf))


def _mock3_group(**kw):
    """Z_M^3 with componentwise addition as a stand-in for (x, y, z)."""

    def identity(n):
        return tuple(torch.zeros((1, n), dtype=torch.int32) for _ in range(3))

    def add(a, b):
        return tuple(((x.long() + y) % MOCK_MOD).to(torch.int32) for x, y in zip(a, b))

    def select(mask, a, b):
        return tuple(torch.where(mask.unsqueeze(0), x, y) for x, y in zip(a, b))

    return msm.GroupOps(identity=identity, add=add, select=select, **kw)


def _mock3_scan(xs, ys, flags, lanes, chunk):
    """The mock group's segmented scan over chunk * K wide chains."""
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


@pytest.mark.parametrize("serial", [False, True])
def test_fused_body_routes_through_horner_and_bucket_fixup(serial):
    """A group with ``horner`` and ``bucket_fixup`` takes one call of each a
    window in place of the c + 2 adds of the loop; the result equals the
    mock group's loop (which the JAX engine pins in tests/test_torch_msm.py)."""
    rng = random.Random(60)
    n, c, lanes, chunk = 16, 4, 2, 2
    x = torch.tensor([rng.randrange(1, MOCK_MOD) for _ in range(n)], dtype=torch.int32)
    y = [rng.randrange(1, MOCK_MOD) for _ in range(n)]
    ycat = torch.tensor(y + [(MOCK_MOD - v) % MOCK_MOD for v in y], dtype=torch.int32)
    scalars = [rng.randrange(params.FR_MODULUS) for _ in range(n)]
    packed = msm.signed_window_digits(torch.from_numpy(FR.encode(scalars, mont=False)), c)
    base = _mock3_group()
    calls = {"horner": 0, "bucket_fixup": 0, "add": 0}

    def add(a, b):
        calls["add"] += 1
        return base.add(a, b)

    loop = dataclasses.replace(base, add=add)

    def horner(acc, t, c_):
        calls["horner"] += 1
        return msm._horner(base, acc, t, c_)

    def bucket_fixup(*args):
        calls["bucket_fixup"] += 1
        return msm._bucket_sums(base, *args)

    fused = dataclasses.replace(loop, horner=horner, bucket_fixup=bucket_fixup)

    def scan(xs, ys, flags, lanes_, chunk_):  # serial chains: the wide scan with chunk 1
        return _mock3_scan(xs, ys, flags, lanes_, 1 if serial else chunk_)

    def run(group):
        return msm._fused_msm_body(x.reshape(1, n), ycat.reshape(1, 2 * n), packed, c, lanes,
                                   chunk, group=group, scan_fn=scan, serial=serial)

    want = run(loop)
    loop_adds, calls["add"] = calls["add"], 0
    got = run(fused)
    W = packed.shape[0]
    assert calls["horner"] == calls["bucket_fixup"] == W
    assert loop_adds - calls["add"] == W * (c + 2)  # the suffix scans' adds remain
    _assert_limbs(got, want)
    assert int(got[1][0, 0]) == sum(k * v for k, v in zip(scalars, y)) % MOCK_MOD


def test_g1_group_has_the_fused_entry_points():
    group = msm.g1_group("cpu")
    assert group.horner is not None and group.bucket_fixup is not None
    assert group.seg_prefix is g1_kernels.seg_prefix
    acc = g1.infinity((1,))
    t = g1.encode_points([ref.GENERATOR])
    out = group.horner(_coords(acc), _coords(t), 2)
    assert ref.affine(g1.decode_points(g1.JacobianPoints(*out))[0]) == ref.affine(ref.GENERATOR)
    assert np.array_equal(out[2].numpy(), t.z.numpy())
