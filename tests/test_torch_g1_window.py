"""Kernel B2's window entry points on the CPU: ``horner_plain`` (acc =
2^c acc + t, one step of ``horner_chain``) and ``bucket_fixup_plain`` (a
window's bucket sums) against the compositions of ``g1.add`` calls that
they replace in the MSM's window loop, limb for limb, with identity lanes
and P == +-Q; and the routing of ``_fused_msm_body`` through a group's
``horner_chain`` and ``bucket_fixup``. The kernels' index derivation and the
chain's plain version: tests/test_torch_window_tail.py."""

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
    return dataclasses.replace(msm.g1_group("cpu"), horner_chain=None, bucket_fixup=None)


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
    group = _loop_group()
    want = _coords(a)
    for _ in range(c):
        want = group.add(want, want)
    want = group.add(want, _coords(b))
    _assert_limbs(_coords(got), want)
    # the chain wrapper on the CPU over windows (b, a): its top window's add
    # to the identity returns a as it is
    stack = tuple(torch.stack([u, v]) for u, v in zip(_coords(b), _coords(a)))
    _assert_limbs(_coords(g1_kernels.horner_chain(stack, c)), want)
    out = g1.decode_points(got)
    for i, (p, q) in enumerate(zip(acc, t)):
        assert ref.affine(out[i]) == ref.affine(ref.add(ref.scalar_mul(1 << c, p), q)), i
    assert int(got.z[:, 4].abs().sum()) == 0 and int(got.z[:, 3].abs().sum()) != 0


# Two windows of 32 sorted positions in 8 chains of 4 (serial: K = 8, rows =
# 1; wide: K = 4, rows = 2), as (nbatch, B, keys). Each has buckets that are
# empty or bucket 0 of a batch, that take their tail alone (a head in their
# chain before it, also at the chain start), and four whose runs cross into
# a later chain and take its carry.
FIXUP_WINDOWS = {
    1: (1, 9, [0] * 3 + [1] * 6 + [2] * 2 + [4] * 7 + [5] + [6] * 6 + [7] * 2 + [8] * 5),
    2: (2, 5, [0] * 2 + [1] * 5 + [2] + [3] * 4 + [5] * 6 + [6] * 3 + [7] * 6 + [9] * 5),
}


def fixup_window(keys, K, rows, nbatch, B, rng):
    """A window's inputs to ``bucket_fixup`` over ``keys`` (sorted): the
    head flags in the chain layout of ``msm.chain_src``, scan values and
    chain prefixes of rescaled random points with identities (arbitrary X,
    Y) at some positions, and at the buckets that take a carry, in turn, a
    finite carry, an identity, P == Q and P == -Q. Returns (scan, keys,
    heads, summ) tensors, the host points (scan by flat position, summ by
    chain) and the carry buckets."""
    n = len(keys)
    src = msm.chain_src(n, K, rows, rows == 1)
    m = n // K
    head = [1] + [int(keys[i] != keys[i - 1]) for i in range(1, n)]
    heads = torch.tensor([head[i] for i in src.reshape(-1).tolist()],
                         dtype=torch.int32).reshape(m, K)
    keys_t = torch.tensor(keys, dtype=torch.int64)
    pool = [ref.scalar_mul(rng.randrange(1, params.FR_MODULUS), ref.GENERATOR) for _ in range(6)]
    scan_pts = [_rescale(pool[rng.randrange(6)], rng) for _ in range(n)]
    scan_pts[5::7] = [_odd_identity(rng) for _ in scan_pts[5::7]]
    summ_pts = [_rescale(pool[rng.randrange(6)], rng) for _ in range(K * rows)]
    flat, chain_of, needs, live = g1_kernels.bucket_indices(keys_t, heads, K, rows, nbatch, B)
    takers = [b for b in range(nbatch * B) if live[b] and needs[b] and chain_of[b] > 0]
    assert len(takers) >= 4
    for i, b in enumerate(takers):
        tail = scan_pts[int(flat[b])]
        if not tail[2]:
            tail = scan_pts[int(flat[b])] = _rescale(pool[0], rng)
        summ_pts[int(chain_of[b]) - 1] = (
            _rescale(pool[1], rng), _odd_identity(rng), _rescale(tail, rng),
            _rescale(ref.neg(tail), rng))[i % 4]
    scan = tuple(t.reshape(24, m, K) for t in _coords(g1.encode_points(scan_pts)))
    summ = _coords(g1.encode_points(summ_pts))
    return (scan, keys_t, heads, summ), scan_pts, summ_pts, takers


@pytest.mark.parametrize("nbatch", [1, 2])
def test_bucket_fixup_plain_is_the_gathers_add_and_selects(nbatch):
    """A window's bucket sums from its raw inputs (serial layout, nbatch 1 and
    2): the G1 plain version equals the group route (index glue, gathers,
    the add and selects as group calls) limb for limb, and every bucket is
    its tail, plus the carry where its run crossed a chain start, or the
    identity (g1.infinity's limbs) on the host."""
    rng = random.Random(50 + nbatch)
    nb_, B, keys = FIXUP_WINDOWS[nbatch]
    K, rows = 8, 1
    args, scan_pts, summ_pts, takers = fixup_window(keys, K, rows, nb_, B, rng)
    got = g1_kernels.bucket_fixup_plain(*args, K, rows, nb_, B)
    want = msm._bucket_sums(_loop_group(), *args, K, rows, nb_, B)
    _assert_limbs(_coords(got), want)
    _assert_limbs(_coords(g1_kernels.bucket_fixup(*args, K, rows, nb_, B)), want)
    flat, chain_of, needs, live = g1_kernels.bucket_indices(*args[1:3], K, rows, nb_, B)
    out = g1.decode_points(got)
    inf = g1.infinity((1,))
    for b in range(nb_ * B):
        if not live[b]:
            assert all(torch.equal(u[:, b:b + 1], v) for u, v in zip(_coords(got), _coords(inf)))
            continue
        s = scan_pts[int(flat[b])]
        if needs[b] and chain_of[b] > 0:
            s = ref.add(s, summ_pts[int(chain_of[b]) - 1])
        assert ref.affine(out[b]) == ref.affine(s), b
    assert int(got.z[:, takers[3]].abs().sum()) == 0  # P == -Q: Z = 0


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
    """A group with ``horner_chain`` and ``bucket_fixup`` takes one chain call
    a MSM and one fixup call a window in place of the c + 2 adds a window of
    the loop; the result equals the mock group's loop (which the JAX engine
    pins in tests/test_torch_msm.py)."""
    rng = random.Random(60)
    n, c, lanes, chunk = 16, 4, 2, 2
    x = torch.tensor([rng.randrange(1, MOCK_MOD) for _ in range(n)], dtype=torch.int32)
    y = [rng.randrange(1, MOCK_MOD) for _ in range(n)]
    ycat = torch.tensor(y + [(MOCK_MOD - v) % MOCK_MOD for v in y], dtype=torch.int32)
    scalars = [rng.randrange(params.FR_MODULUS) for _ in range(n)]
    packed = msm.signed_window_digits(torch.from_numpy(FR.encode(scalars, mont=False)), c)
    base = _mock3_group()
    calls = {"horner_chain": 0, "bucket_fixup": 0, "add": 0}

    def add(a, b):
        calls["add"] += 1
        return base.add(a, b)

    loop = dataclasses.replace(base, add=add)

    def horner_chain(ts, c_):
        calls["horner_chain"] += 1
        return msm._horner_chain(base, ts, c_)

    def bucket_fixup(*args):
        calls["bucket_fixup"] += 1
        return msm._bucket_sums(base, *args)

    fused = dataclasses.replace(loop, horner_chain=horner_chain, bucket_fixup=bucket_fixup)

    def scan(xs, ys, flags, lanes_, chunk_):  # serial chains: the wide scan with chunk 1
        return _mock3_scan(xs, ys, flags, lanes_, 1 if serial else chunk_)

    def run(group):
        return msm._fused_msm_body(x.reshape(1, n), ycat.reshape(1, 2 * n), packed, c, lanes,
                                   chunk, group=group, scan_fn=scan, serial=serial)

    want = run(loop)
    loop_adds, calls["add"] = calls["add"], 0
    got = run(fused)
    W = packed.shape[0]
    assert calls["horner_chain"] == 1 and calls["bucket_fixup"] == W
    assert loop_adds - calls["add"] == W * (c + 2)  # the suffix scans' adds remain
    _assert_limbs(got, want)
    assert int(got[1][0, 0]) == sum(k * v for k, v in zip(scalars, y)) % MOCK_MOD


def test_g1_group_has_the_fused_entry_points():
    group = msm.g1_group("cpu")
    assert group.horner_chain is not None and group.bucket_fixup is not None
    assert group.seg_prefix is g1_kernels.seg_prefix
    t = g1.encode_points([ref.GENERATOR])
    out = group.horner_chain([_coords(t), _coords(g1.infinity((1,)))], 2)
    assert ref.affine(g1.decode_points(g1.JacobianPoints(*out))[0]) == ref.affine(ref.GENERATOR)
    assert np.array_equal(out[2].numpy(), t.z.numpy())
