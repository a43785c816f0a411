"""Kernels B6 and B5 of the port as redesigned for the card, on the CPU: a
model of their three-phase team scan (``csrc/wide_scan_team.cuh``) written
over the wide chain layout, held against the serial walks of
``bucket_scan_fast_plain`` and ``bucket_scan_plain``. For B6 the exception
flag must agree bit for bit, and the values at every position of a live
bucket in an unflagged chain must be the same points; for B5 (the complete
add in the rescan, no flag) the values at every position. The model runs on
a cheap exact group (integers mod a prime, with an incomplete add that flags
P == +-Q and returns garbage with Z = 0, as ``g1.madd_incomplete`` does) for
team sizes 1 to 16, and on G1's plain additions."""

import random

import numpy as np
import pytest
import torch

from snarkos_tpu.crypto import params
from snarkos_tpu.crypto.ref import g1 as ref
from snarkos_tpu_torch.ops import g1, msm_kernels
from snarkos_tpu_torch.ops import modarith as fa
from snarkos_tpu_torch.ops.fieldspec import FQ

# the plain versions run many small tensor ops: intra-op threads only add
# contention when test workers share the CPU
torch.set_num_threads(1)

P = 1_000_003


class ModOps:
    """Z_P standing in for G1. A point is (v, z) of (1, n) int64 tensors, the
    identity where z == 0 (whatever v); an affine input (qx, qy) is the value
    qx (qy is not read)."""

    @staticmethod
    def identity(n):
        zero = torch.zeros((1, n), dtype=torch.int64)
        return (zero, zero)

    @staticmethod
    def from_affine(qx, qy):
        return (qx, torch.ones_like(qx))

    @staticmethod
    def madd(acc, qx, qy):
        v, z = acc
        s = (v + qx) % P
        inf = z == 0
        return (torch.where(inf, qx, s), torch.where(inf, 1, (s != 0).long()))

    @staticmethod
    def madd_incomplete(acc, qx, qy):
        v, z = acc
        inf = z == 0
        exc = ~inf & ((v == qx) | ((v + qx) % P == 0))
        out_v = torch.where(inf, qx, torch.where(exc, (7 * v + 3) % P, (v + qx) % P))
        return (out_v, (~exc).long()), exc[0]

    @staticmethod
    def add(a, b):
        (va, za), (vb, zb) = a, b
        s = (va + vb) % P
        return (torch.where(za == 0, vb, torch.where(zb == 0, va, s)),
                torch.where(za == 0, zb, torch.where(zb == 0, za, (s != 0).long())))

    @staticmethod
    def same(a, b):
        (va, za), (vb, zb) = a, b
        return ((za == 0) & (zb == 0) | (za != 0) & (zb != 0) & (va == vb))[0]


class G1Ops:
    """G1's plain additions (ops/g1.py) on (x, y, z) tuples; the identity is
    all-zero limbs, as the kernels start their scans from."""

    @staticmethod
    def identity(n):
        return tuple(torch.zeros((FQ.nlimbs, n), dtype=torch.int32) for _ in range(3))

    @staticmethod
    def from_affine(qx, qy):
        return (qx, qy, fa.broadcast_const(FQ, 1, (qx.shape[-1],)))

    @staticmethod
    def madd(acc, qx, qy):
        out = g1.madd(g1.JacobianPoints(*acc), qx, qy)
        return (out.x, out.y, out.z)

    @staticmethod
    def madd_incomplete(acc, qx, qy):
        out, exc = g1.madd_incomplete(g1.JacobianPoints(*acc), qx, qy)
        return (out.x, out.y, out.z), exc

    @staticmethod
    def add(a, b):
        out = g1.add(g1.JacobianPoints(*a), g1.JacobianPoints(*b))
        return (out.x, out.y, out.z)

    @staticmethod
    def same(a, b):
        return g1.same_points(g1.JacobianPoints(*a), g1.JacobianPoints(*b))


def _select(mask, a, b):
    return tuple(torch.where(mask.unsqueeze(0), x, y) for x, y in zip(a, b))


def _gather(p, idx):
    return tuple(t[:, idx] for t in p)


def _team_model(ops, xs, ys, flags, nonzero, chunk, T, complete=False):
    """B6's three phases as the kernel runs them, vectorised over the T KV
    threads (member t of chain l is lane t KV + l; how the kernel packs the
    teams into blocks changes no value): sub-run scans from the identity with
    the complete madd, an inclusive segmented Hillis-Steele scan of the
    sub-run sums over t with the complete add, and the rescan from member
    t - 1's value with the incomplete madd, flagging exceptional steps that
    are neither heads nor in bucket 0. ``complete``: B5, the rescan with the
    complete madd and no flag (``nonzero`` unread). Returns (values
    (L, m, K), exc (1, chunk, K) int32, all 0 for B5)."""
    L, m, K = xs.shape
    mv, kv = m // chunk, chunk * K
    s = -(-mv // T)
    lanes = T * kv
    t_of = torch.arange(T).repeat_interleave(kv)
    l_of = torch.arange(kv).repeat(T)
    xv, yv = xs.reshape(L, -1), ys.reshape(L, -1)  # element i of chain l at i KV + l
    head_at = flags.reshape(-1) != 0

    def scan(acc, rescan):
        seen = torch.zeros(lanes, dtype=torch.bool)
        out = tuple(v.new_zeros((v.shape[0], mv * kv)) for v in acc)
        for i in range(s):
            elem = t_of * s + i
            valid = elem < mv
            e = elem.clamp(max=mv - 1) * kv + l_of
            qx, qy = xv[:, e], yv[:, e]
            reset = valid & head_at[e]
            if rescan and not complete:
                step, exc = ops.madd_incomplete(acc, qx, qy)
                seen |= valid & ~reset & exc & (nonzero.reshape(-1)[e] != 0)
            elif rescan:
                step = ops.madd(acc, qx, qy)
            else:
                step = ops.madd(acc, qx, qy)
                seen |= reset
            acc = _select(reset, ops.from_affine(qx, qy), _select(valid, step, acc))
            for o, v in zip(out, acc):
                o[:, e[valid]] = v[:, valid]
        return acc, seen, out

    F, H, _ = scan(ops.identity(lanes), rescan=False)
    d = 1
    while d < T:  # inclusive segmented Hillis-Steele over t
        upd = (t_of >= d) & ~H
        src = (torch.arange(lanes) - d * kv).clamp(min=0)
        F = _select(upd, ops.add(_gather(F, src), F), F)
        H = torch.where(upd, H[src], H)
        d <<= 1
    prev = (torch.arange(lanes) - kv).clamp(min=0)
    carry = _select(t_of > 0, _gather(F, prev), ops.identity(lanes))
    _, hit, out = scan(carry, rescan=True)
    exc = hit.reshape(T, kv).any(0).to(torch.int32).reshape(1, chunk, K)
    return tuple(v.reshape(v.shape[0], m, K) for v in out), exc


def _serial(ops, xs, ys, flags, nonzero, chunk, complete=False):
    """The serial walk of ``bucket_scan_fast_plain`` in the ops of a group:
    every chain from the identity, reset at heads, the incomplete madd, the
    flag the OR of exc & ~head & nonzero; ``complete``: that of
    ``bucket_scan_plain``, the complete madd and no flag."""
    L, m, K = xs.shape
    mv, kv = m // chunk, chunk * K
    xv, yv = xs.reshape(L, mv, kv), ys.reshape(L, mv, kv)
    heads = flags.reshape(mv, kv) != 0
    acc = ops.identity(kv)
    flag = torch.zeros(kv, dtype=torch.bool)
    rows = []
    for i in range(mv):
        qx, qy = xv[:, i], yv[:, i]
        if complete:
            step = ops.madd(acc, qx, qy)
        else:
            step, exc = ops.madd_incomplete(acc, qx, qy)
            flag |= exc & ~heads[i] & (nonzero.reshape(mv, kv)[i] != 0)
        acc = _select(heads[i], ops.from_affine(qx, qy), step)
        rows.append(acc)
    vals = tuple(torch.stack([r[c] for r in rows], dim=1).reshape(L, m, K)
                 for c in range(len(acc)))
    return vals, flag.to(torch.int32).reshape(1, chunk, K)


def _structure(mv, kv, T, seed):
    """Sorted positions p = l mv + i (chain l, element i): head flags,
    bucket keys, and the planted steps {p: +1 for P == Q, -1 for P == -Q}
    against the chain's running sum, for a team of T (sub-runs of
    s = ceil(mv / T) elements). Chains 2, 3 and 4 must flag, the others not.
      chain 0: all bucket 0, P == Q at element 1;
      chain 1: starts inside bucket 0 (no head), P == -Q at element 2, then
               live buckets;
      chain 2: P == Q at the first step of member 1 (its carry), or mid-chain
               for T = 1;
      chain 3: P == -Q at the last step of member 1 (of member 0 for T = 1);
      chain 4: starts mid-segment (no head at element 0), P == -Q at element 1
               and P == Q again near its end;
      chain 5: heads at every sub-run start, one of them a P == Q step;
      chain 6: one segment from element 0 on, so every member's carry counts;
      chain 7: random heads, nothing planted."""
    n = mv * kv
    s = -(-mv // T)
    rng = np.random.default_rng(seed)
    head = rng.random(n) < 0.25
    z0 = mv + 3  # bucket 0 covers chain 0 and the start of chain 1
    head[1:z0] = False
    head[0] = head[z0] = True
    plants = {1: 1, mv + 2: -1, 2 * mv + (s if s < mv else mv // 2): 1,
              3 * mv + min(2 * s, mv) - 1: -1, 4 * mv + 1: -1, 5 * mv - 2: 1}
    for p in plants:
        head[p] = False
    head[4 * mv] = False
    head[6 * mv + 1:7 * mv] = False
    starts = [5 * mv + i for i in range(0, mv, s)]
    head[starts] = True
    plants[starts[-1] if len(starts) > 1 else 5 * mv] = 1  # masked: a head
    keys = np.where(np.arange(n) < z0, 0, np.cumsum(head) - 1)
    return head, keys, plants


def _layout(vals, mv, kv, K):
    """Per sorted position p -> the (m, K) layout: element i of chain l at
    flat position i KV + l."""
    p = np.arange(mv * kv)
    flat = np.empty_like(vals)
    flat[(p % mv) * kv + p // mv] = vals
    return flat.reshape(mv * kv // K, K)


def _mod_case(mv, chunk, K, T, seed):
    kv = chunk * K
    head, keys, plants = _structure(mv, kv, T, seed)
    val = np.random.default_rng(seed + 1).integers(1, P, size=mv * kv)
    acc = 0  # the chain's running sum with the complete add, 0 = identity
    for p in range(mv * kv):
        if p % mv == 0:
            acc = 0
        if p in plants and acc:
            val[p] = acc if plants[p] > 0 else P - acc
        acc = val[p] if head[p] else (acc + val[p]) % P
    xs = torch.from_numpy(_layout(val, mv, kv, K)).reshape(1, -1, K)
    flags = torch.from_numpy(_layout(head.astype(np.int32), mv, kv, K)).reshape(1, -1, K)
    nz = torch.from_numpy(_layout((keys > 0).astype(np.int32), mv, kv, K)).reshape(1, -1, K)
    return xs, torch.zeros_like(xs), flags, nz


def _check(ops, xs, ys, flags, nz, chunk, T, want=None):
    """The model against the serial walk (or ``want``, its values and
    flags): exc bit for bit, the same points at live positions of unflagged
    chains. Returns the serial flags."""
    got, got_exc = _team_model(ops, xs, ys, flags, nz, chunk, T)
    vals, exc = want if want is not None else _serial(ops, xs, ys, flags, nz, chunk)
    assert got_exc.tolist() == exc.tolist()
    L, m, K = xs.shape
    kv = chunk * K
    chain = torch.arange(m * K) % kv
    checked = (nz.reshape(-1) != 0) & (exc.reshape(-1)[chain] == 0)
    same = ops.same(tuple(v.reshape(v.shape[0], -1) for v in got),
                    tuple(v.reshape(v.shape[0], -1) for v in vals))
    assert bool(same[checked].all()), (~same & checked).nonzero().reshape(-1).tolist()
    assert int(checked.sum()) >= 3 * (m // chunk)  # chains 5-7 at least
    return exc


FLAGGED = [0, 0, 1, 1, 1, 0, 0, 0]  # the chains of ``_structure`` that flag


@pytest.mark.parametrize("mv", [12, 5])
@pytest.mark.parametrize("T", [1, 2, 4, 8, 16])
def test_team_model_mod_group(T, mv):
    """Team sizes 1-16 over 8 chains of 12 or 5 elements: at T = 16 most
    members have no elements, at T = 1 there is no carry scan."""
    chunk, K = 2, 4
    xs, ys, flags, nz = _mod_case(mv, chunk, K, T, seed=100 * T + mv)
    exc = _check(ModOps, xs, ys, flags, nz, chunk, T)
    assert exc.reshape(-1).tolist() == FLAGGED


def _g1_case(mv, chunk, K, T, seed):
    """``_structure``'s chains with G1 points: random multiples of a point,
    the planted steps against the chain's running sum on the host."""
    kv = chunk * K
    head, keys, plants = _structure(mv, kv, T, seed)
    rng = random.Random(seed)
    h = ref.scalar_mul(rng.randrange(1, params.FR_MODULUS), ref.GENERATOR)
    pts = [ref.affine(ref.scalar_mul(rng.randrange(1, 1 << 32), h)) for _ in range(mv * kv)]
    acc = ref.INFINITY
    for p in range(mv * kv):
        if p % mv == 0:
            acc = ref.INFINITY
        if p in plants and acc[2]:
            pts[p] = ref.affine(acc if plants[p] > 0 else ref.neg(acc))
        q = ref.from_affine(pts[p])
        acc = q if head[p] else ref.add(acc, q)
    idx = _layout(np.arange(mv * kv), mv, kv, K).reshape(-1)
    enc = g1.encode_points([ref.from_affine(pts[p]) for p in idx])
    xs, ys = (t.reshape(FQ.nlimbs, -1, K) for t in (enc.x, enc.y))
    flags = torch.from_numpy(_layout(head.astype(np.int32), mv, kv, K)).reshape(1, -1, K)
    nz = torch.from_numpy(_layout((keys > 0).astype(np.int32), mv, kv, K)).reshape(1, -1, K)
    return xs, ys, flags, nz


@pytest.mark.parametrize("T", [2, 4])
def test_team_model_g1_against_bucket_scan_fast_plain(T):
    """One small real-G1 case, 8 chains of 4 elements (32 positions): the
    model against ``bucket_scan_fast_plain`` itself, which the generic serial
    walk above reproduces limb for limb."""
    chunk, K, mv = 2, 4, 4
    xs, ys, flags, nz = _g1_case(mv, chunk, K, T, seed=7 + T)
    *vals, exc = msm_kernels.bucket_scan_fast_plain(xs, ys, flags, nz, chunk)
    serial_vals, serial_exc = _serial(G1Ops, xs, ys, flags, nz, chunk)
    assert torch.equal(serial_exc, exc)
    for a, b in zip(serial_vals, vals):
        assert torch.equal(a, b)
    _check(G1Ops, xs, ys, flags, nz, chunk, T, want=(tuple(vals), exc))
    assert exc.reshape(-1).tolist() == FLAGGED


def _check_complete(ops, xs, ys, flags, chunk, T, want):
    """B5's model against the serial complete walk's values ``want``: the
    same points at every position, bucket 0 and heads included."""
    got, exc = _team_model(ops, xs, ys, flags, None, chunk, T, complete=True)
    assert not exc.any()
    same = ops.same(tuple(v.reshape(v.shape[0], -1) for v in got),
                    tuple(v.reshape(v.shape[0], -1) for v in want))
    assert bool(same.all()), (~same).nonzero().reshape(-1).tolist()


@pytest.mark.parametrize("mv", [12, 5])
@pytest.mark.parametrize("T", [1, 2, 4, 8, 16])
def test_team_model_complete_mod_group(T, mv):
    """B5's team body (the complete madd in the rescan, no flag) over
    ``_structure``'s chains, whose planted P == +-Q steps sit at chain
    starts, on both sides of the sub-run boundaries, in bucket 0 and after
    heads: equal to the serial complete scan at every position."""
    chunk, K = 2, 4
    xs, ys, flags, _ = _mod_case(mv, chunk, K, T, seed=100 * T + mv)
    want, _ = _serial(ModOps, xs, ys, flags, None, chunk, complete=True)
    _check_complete(ModOps, xs, ys, flags, chunk, T, want)


def test_team_model_complete_g1_against_bucket_scan_plain():
    """One small real-G1 case for B5 (8 chains of 4 elements, T = 4): the
    model against ``bucket_scan_plain`` itself, which the generic serial walk
    reproduces limb for limb."""
    chunk, K, mv, T = 2, 4, 4, 4
    xs, ys, flags, _ = _g1_case(mv, chunk, K, T, seed=21)
    vals = msm_kernels.bucket_scan_plain(xs, ys, flags, chunk)
    serial_vals, _ = _serial(G1Ops, xs, ys, flags, None, chunk, complete=True)
    for a, b in zip(serial_vals, vals):
        assert torch.equal(a, b)
    _check_complete(G1Ops, xs, ys, flags, chunk, T, vals)


def test_team_size():
    assert msm_kernels.team_size(16, 256) == 16
    assert msm_kernels.team_size(64, 5) == 8
    assert msm_kernels.team_size(16, 1) == 1
    assert msm_kernels.team_size(msm_kernels.FAST_TEAM, 8) == min(msm_kernels.FAST_TEAM, 8)
    assert msm_kernels.team_size(msm_kernels.SCAN_TEAM, 32) == msm_kernels.SCAN_TEAM
