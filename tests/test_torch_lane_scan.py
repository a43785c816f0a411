"""The generic MSM engine's chunked segmented scan as the port runs it on the
card (``csrc/lane_scan.cu``: ``g1_lane_scan``, one B3 prefix of the lane
aggregates, ``g1_lane_carry``), on the CPU.

A model of the two kernels, thread by thread (the team scan of
``wide_scan_team.cuh`` at kind ``kLanes``: sub-run sums, the segmented
Hillis-Steele scan over the team, the lane outputs, the rescan from the
previous member's carry; then the carry pass, one thread a position), is
held against a serial segmented scan, the port's lane fold and the JAX
package's ``_seg_scan_chunked`` (its default combine) on integers mod a
prime, and against the plain versions of the two entries on G1's plain
additions. A model with a broken carry must disagree. The routing: on a CPU
tensor ``g1_group(...).lane_scan`` is the plain version, the old fold, limb
for limb."""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snarkos_tpu.crypto import params
from snarkos_tpu.crypto.ref import g1 as ref
from snarkos_tpu.ops import msm as jmsm
from snarkos_tpu_torch.ops import g1, g1_kernels, msm, msm_kernels
from snarkos_tpu_torch.ops.fieldspec import FQ

# the plain versions run many small tensor ops: intra-op threads only add
# contention when test workers share the CPU
torch.set_num_threads(1)

P = 1_000_003
Q = params.FQ_MODULUS


class ModOps:
    """Z_P standing in for G1: one (1, n) int64 component, the identity 0."""

    @staticmethod
    def identity(n):
        return (torch.zeros((1, n), dtype=torch.int64),)

    @staticmethod
    def add(a, b):
        return ((a[0] + b[0]) % P,)

    @staticmethod
    def same(a, b):
        return (a[0] == b[0])[0]


class G1Ops:
    """G1's plain additions; the identity is all-zero limbs, as the kernels
    start their scans from."""

    @staticmethod
    def identity(n):
        return tuple(torch.zeros((FQ.nlimbs, n), dtype=torch.int32) for _ in range(3))

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


def _lane_scan_model(ops, flags, pts, K, T):
    """``g1_lane_scan`` as the kernel runs it, vectorised over the K T
    threads (member t of lane c is thread c T + t; how the kernel packs the
    teams into blocks changes no value). Returns the lane-local values at
    every position, the aggregates (flag (1, K), values) and first_head (K,)
    int32."""
    n = flags.shape[-1]
    m = n // K
    s = -(-m // T)
    threads = K * T
    c_of = torch.arange(K).repeat_interleave(T)
    t_of = torch.arange(T).repeat(K)
    head_at = flags[0] != 0
    # past the lane's end: no elements
    i0 = torch.where(t_of * s < m, t_of * s, m)
    i1 = torch.clamp(i0 + s, max=m)

    def scan(acc, out=None):
        own = torch.zeros(threads, dtype=torch.bool)
        first = i1.clone()
        for i in range(s):
            elem = i0 + i
            valid = elem < i1
            e = c_of * m + elem.clamp(max=m - 1)
            q = _gather(pts, e)
            reset = valid & head_at[e]
            first = torch.where(reset & ~own, elem, first)
            own |= reset
            acc = _select(reset, q, _select(valid, ops.add(acc, q), acc))
            if out is not None:
                for o, v in zip(out, acc):
                    o[:, e[valid]] = v[:, valid]
        return acc, own, first

    # 1. sub-run sums from the identity
    F, own, first = scan(ops.identity(threads))
    # 2. inclusive segmented Hillis-Steele over the team
    H = own.clone()
    d = 1
    while d < T:
        upd = (t_of >= d) & ~H
        src = (torch.arange(threads) - d).clamp(min=0)
        F = _select(upd, ops.add(_gather(F, src), F), F)
        H = torch.where(upd, H[src], H)
        d <<= 1
    # the lane outputs: the first member with a head of its own writes the
    # lane's first head, member T - 1 the aggregate (and m if no head)
    prev = (torch.arange(threads) - 1).clamp(min=0)
    writer = own & ((t_of == 0) | ~H[prev])
    first_head = torch.full((K,), m, dtype=torch.int32)
    first_head[c_of[writer]] = first[writer].to(torch.int32)
    last = t_of == T - 1
    agg_flag = H[last].to(torch.int32).unsqueeze(0)
    agg = _gather(F, last.nonzero().squeeze(1))
    # 3. rescan from member t - 1's value, writing every position
    carry = _select(t_of > 0, _gather(F, prev), ops.identity(threads))
    out = tuple(torch.zeros((v.shape[0], n), dtype=v.dtype) for v in pts)
    scan(carry, out)
    return out, agg_flag, agg, first_head


def _lane_carry_model(ops, local, summ, first_head, m, broken=None):
    """``g1_lane_carry``, one thread a position e of lane k = e // m: for
    k >= 1 and e - k m < first_head[k], carry (the prefix at lane k - 1) +
    local. ``broken``: "lane" takes the carry of lane k itself, "first"
    ignores the first head (a mutation the tests must catch)."""
    n = local[0].shape[-1]
    e = torch.arange(n)
    k = e // m
    src = k if broken == "lane" else (k - 1).clamp(min=0)
    before = torch.ones(n, dtype=torch.bool) if broken == "first" else \
        e - k * m < first_head.long()[k]
    need = (k > 0) & before
    return _select(need, ops.add(_gather(summ, src), local), local)


def _seg_prefix_mod(flags, vals):
    """B3's function on Z_P: the port's Hillis-Steele round loop."""
    group = msm.GroupOps(identity=ModOps.identity, add=ModOps.add,
                         select=lambda mask, a, b: _select(mask, a, b))
    return msm._hillis_steele_prefix(msm._default_seg_combine(group), group,
                                     (flags,) + tuple(vals), flags.shape[-1], len(vals))


def _chunked_model(ops, prefix, flags, pts, K, T, broken=None):
    local, agg_flag, agg, first = _lane_scan_model(ops, flags, pts, K, T)
    summ = prefix(agg_flag, agg)[1:]
    return _lane_carry_model(ops, local, summ, first, flags.shape[-1] // K, broken), \
        (local, agg_flag, agg, first)


def _serial(flags, vals):
    out, acc = [], 0
    for f, v in zip(flags, vals):
        acc = v if f else (acc + v) % P
        out.append(acc)
    return out


def _jax_mod_group():
    def identity(n):
        return (jnp.zeros((1, n), jnp.int32),)

    def add(a, b):
        return ((a[0] + b[0]) % P,)

    def select(mask, a, b):
        return (jnp.where(mask[None], a[0], b[0]),)

    def gather(p, idx):
        return tuple(jnp.take(t, idx, axis=-1) for t in p)

    return jmsm.GroupOps(identity=identity, add=add, select=select, gather=gather)


# per case: lanes K, elements a lane m, team T, heads (positions) or a rule
MOD_CASES = {
    "heads only at 0": (4, 8, 4, [0]),
    "a head at every step": (4, 8, 4, "all"),
    "heads at lane starts": (4, 8, 4, [0, 8, 16, 24]),
    # a run from lane 0 over lanes 1 and 2 into lane 3; lane 3's first head
    # mid-lane, and lane 1 has none
    "runs across lanes": (4, 8, 4, [0, 3, 29, 30]),
    # s = 2: sub-runs [0-1] [2-3] [4-5]; heads at sub-run boundaries
    "T does not divide m": (3, 6, 4, [0, 2, 5, 10, 16]),
    # s = 1, members 6-7 own no elements
    "T > m": (4, 6, 8, [0, 7, 20]),
    "m = 1": (8, 1, 1, [0, 3, 4]),
    "m = 1, T > m": (8, 1, 4, [0, 5]),
}


def _mod_case(name):
    K, m, T, heads = MOD_CASES[name]
    n = K * m
    rng = random.Random(name)
    vals = [rng.randrange(P) for _ in range(n)]
    flags = [1] * n if heads == "all" else [int(e in heads) for e in range(n)]
    return K, m, T, flags, vals


@pytest.mark.parametrize("name", sorted(MOD_CASES))
def test_lane_scan_model_matches_fold_and_jax(name):
    K, m, T, flags, vals = _mod_case(name)
    ft = torch.tensor([flags], dtype=torch.int32)
    vt = (torch.tensor([vals], dtype=torch.int64),)
    got, (local, agg_flag, agg, first) = _chunked_model(ModOps, _seg_prefix_mod, ft, vt, K, T)
    want = _serial(flags, vals)
    assert got[0][0].tolist() == want
    # the lane outputs are each lane's own scan, its heads' OR and first head
    for k in range(K):
        lf, lv = flags[k * m:(k + 1) * m], vals[k * m:(k + 1) * m]
        lane = _serial([1] + lf[1:], lv)  # from the identity: element 0 whatever its flag
        assert local[0][0, k * m:(k + 1) * m].tolist() == lane
        assert int(agg_flag[0, k]) == max(lf) and int(agg[0][0, k]) == lane[-1]
        assert int(first[k]) == (lf.index(1) if 1 in lf else m)
    # the port's lane fold (a group without lane_scan) and the JAX engine's
    group = msm.GroupOps(identity=ModOps.identity, add=ModOps.add,
                         select=lambda mask, a, b: _select(mask, a, b))
    fold = msm._seg_scan_chunked(msm._default_seg_combine(group), group, ft, vt, K)
    assert fold[0][0].tolist() == want
    jgroup = _jax_mod_group()
    jwant = jmsm._seg_scan_chunked(jmsm._default_seg_combine(jgroup), jgroup,
                                   jnp.asarray(np.array([flags], dtype=np.int32)),
                                   (jnp.asarray(np.array([vals], dtype=np.int32)),), K)
    assert np.asarray(jwant[0])[0].tolist() == want


@pytest.mark.parametrize("broken", ["lane", "first"])
def test_lane_scan_model_with_a_broken_carry_fails(broken):
    """The carry taken from the wrong lane, or added past the lane's first
    head: the comparison above catches it."""
    K, m, T, flags, vals = _mod_case("runs across lanes")
    ft = torch.tensor([flags], dtype=torch.int32)
    vt = (torch.tensor([vals], dtype=torch.int64),)
    got, _ = _chunked_model(ModOps, _seg_prefix_mod, ft, vt, K, T, broken=broken)
    assert got[0][0].tolist() != _serial(flags, vals)


def _multiples(n, seed):
    rng = random.Random(seed)
    h = ref.scalar_mul(rng.randrange(1, params.FR_MODULUS), ref.GENERATOR)
    out, acc = [], h
    for _ in range(n):
        out.append(ref.from_affine(ref.affine(acc)))
        acc = ref.add(acc, h)
    return out


def _rescale(p, rng):
    if not p[2]:
        return p
    x, y = ref.affine(p)
    lam = rng.randrange(1, Q)
    return (x * lam * lam % Q, y * lam ** 3 % Q, lam)


def _g1_case(K, m, seed):
    """N = K m rescaled points with the edges of the complete add inside
    runs: a head P then P (a doubling) at 0 | 1, a head P then -P (the
    identity) at 5 | 6, an identity with arbitrary X, Y at N - 3; heads at
    0, 5 and 2 m + m / 2 + 1 where that is below N, so that some lane has
    none and its run comes from the lane before."""
    n = K * m
    rng = random.Random(seed)
    pool = _multiples(6, seed)
    pts = [_rescale(pool[rng.randrange(6)], rng) for _ in range(n)]
    pts[1] = _rescale(pts[0], rng)
    pts[6] = _rescale(ref.neg(pts[5]), rng)
    pts[n - 3] = (rng.randrange(Q), rng.randrange(Q), 0)
    heads = [int(e in (0, 5, 2 * m + m // 2 + 1)) for e in range(n)]
    return g1.encode_points(pts), heads, pts


def _g1_prefix(agg_flag, agg):
    return g1_kernels.seg_prefix_plain((agg_flag,) + tuple(agg))


@pytest.mark.parametrize("K,m,T", [(4, 4, 2), (2, 8, 16)])
def test_lane_scan_model_g1(K, m, T):
    """Real G1 at N = 16: the model against the plain entries (the same
    points at every position and in the aggregates, the flags and first
    heads exactly; the carry pass limb for limb) and the whole against the
    lane fold and the host's serial scan."""
    enc, heads, pts = _g1_case(K, m, 10 * K + T)
    flags = torch.tensor([heads], dtype=torch.int32)
    xyz = (enc.x, enc.y, enc.z)
    got, (local, agg_flag, agg, first) = _chunked_model(G1Ops, _g1_prefix, flags, xyz, K, T)
    plain = g1_kernels.lane_scan_plain(flags, *xyz, K)
    assert bool(G1Ops.same(local, plain[:3]).all())
    assert torch.equal(agg_flag, plain[3]) and torch.equal(first, plain[7])
    assert bool(G1Ops.same(agg, plain[4:7]).all())
    summ = _g1_prefix(agg_flag, agg)
    carried = g1_kernels.lane_carry_plain(*local, *summ[1:], first, m)
    for a, b in zip(_lane_carry_model(G1Ops, local, summ[1:], first, m), carried):
        assert torch.equal(a, b)
    group = dataclasses.replace(msm.g1_group("cpu"), lane_scan=None)
    fold = msm._seg_scan_chunked(msm._default_seg_combine(group), group, flags, xyz, K)
    assert bool(G1Ops.same(got, fold).all())
    out = g1.decode_points(g1.JacobianPoints(*got))
    acc = ref.INFINITY
    for e in range(K * m):
        acc = pts[e] if heads[e] else ref.add(acc, pts[e])
        assert ref.affine(out[e]) == ref.affine(acc), e
    assert any(not p[2] for p in out), "no P + (-P) in the case"


def test_g1_group_lane_scan_is_the_fold_on_cpu():
    """On a CPU tensor the G1 group's lane_scan is the plain version: the
    lane fold, limb for limb; the entries' plain versions composed through
    their dispatchers give the same points."""
    K, m = 4, 4
    enc, heads, _ = _g1_case(K, m, 5)
    flags = torch.tensor([heads], dtype=torch.int32)
    xyz = (enc.x, enc.y, enc.z)
    group = msm.g1_group("cpu")
    assert group.lane_scan is not None
    seg = msm._default_seg_combine(group)
    got = msm._seg_scan_chunked(seg, group, flags, xyz, K)
    old = dataclasses.replace(group, lane_scan=None)
    want = msm._seg_scan_chunked(msm._default_seg_combine(old), old, flags, xyz, K)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    ox, oy, oz, *agg, first = g1_kernels.lane_scan(flags, *xyz, K, 2)
    summ = g1_kernels.seg_prefix(tuple(agg))
    composed = g1_kernels.lane_carry(ox, oy, oz, *summ[1:], first, m)
    assert bool(G1Ops.same(composed, got).all())


def test_seg_scan_chunked_takes_group_lane_scan():
    """A group's lane_scan replaces the fold, one call with (flags, pts, K);
    without one the fold runs (the mock groups, msm_dist's custom ones)."""
    calls = []

    def lane_scan(flags, pts, K):
        calls.append((flags, pts, K))
        return "whole scan"

    base = msm.GroupOps(identity=ModOps.identity, add=ModOps.add,
                        select=lambda mask, a, b: _select(mask, a, b))
    flags = torch.tensor([[1, 0, 0, 1, 0, 0, 0, 0]], dtype=torch.int32)
    vals = (torch.tensor([[5, 7, 11, 13, 17, 19, 23, 29]], dtype=torch.int64),)
    group = dataclasses.replace(base, lane_scan=lane_scan)
    assert msm._seg_scan_chunked(None, group, flags, vals, 2) == "whole scan"
    assert len(calls) == 1 and calls[0][1] is vals and calls[0][2] == 2
    out = msm._seg_scan_chunked(msm._default_seg_combine(base), base, flags, vals, 2)
    assert out[0].tolist() == [[5, 12, 23, 13, 30, 49, 72, 101]]


@pytest.mark.parametrize("m,T", [(1, 1), (6, 4), (16, 8), (256, 128), (4096, 256), (1 << 14, 256)])
def test_lane_team(m, T):
    """g1_lane_scan's team: two elements a thread (the power of two at or
    above m / 2), at most 256 threads a lane."""
    assert msm_kernels.lane_team(m) == T
