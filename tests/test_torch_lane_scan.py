"""The generic MSM engine's window as the port runs it on the card
(``csrc/lane_scan.cu``: ``g1_lane_buckets``, one B3 prefix of the lane
aggregates, ``g1_lane_bucket_carry``), on the CPU.

A model of the two kernels, thread by thread where the threads differ and
member by member elsewhere (the tile staging's index math; each member's
walk, which writes the final tails and the empty buckets and keeps its
open tail; the members' up-sweep and down-sweep; the one add for a
member's open tail; then the carry pass, one team a lane), is held against
the serial bucket sums, the port's plain hook (the JAX order: the lane fold
and the tails' gather) and the JAX package's ``_seg_scan_chunked`` plus the
tails' gather on integers mod a prime, and against the plain versions of
the two entries on G1's plain additions. Models whose carry comes from the
wrong lane or the wrong member, or lands on a bucket whose run began inside
the lane, must disagree. The routing: on a CPU tensor
``g1_group(...).window_bucket_sums`` is the plain version, the JAX order,
limb for limb."""

import dataclasses
import os
import random
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snarkos_tpu.crypto import params
from snarkos_tpu.crypto.ref import g1 as ref
from snarkos_tpu.ops import msm as jmsm
from snarkos_tpu_torch.ops import _build, g1, g1_kernels, msm, msm_kernels
from snarkos_tpu_torch.ops.fieldspec import FQ

# the plain versions run many small tensor ops: intra-op threads only add
# contention when test workers share the CPU
torch.set_num_threads(1)

P = 1_000_003
Q = params.FQ_MODULUS
with open(os.path.join(_build.CSRC, "lane_scan.cu")) as _f:
    _SRC = _f.read()
# the kernel's positions a tile
TILE = int(re.search(r"constexpr int kTile = (\d+);", _SRC).group(1))
POINT = 36  # packed words of a point


class ModOps:
    """Z_P standing in for G1: one (1, n) int64 component, the identity 0."""

    @staticmethod
    def identity(n):
        return (torch.zeros((1, n), dtype=torch.int64),)

    @staticmethod
    def add(a, b):
        return ((a[0] + b[0]) % P,)


class G1Ops:
    """G1's plain additions; the identity is all-zero limbs, as the kernel
    resets its scan values."""

    @staticmethod
    def identity(n):
        return tuple(torch.zeros((FQ.nlimbs, n), dtype=torch.int32) for _ in range(3))

    @staticmethod
    def add(a, b):
        out = g1.add(g1.JacobianPoints(*a), g1.JacobianPoints(*b))
        return (out.x, out.y, out.z)


def _select(mask, a, b):
    return tuple(torch.where(mask.unsqueeze(0), x, y) for x, y in zip(a, b))


def _gather(p, idx):
    return tuple(t[:, idx] for t in p)


def _put(dst, idx, src, mask):
    """dst[:, idx[mask]] = src[:, mask], in place."""
    for d, v in zip(dst, src):
        d[:, idx[mask]] = v[:, mask]


def _bucket_identity(ops, B):
    """The identity the kernel writes into a bucket: g1.infinity's limbs
    for G1, 0 on Z_P."""
    if ops is G1Ops:
        inf = g1.infinity((B,))
        return (inf.x.clone(), inf.y.clone(), inf.z.clone())
    return ops.identity(B)


def _staging(cnt):
    """The (word k, position jj, tile slot) loads of a tile of cnt
    positions as the member's thread issues them: pair p = 0 .. 36 cnt - 1
    is word k = p // cnt of position jj = p % cnt, stored at slot
    jj 36 + k."""
    return [(p // cnt, p % cnt, (p % cnt) * POINT + p // cnt) for p in range(POINT * cnt)]


def _lane_buckets_model(ops, keys, pts, K, B, M, broken=None):
    """``g1_lane_buckets`` as the kernel runs it, vectorised over the K M
    members (member t of lane l; how the kernel packs members into blocks
    and threads changes no value). Every bucket must be written exactly
    once. ``broken="member"`` gives an open tail the carry of the member
    before (a mutation the tests must catch). Returns the buckets, the
    aggregates (flag (1, K), values), first_head and carry_key (K,)."""
    n = keys.shape[0]
    m = n // K
    s = -(-m // M)
    members = K * M
    lane = torch.arange(K).repeat_interleave(M)
    t_of = torch.arange(M).repeat(K)
    i0 = torch.where(t_of * s < m, t_of * s, m)
    i1 = torch.clamp(i0 + s, max=m)
    kp = torch.cat([torch.tensor([-1]), keys, torch.tensor([B])])  # sentinels at -1 and n

    buckets = _bucket_identity(ops, B)
    writes = torch.zeros(B, dtype=torch.int64)
    ident_b = _bucket_identity(ops, 1)

    def write(b, vals=None):
        writes[b] += 1
        src = ident_b if vals is None or b == 0 else vals
        for d, v in zip(buckets, src):
            d[:, b] = v[:, 0]

    acc = ops.identity(members)
    own = torch.zeros(members, dtype=torch.bool)
    open_ = torch.ones(members, dtype=torch.bool)
    has_open = torch.zeros(members, dtype=torch.bool)
    open_key = torch.full((members,), -1)
    open_sum = ops.identity(members)
    first = torch.full((members,), m)
    # 1. the walk: step i of every member at once
    for i in range(s):
        idx = i0 + i
        valid = idx < i1
        e = lane * m + idx.clamp(max=m - 1)
        prev, key, nxt = kp[e], kp[e + 1], kp[e + 2]
        head = valid & (prev != key)
        tail = valid & (nxt != key)
        q = _gather(pts, e)
        first = torch.where(head & ~own, idx, first)
        own |= head
        open_ &= ~head
        start = valid & (head | (idx == i0))
        acc = _select(start, q, _select(valid, ops.add(acc, q), acc))
        for u in (valid & (prev < 0)).nonzero().squeeze(1).tolist():
            for b in range(int(key[u])):
                write(b)
        ot = tail & open_
        has_open |= ot
        open_key = torch.where(ot, key, open_key)
        open_sum = _select(ot, acc, open_sum)
        open_ &= ~ot
        for u in (tail & ~ot).nonzero().squeeze(1).tolist():
            write(int(key[u]), _gather(acc, [u]))
        for u in tail.nonzero().squeeze(1).tolist():
            for b in range(int(key[u]) + 1, int(nxt[u])):
                write(b)
    scan = _select(i1 > i0, acc, ops.identity(members))
    # 2. the members' segmented scan: the up-sweep, the aggregate, the
    # down-sweep
    sub = own.clone()
    me = torch.arange(members)
    d = 1
    while d < M:
        act = t_of % (2 * d) == 2 * d - 1
        left = (me - d).clamp(min=0)
        scan = _select(act & ~sub, ops.add(_gather(scan, left), scan), scan)
        sub = torch.where(act, sub | sub[left], sub)
        d <<= 1
    root = (t_of == M - 1).nonzero().squeeze(1)
    agg_flag = sub[root].to(torch.int32).unsqueeze(0)
    agg = _gather(scan, root)
    scan = _select(t_of == M - 1, ops.identity(members), scan)
    d = M // 2
    while d >= 1:
        act = t_of % (2 * d) == 2 * d - 1
        left = (me - d).clamp(min=0)
        lv = _gather(scan, left)
        right = _select(sub[left], lv, ops.add(scan, lv))
        new = tuple(t.clone() for t in scan)
        _put(new, me, right, act)
        _put(new, left, scan, act)
        scan = new
        d //= 2
    # 3. the open tails and the lane outputs
    own_l = own.reshape(K, M).to(torch.int64)
    before = (own_l.cumsum(1) - own_l).reshape(-1) > 0
    carry = scan
    if broken == "member":
        carry = _gather(scan, (me - 1).clamp(min=0))
    value = _select(t_of > 0, ops.add(carry, open_sum), open_sum)
    carry_key = torch.full((K,), -1, dtype=torch.int32)
    first_head = torch.full((K,), m, dtype=torch.int32)
    for u in has_open.nonzero().squeeze(1).tolist():
        write(int(open_key[u]), _gather(value, [u]))
        if not before[u]:
            carry_key[lane[u]] = int(open_key[u])
    for u in (own & ~before).nonzero().squeeze(1).tolist():
        first_head[lane[u]] = int(first[u])
    assert writes.tolist() == [1] * B, "a bucket was not written exactly once"
    return buckets, agg_flag, agg, first_head, carry_key


def _carry_model(ops, buckets, summ, carry_key, broken=None):
    """``g1_lane_bucket_carry``, one team a lane k: for k >= 1 and
    carry_key[k] = b > 0, bucket b := summ[k - 1] + bucket b. ``broken``:
    "lane" takes the prefix of lane k itself, "inside" also carries into a
    lane's first tail whose run began inside the lane (mutations the tests
    must catch; the latter needs ``inside_keys``, see ``_chunked_model``)."""
    out = tuple(t.clone() for t in buckets)
    for k, b in enumerate(carry_key.tolist()):
        if k < 1 or b <= 0:
            continue
        src = k if broken == "lane" else k - 1
        v = ops.add(_gather(summ, [src]), _gather(out, [b]))
        for o, x in zip(out, v):
            o[:, b] = x[:, 0]
    return out


def _first_tail_keys(keys, K):
    """Each lane's first tail's key (-1 if the lane has none), whether or
    not that run began in an earlier lane."""
    m = keys.shape[0] // K
    tails = torch.cat([keys[1:] != keys[:-1], torch.tensor([True])]).reshape(K, m)
    first = tails.int().argmax(1)
    return torch.where(tails.any(1), keys.reshape(K, m)[torch.arange(K), first], -1)


def _seg_prefix_mod(flags, vals):
    """B3's function on Z_P: the port's Hillis-Steele round loop."""
    group = _mod_group()
    return msm._hillis_steele_prefix(msm._default_seg_combine(group), group,
                                     (flags,) + tuple(vals), flags.shape[-1], len(vals))


def _chunked_model(ops, prefix, keys, pts, K, B, M, broken=None):
    buckets, agg_flag, agg, first, carry_key = _lane_buckets_model(ops, keys, pts, K, B, M,
                                                                  broken)
    if broken == "inside":
        carry_key = _first_tail_keys(keys, K).to(torch.int32)
    summ = prefix(agg_flag, agg)[1:]
    return _carry_model(ops, buckets, summ, carry_key, broken), \
        (buckets, agg_flag, agg, first, carry_key)


def _mod_group():
    return msm.GroupOps(identity=ModOps.identity, add=ModOps.add,
                        select=lambda mask, a, b: _select(mask, a, b))


def _serial_sums(keys, vals, B):
    """The bucket sums by a serial walk: bucket b the sum of its run, 0 for
    bucket 0 and the empty ones."""
    out = [0] * B
    for k, v in zip(keys, vals):
        out[k] = (out[k] + v) % P
    out[0] = 0
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


def _jax_sums(keys, vals, K, B):
    """The JAX engine's order: its ``_seg_scan_chunked`` with the default
    combine, then each bucket's value at its last position
    (snarkos_tpu/ops/msm.py:220-226)."""
    jgroup = _jax_mod_group()
    k = np.array(keys, dtype=np.int32)
    head = np.concatenate([[1], (k[1:] != k[:-1]).astype(np.int32)])[None]
    scanned = jmsm._seg_scan_chunked(jmsm._default_seg_combine(jgroup), jgroup,
                                     jnp.asarray(head), (jnp.asarray(np.array([vals],
                                                                             np.int32)),), K)
    ids = np.arange(B)
    pos = np.searchsorted(k, ids, side="right") - 1
    posc = np.clip(pos, 0, None)
    live = (pos >= 0) & (k[posc] == ids) & (ids > 0)
    return np.where(live, np.asarray(scanned[0])[0][posc], 0).tolist()


def _keys_of(runs):
    """Sorted keys from (key, length) runs."""
    return [k for k, ln in runs for _ in range(ln)]


# per case: lanes K, positions a lane m, members a lane M, buckets B, runs
MOD_CASES = {
    # one run over every lane: no tail before the last position
    "one run": (4, 8, 4, 8, [(3, 32)]),
    "a run a position": (4, 8, 4, 64, [(k + 1, 1) for k in range(32)]),
    "runs at lane starts": (4, 8, 2, 8, [(k, 8) for k in range(4)]),
    # a run from lane 0 over lanes 1 and 2 into lane 3 (lane 1 and 2 have no
    # tail), lane 3's first tail mid-lane; bucket 0 at the start
    "runs across lanes": (4, 8, 4, 16, [(0, 3), (2, 26), (5, 1), (9, 2)]),
    # s = 2: members [0-1] [2-3] [4-5] and one with none; runs end at member
    # ends and inside them
    "M does not divide m": (3, 6, 4, 16, [(1, 2), (2, 3), (4, 5), (7, 1), (8, 7)]),
    # s = 1, members 6-7 own no positions
    "M > m": (4, 6, 8, 32, [(2, 7), (3, 13), (6, 4)]),
    "m = 1": (8, 1, 1, 16, [(1, 3), (4, 1), (5, 4)]),
    # a head at lane 1's last position whose run goes on into lane 2; a run
    # starting at a lane's first position
    "a head at a lane's end": (4, 4, 2, 16, [(1, 7), (2, 5), (12, 4)]),
    # the first key above 0 and gaps between keys: identities below and
    # between them, and above the last
    "gaps and empty buckets": (2, 8, 4, 32, [(5, 6), (6, 2), (17, 7), (20, 1)]),
}


def _mod_case(name):
    K, m, M, B, runs = MOD_CASES[name]
    keys = _keys_of(runs)
    assert len(keys) == K * m and keys == sorted(keys) and keys[-1] < B
    rng = random.Random(name)
    vals = [rng.randrange(P) for _ in range(K * m)]
    return K, m, M, B, keys, vals


@pytest.mark.parametrize("name", sorted(MOD_CASES))
def test_lane_buckets_model_matches_serial_and_plain(name):
    K, m, M, B, keys, vals = _mod_case(name)
    kt = torch.tensor(keys)
    vt = (torch.tensor([vals], dtype=torch.int64),)
    got, (local, agg_flag, agg, first, carry_key) = _chunked_model(
        ModOps, _seg_prefix_mod, kt, vt, K, B, M)
    want = _serial_sums(keys, vals, B)
    assert got[0][0].tolist() == want
    # the lane outputs: each lane's heads' OR, its own sum from its first
    # position, its first head, the key of a first tail that continues a run
    for k in range(K):
        lk, lv = keys[k * m:(k + 1) * m], vals[k * m:(k + 1) * m]
        heads = [e == 0 or keys[e - 1] != keys[e] for e in range(k * m, (k + 1) * m)]
        lane_sum = 0
        for h, v in zip(heads, lv):
            lane_sum = v if h else (lane_sum + v) % P
        assert int(agg_flag[0, k]) == int(any(heads)) and int(agg[0][0, k]) == lane_sum
        assert int(first[k]) == (heads.index(True) if any(heads) else m)
        tails = [e == K * m - 1 or keys[e + 1] != keys[e] for e in range(k * m, (k + 1) * m)]
        want_key = lk[tails.index(True)] if any(tails) and not heads[0] else -1
        assert int(carry_key[k]) == want_key
    # the port's plain hook (a group without it runs the JAX order)
    group = _mod_group()
    plain = msm._window_bucket_sums(msm._default_seg_combine(group), group, kt, vt, K, B)
    assert plain[0][0].tolist() == want


@pytest.mark.parametrize("name", ["runs across lanes", "M does not divide m", "m = 1",
                                  "gaps and empty buckets"])
def test_lane_buckets_model_matches_jax(name):
    """The model's bucket sums equal the JAX engine's order: its
    ``_seg_scan_chunked`` and the tails' gather."""
    K, m, M, B, keys, vals = _mod_case(name)
    got, _ = _chunked_model(ModOps, _seg_prefix_mod, torch.tensor(keys),
                            (torch.tensor([vals], dtype=torch.int64),), K, B, M)
    assert got[0][0].tolist() == _jax_sums(keys, vals, K, B) == _serial_sums(keys, vals, B)


@pytest.mark.parametrize("broken,case", [("lane", "runs across lanes"),
                                         ("member", "runs across lanes"),
                                         ("inside", "runs at lane starts")])
def test_lane_buckets_model_with_a_broken_carry_fails(broken, case):
    """The carry taken from the wrong lane or the wrong member, or added to
    a bucket whose run began inside the lane: the comparison above catches
    it."""
    K, m, M, B, keys, vals = _mod_case(case)
    kt = torch.tensor(keys)
    vt = (torch.tensor([vals], dtype=torch.int64),)
    good, _ = _chunked_model(ModOps, _seg_prefix_mod, kt, vt, K, B, M)
    assert good[0][0].tolist() == _serial_sums(keys, vals, B)
    got, _ = _chunked_model(ModOps, _seg_prefix_mod, kt, vt, K, B, M, broken=broken)
    assert got[0][0].tolist() != _serial_sums(keys, vals, B)


@pytest.mark.parametrize("cnt", range(1, TILE + 1))
def test_tile_staging_loads_each_word_once(cnt):
    """A tile of cnt positions (up to kTile, the last tile of a member may
    be short) is loaded word by word exactly once into distinct slots
    (position jj's 36 words from slot 36 jj); consecutive loads read the
    positions of a limb row side by side; the keys around the tile carry
    the sentinels -1 before position 0 and B after position n - 1."""
    loads = _staging(cnt)
    assert sorted((k, jj) for k, jj, _ in loads) == \
        [(k, jj) for k in range(POINT) for jj in range(cnt)]
    assert sorted(slot for _, _, slot in loads) == list(range(POINT * cnt))
    for (k0, j0, _), (k1, j1, _) in zip(loads, loads[1:]):
        assert (k1, j1) == ((k0, j0 + 1) if j0 + 1 < cnt else (k0 + 1, 0))
    n, B, e0, w = 10, 16, 0, 4
    keys = list(range(n))
    kt = [-1 if e < 0 else B if e >= n else keys[e] for e in range(e0 - 1, e0 + w + 1)]
    assert kt[0] == -1 and kt[1:] == keys[:w + 1]
    e0 = n - 3
    kt = [-1 if e < 0 else B if e >= n else keys[e] for e in range(e0 - 1, e0 + 3 + 1)]
    assert kt == keys[e0 - 1:] + [B]


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
    runs: a run start P then P (a doubling) at 0 | 1, a run start P then -P
    (the identity) at 5 | 6, an identity with arbitrary X, Y at N - 3; keys
    with runs starting at 0, 5 and 2 m + m / 2 + 1, so that some lane has
    no head and its run comes from the lane before; bucket 0 first."""
    n = K * m
    rng = random.Random(seed)
    pool = _multiples(6, seed)
    pts = [_rescale(pool[rng.randrange(6)], rng) for _ in range(n)]
    pts[1] = _rescale(pts[0], rng)
    pts[6] = _rescale(ref.neg(pts[5]), rng)
    pts[n - 3] = (rng.randrange(Q), rng.randrange(Q), 0)
    starts = [0, 5, 2 * m + m // 2 + 1]
    keys = [sum(1 for s in starts if s <= e) * 2 - 2 for e in range(n)]
    return g1.encode_points(pts), keys, pts


def _g1_prefix(agg_flag, agg):
    return g1_kernels.seg_prefix_plain((agg_flag,) + tuple(agg))


@pytest.mark.parametrize("K,m,M", [(4, 4, 2), (2, 8, 8)])
def test_lane_buckets_model_g1(K, m, M):
    """Real G1 at N = 16: the model against the plain entries (the same
    points in every bucket and aggregate, the flags, first heads and carry
    keys exactly; the carry pass limb for limb) and the whole against the
    JAX order (the hook's plain version) and the host's serial sums."""
    B = 8
    enc, keys, pts = _g1_case(K, m, 10 * K + M)
    kt = torch.tensor(keys)
    xyz = (enc.x, enc.y, enc.z)
    got, (local, agg_flag, agg, first, carry_key) = _chunked_model(
        G1Ops, _g1_prefix, kt, xyz, K, B, M)
    plain = g1_kernels.lane_buckets_plain(kt, *xyz, K, B)
    same = lambda a, b: bool(g1.same_points(g1.JacobianPoints(*a), g1.JacobianPoints(*b)).all())
    assert same(local, plain[:3]) and same(agg, plain[4:7])
    assert torch.equal(agg_flag, plain[3]) and torch.equal(first, plain[7])
    assert torch.equal(carry_key, plain[8])
    summ = _g1_prefix(agg_flag, agg)[1:]
    carried = g1_kernels.lane_bucket_carry_plain(*local, *summ, carry_key)
    for a, b in zip(_carry_model(G1Ops, local, summ, carry_key), carried):
        assert torch.equal(a, b)
    hook = msm.g1_group("cpu").window_bucket_sums(kt, xyz, K, B)
    assert same(got, hook)
    out = g1.decode_points(g1.JacobianPoints(*got))
    want = [ref.INFINITY] * B
    for k, p in zip(keys, pts):
        want[k] = ref.add(want[k], p)
    want[0] = ref.INFINITY
    for b in range(B):
        assert ref.affine(out[b]) == ref.affine(want[b]), b


def test_g1_group_window_is_the_jax_order_on_cpu():
    """On a CPU tensor the G1 group's window_bucket_sums is the plain
    version: the JAX order (the lane fold and the tails' gather), limb for
    limb; the entries' plain versions composed through their dispatchers
    give the same points."""
    K, m, B = 4, 4, 8
    enc, keys, _ = _g1_case(K, m, 5)
    kt = torch.tensor(keys)
    xyz = (enc.x, enc.y, enc.z)
    group = msm.g1_group("cpu")
    assert group.window_bucket_sums is not None
    seg = msm._default_seg_combine(group)
    got = msm._window_bucket_sums(seg, group, kt, xyz, K, B)
    old = dataclasses.replace(group, window_bucket_sums=None)
    want = msm._window_bucket_sums(msm._default_seg_combine(old), old, kt, xyz, K, B)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    bx, by, bz, *agg, _, carry_key = g1_kernels.lane_buckets(kt, *xyz, K, B, None)
    summ = g1_kernels.seg_prefix(tuple(agg))
    composed = g1_kernels.lane_bucket_carry(bx, by, bz, *summ[1:], carry_key)
    assert bool(g1.same_points(g1.JacobianPoints(*composed), g1.JacobianPoints(*got)).all())


def test_msm_generic_takes_group_window_bucket_sums():
    """A group's window_bucket_sums replaces the chunked scan and the
    gather, one call a window with (keys, pts, K, B); without one the JAX
    order runs (the mock groups, msm_dist's custom ones)."""
    calls = []
    base = _mod_group()

    def window_bucket_sums(keys, pts, K, B):
        calls.append((keys.tolist(), K, B))
        return msm._window_bucket_sums(msm._default_seg_combine(base), base, keys, pts, K, B)

    group = dataclasses.replace(base, window_bucket_sums=window_bucket_sums)
    rng = random.Random(3)
    n, c = 8, 4
    scalars = [rng.randrange(params.FR_MODULUS) for _ in range(n)]
    xs = [rng.randrange(P) for _ in range(n)]
    from snarkos_tpu_torch.ops.fieldspec import FR
    limbs = torch.from_numpy(FR.encode(scalars, mont=False))
    got = msm.msm_generic(group, (torch.tensor([xs], dtype=torch.int64),), limbs, c, 4)
    assert len(calls) == -(-msm.SCALAR_BITS // c)
    assert all(K == 4 and B == 1 << c and keys == sorted(keys) for keys, K, B in calls)
    assert int(got[0][0, 0]) == sum(k * x for k, x in zip(scalars, xs)) % P


@pytest.mark.parametrize("m,plan", [(1, (1, 64)), (16, (4, 64)), (256, (8, 64)),
                                    (4096, (8, 64)), (6, (2, 64)), (1 << 14, (8, 64))])
def test_lane_plan(m, plan):
    """g1_lane_buckets' plan: the power of two at or above m / 4 members a
    lane, at most 8, and 64 members (one thread each) a block."""
    assert msm_kernels.lane_plan(m) == plan
