"""Kernel B7 of the port as redesigned for the card, on the CPU: a model of
the phases of ``csrc/jadd_scan.cu`` (the weighted bucket total of a window
in one cooperative launch) written over a group given by its add, negation
and identity, held against sum_b b S_b on integers mod a prime for many
grids (blocks, threads, buckets a thread, co-resident blocks) and on G1's
host reference with P == Q, P == -Q and identities planted; mutations of
its carries fail it. And B7's plain version, ``bucket_total_plain``, on
real G1 against the host reference."""

import random

import pytest
import torch

from snarkos_tpu.crypto import params
from snarkos_tpu.crypto.ref import g1 as ref
from snarkos_tpu_torch.ops import g1, msm_kernels

# the plain versions run many small tensor ops: intra-op threads only add
# contention when test workers share the CPU
torch.set_num_threads(1)

P = 1_000_003
Q = params.FQ_MODULUS


class ModGroup:
    identity = 0

    @staticmethod
    def add(a, b):
        return (a + b) % P

    @staticmethod
    def neg(a):
        return -a % P


class RefG1:
    identity = ref.INFINITY
    add = staticmethod(ref.add)
    neg = staticmethod(ref.neg)


def _grid(n, threads, per_thread, resident):
    """The C entry's launch: (blocks, s, slots)."""
    s = per_thread
    if -(-n // (threads * per_thread)) > resident:
        s = -(-n // (threads * resident))
    blocks = -(-n // (threads * s))
    slots = 1
    while slots < blocks and slots < threads:
        slots <<= 1
    return blocks, s, slots


def _kernel_model(S, grp, threads, per_thread, resident, mutate=None):
    """The kernel's five phases over S_0..S_{B-1}, thread by thread, with the
    kernel's association of every add. Returns (T_w, scan_out).

    ``mutate``: "offset" takes the carry into block b from blocks 0..b (one
    aggregate too many), "exclusive" starts a thread's prefixes from the
    value of thread t - 1 instead of its own inclusive value, "no_carry"
    drops the block's carry."""
    add, I = grp.add, grp.identity
    B = len(S)
    n = B - 1
    T = threads
    G, s, slots = _grid(n, T, per_thread, resident)

    def elem(r):
        return S[B - 1 - r]

    def span(g):
        lo = min(g * s, n)
        return lo, min(lo + s, n)

    def block_sum(vals, count):
        sh = []
        for tid in range(T):
            acc = I
            for j in range(tid, count, T):
                acc = vals[j] if j == tid else add(acc, vals[j])
            sh.append(acc)
        d = slots >> 1
        while d >= 1:
            sh = [add(sh[t], sh[t + d]) if t < d else sh[t] for t in range(T)]
            d >>= 1
        return sh[0]

    # 1. local sums
    local = []
    for g in range(G * T):
        lo, hi = span(g)
        acc = I
        for r in range(lo, hi):
            acc = elem(r) if r == lo else add(acc, elem(r))
        local.append(acc)
    # 2. inclusive Hillis-Steele over each block; the aggregates
    incl, agg = [], []
    for b in range(G):
        sh = local[b * T:(b + 1) * T]
        d = 1
        while d < T:
            sh = [add(sh[t - d], sh[t]) if t >= d else sh[t] for t in range(T)]
            d <<= 1
        incl += sh
        agg.append(sh[T - 1])
    # 3. the carries into the blocks
    count = (lambda b: b + 1) if mutate == "offset" else (lambda b: b)
    carry = [I if mutate == "no_carry" else block_sum(agg, count(b)) for b in range(G)]
    # 4. every prefix, last to first, and the partial totals
    scan_out = [I] * B
    part = []
    for g in range(G * T):
        lo, hi = span(g)
        pt = I
        if lo < hi:
            own = incl[g - 1] if mutate == "exclusive" and g % T else incl[g]
            p = add(carry[g // T], own)
            for r in range(hi - 1, lo - 1, -1):
                scan_out[B - 1 - r] = p
                pt = p if r == hi - 1 else add(pt, p)
                if r > lo:
                    p = add(p, grp.neg(elem(r)))
        part.append(pt)
    # 5. the partial totals over each block, then over the blocks
    tot = []
    for b in range(G):
        sh = part[b * T:(b + 1) * T]
        d = T >> 1
        while d >= 1:
            sh = [add(sh[t], sh[t + d]) if t < d else sh[t] for t in range(T)]
            d >>= 1
        tot.append(sh[0])
    return block_sum(tot, G), scan_out


def _mod_case(B, seed):
    rng = random.Random(seed)
    S = [rng.randrange(P) for _ in range(B)]
    want_scan = [0] * B
    acc = 0
    for b in range(B - 1, 0, -1):
        acc = (acc + S[b]) % P
        want_scan[b] = acc
    return S, sum(b * v for b, v in enumerate(S)) % P, want_scan


# (B, threads, per_thread, resident): n = B - 1 is 37 (prime) or 64 or 8192
# (the path's 2^13 buckets, cut to co-resident blocks of the card's size)
GRIDS = [
    (38, 4, 1, 100),   # 10 blocks, the last holds one live thread
    (38, 8, 3, 100),   # s = 3, 2 blocks, the last partial, threads with no element
    (38, 2, 1, 100),   # 19 blocks > 2 threads: a thread sums several aggregates
    (38, 4, 1, 3),     # co-resident cap: s grows to 4, 3 blocks
    (65, 4, 2, 100),   # n = 64: full blocks, 8 of them
    (65, 32, 1, 100),  # one block of 32 for 64 elements: 2 blocks
    (2, 4, 1, 100),    # one live bucket
    (8193, 256, 1, 132),  # the 2^20 MSM's window: 32 blocks of 256
]


@pytest.mark.parametrize("B, threads, per_thread, resident", GRIDS)
def test_bucket_total_model_mod_group(B, threads, per_thread, resident):
    S, want, want_scan = _mod_case(B, B + threads + per_thread)
    got, scan = _kernel_model(S, ModGroup, threads, per_thread, resident)
    assert got == want
    assert scan == want_scan


@pytest.mark.parametrize("mutate", ["offset", "exclusive", "no_carry"])
def test_bucket_total_model_fails_when_mutated(mutate):
    """Each mutation of the carries gives a wrong total on some grid."""
    wrong = 0
    for B, threads, per_thread, resident in GRIDS[:6]:
        S, want, want_scan = _mod_case(B, B + threads + per_thread)
        got, scan = _kernel_model(S, ModGroup, threads, per_thread, resident, mutate)
        wrong += got != want
    assert wrong > 0


def _ref_sums(B, seed, plant):
    """B random G1 bucket sums (rescaled Jacobian, identities with arbitrary
    X, Y) with ``plant``: {b: ("copy" | "neg" | "inf", source bucket)}."""
    rng = random.Random(seed)
    h = ref.scalar_mul(rng.randrange(1, params.FR_MODULUS), ref.GENERATOR)
    S = [ref.scalar_mul(rng.randrange(1, 1 << 20), h) for _ in range(B)]
    for b, (kind, src) in sorted(plant.items()):
        S[b] = {"copy": S[src], "neg": ref.neg(S[src]),
                "inf": (rng.randrange(Q), rng.randrange(Q), 0)}[kind]
    out = []
    for p in S:
        lam = rng.randrange(1, Q)
        out.append((p[0] * lam * lam % Q, p[1] * lam ** 3 % Q, p[2] * lam % Q))
    return out


def _ref_total(S):
    acc = ref.INFINITY
    for b, p in enumerate(S):
        if b:
            acc = ref.add(acc, ref.scalar_mul(b, p))
    return ref.affine(acc)


def test_bucket_total_model_g1():
    """The model on G1's host reference at 8 live buckets, blocks of 2
    threads: P == Q in a thread's local sum (s = 2, elements 0 | 1) and
    across blocks, P == -Q across a thread boundary, where the backward
    rescan meets P - P, and identities at thread and block boundaries."""
    plant = {7: ("copy", 8), 4: ("neg", 5), 6: ("inf", 0), 1: ("inf", 0), 2: ("copy", 3)}
    S = _ref_sums(9, 11, plant)
    for threads, per_thread in ((2, 1), (2, 2), (4, 3)):
        got, scan = _kernel_model(S, RefG1, threads, per_thread, 100)
        assert ref.affine(got) == _ref_total(S), (threads, per_thread)
        for b in range(1, 9):
            want = ref.INFINITY
            for i in range(b, 9):
                want = ref.add(want, S[i])
            assert ref.affine(scan[b]) == ref.affine(want), (threads, per_thread, b)


@pytest.mark.parametrize("B", [9, 17])
def test_bucket_total_plain_matches_reference(B):
    """B7's plain version on real G1: T_w == sum_b b S_b and every suffix,
    with identities, S_b == S_{b+1} and S_b == -S_{b+1} planted (and, at B =
    17, a run of identities at the top)."""
    plant = {3: ("copy", 4), 5: ("neg", 6), 0: ("inf", 0), 7: ("inf", 0)}
    if B == 17:
        plant.update({b: ("inf", 0) for b in range(13, 17)})
        plant[10] = ("neg", 11)
    S = _ref_sums(B, B, plant)
    enc = g1.encode_points(S)
    total, suffix = msm_kernels.bucket_total_plain(enc.x, enc.y, enc.z)
    assert all(t.shape == (24, 1) for t in total)
    assert ref.affine(g1.decode_points(g1.JacobianPoints(*total))[0]) == _ref_total(S)
    got = g1.decode_points(g1.JacobianPoints(*suffix))
    assert got[0][2] == 0  # position 0: the identity
    want = ref.INFINITY
    for b in range(B - 1, 0, -1):
        want = ref.add(want, S[b])
        assert ref.affine(got[b]) == ref.affine(want), b


def test_bucket_total_plain_all_identities():
    S = [(b + 2, 3 * b + 1, 0) for b in range(9)]
    enc = g1.encode_points(S)
    total = msm_kernels.bucket_total(enc.x, enc.y, enc.z)
    assert int(total[2].abs().sum()) == 0
