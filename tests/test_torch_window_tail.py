"""Kernel B2's window tail (``csrc/window_tail.cu``) on the CPU.

- ``horner_chain_plain`` against W successive ``horner_plain`` steps and
  against the loop of self-adds, limb for limb, identity lanes included;
- ``bucket_fixup_plain`` (the window's raw inputs) against the engine's
  earlier index glue and its gathers, add and selects, limb for limb, in the
  serial and wide layouts, at nbatch 1 and 2;
- a thread-by-thread model of ``bucket_fixup_kernel``'s index derivation
  (its binary search, the layout position, the team's walk over the chain's
  heads, the chain-0 rule) against ``bucket_indices`` and, through the
  values it selects, against the plain version;
- the generic engine calls the chain once a MSM;
- in the slow tier, the chain against the JAX window tail (the JAX G1
  group's self-adds and add).
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from snarkos_tpu.crypto import params
from snarkos_tpu.crypto.ref import g1 as ref
from snarkos_tpu_torch.ops import g1, g1_kernels, msm
from snarkos_tpu_torch.ops.fieldspec import FR
from tests.test_torch_g1_window import (FIXUP_WINDOWS, _assert_limbs, _coords, _odd_identity,
                                        _rescale, fixup_window)

# the plain versions run many small tensor ops: intra-op threads only add
# contention when test workers share the CPU
torch.set_num_threads(1)

MOCK_MOD = 1_000_000_007
TEAM = 4  # window_tail.cu's kTeam


def _chain_inputs(W, n, seed):
    """W windows of n lanes: rescaled multiples of a random point, window 1's
    lane 0 an identity with arbitrary X, Y, window W - 1's lane 1 (the top:
    the acc of lane 1 stays the identity for a window) likewise, and lane 2
    all identities; host points by window."""
    rng = random.Random(seed)
    h = ref.scalar_mul(rng.randrange(1, params.FR_MODULUS), ref.GENERATOR)
    pts = [[_rescale(ref.scalar_mul(rng.randrange(1, 1 << 20), h), rng) for _ in range(n)]
           for _ in range(W)]
    pts[1][0] = _odd_identity(rng)
    pts[W - 1][1] = _odd_identity(rng)
    for w in range(W):
        pts[w][2] = _odd_identity(rng)
    enc = [g1.encode_points(p) for p in pts]
    return tuple(torch.stack([getattr(e, k) for e in enc]) for k in "xyz"), pts


@pytest.mark.parametrize("c", [1, 3])
def test_horner_chain_plain_is_successive_steps(c):
    W, n = 3, 4
    ts, pts = _chain_inputs(W, n, 70 + c)
    got = g1_kernels.horner_chain_plain(ts, c)
    acc = g1.infinity((n,))
    for w in range(W - 1, -1, -1):
        acc = g1_kernels.horner_plain(acc, g1.JacobianPoints(*(t[w] for t in ts)), c)
    _assert_limbs(_coords(got), _coords(acc))
    loop = dataclasses.replace(msm.g1_group("cpu"), horner_chain=None)
    want = msm._horner_chain(loop, [tuple(t[w] for t in ts) for w in range(W)], c)
    _assert_limbs(_coords(got), want)
    _assert_limbs(_coords(g1_kernels.horner_chain(ts, c)), want)  # the wrapper on the CPU
    _assert_limbs(msm.g1_group("cpu").horner_chain([tuple(t[w] for t in ts) for w in range(W)],
                                                   c), want)  # the group's stacking
    out = g1.decode_points(got)
    for e in range(n):
        s = ref.INFINITY
        for w in range(W - 1, -1, -1):
            s = ref.add(ref.scalar_mul(1 << c, s), pts[w][e])
        assert ref.affine(out[e]) == ref.affine(s), e
    assert int(got.z[:, 2].abs().sum()) == 0


def _old_fixup(scan, keys, heads_lane, summ, K, rows, nbatch, B):
    """The engine's window glue before the fixup found its own buckets
    (ops/msm.py's window loop) and the old bucket_fixup_plain, as they
    were."""
    n = keys.shape[0]
    KV = K * rows
    mv = n // KV
    B_total = nbatch * B
    bucket_ids = torch.arange(B_total)
    heads_chain = heads_lane.reshape(mv, rows, K)
    ident1 = _coords(g1.infinity((1,)))
    carry_in = tuple(torch.cat([ident1[i], summ[i][..., :-1]], dim=-1) for i in range(3))
    pos = torch.searchsorted(keys, bucket_ids, right=True) - 1
    posc = pos.clamp(min=0)
    nonempty = (pos >= 0) & (keys[posc] == bucket_ids)
    chain_of = posc // mv
    i_of = posc % mv
    flat = (i_of * rows + chain_of // K) * K + chain_of % K
    cum_heads = heads_chain.cumsum(0).reshape(-1)
    needs_carry = cum_heads[flat] == 0
    live = nonempty & ((bucket_ids % B > 0) if nbatch > 1 else (bucket_ids > 0))
    tails = g1.JacobianPoints(*(t.reshape(t.shape[0], -1)[:, flat] for t in scan))
    carry_at = g1.JacobianPoints(*(t[:, chain_of] for t in carry_in))
    sums = g1.select_points(needs_carry, g1.add(tails, carry_at), tails)
    return g1.select_points(live, sums, g1.infinity(flat.shape, device=flat.device))


LAYOUTS = {"serial": (8, 1), "wide": (4, 2)}


@pytest.mark.parametrize("layout", ["serial", "wide"])
@pytest.mark.parametrize("nbatch", [1, 2])
def test_bucket_fixup_plain_equals_the_old_glue(layout, nbatch):
    """Empty buckets, bucket 0 of each batch, tails alone, and runs that cross
    chain starts with a finite carry, an identity, P == Q and P == -Q."""
    K, rows = LAYOUTS[layout]
    nb_, B, keys = FIXUP_WINDOWS[nbatch]
    args, *_ = fixup_window(keys, K, rows, nb_, B, random.Random(80 + nbatch + 2 * rows))
    got = g1_kernels.bucket_fixup_plain(*args, K, rows, nb_, B)
    _assert_limbs(_coords(got), _coords(_old_fixup(*args, K, rows, nb_, B)))


def kernel_model(keys, heads, K, rows, nbatch, B):
    """bucket_fixup_kernel's index derivation, team by team and thread by
    thread: per bucket ("identity",), ("tail", flat) or ("add", flat, l - 1)."""
    n = len(keys)
    mv = n // (K * rows)
    out = []
    for b in range(nbatch * B):
        lo, hi = 0, n
        while lo < hi:
            mid = (lo + hi) >> 1
            if keys[mid] <= b:
                lo = mid + 1
            else:
                hi = mid
        pos = lo - 1
        posc = max(pos, 0)
        if not (pos >= 0 and keys[posc] == b and b % B > 0):
            out.append(("identity",))
            continue
        l, i_of = divmod(posc, mv)
        row, col = divmod(l, K)
        flat = (i_of * rows + row) * K + col
        ors = [0] * TEAM
        for r in range(TEAM):  # thread r walks positions r, r + TEAM, ... <= i_of
            for i in range(r, i_of + 1, TEAM):
                ors[r] |= heads[(i * rows + row) * K + col]
        anyh = (ors[0] | ors[1]) | (ors[2] | ors[3])  # the two xor shuffles
        out.append(("tail", flat) if anyh or l == 0 else ("add", flat, l - 1))
    return out


def _random_window(layout, nbatch, seed):
    """keys and heads of a window of random signed digits (c = 3, B = 5),
    by ``msm.chain_layout`` over 64 positions."""
    K, rows = LAYOUTS[layout]
    n, c = 64, 3
    B = (1 << (c - 1)) + 1
    rng = np.random.default_rng(seed)
    scalars = FR.encode([int(v) for v in rng.integers(0, 1 << 62, n)], mont=False)
    packed = msm.signed_window_digits(torch.from_numpy(scalars), c)
    src = msm.chain_src(n, K, rows, rows == 1)
    off = (torch.arange(n) // (n // nbatch)) * B if nbatch > 1 else None
    keys, _, _, heads = msm.chain_layout(torch.zeros((1, n), dtype=torch.int32),
                                         torch.zeros((1, 2 * n), dtype=torch.int32),
                                         packed[seed % packed.shape[0]], src, off)
    return keys, heads, K, rows, B


@pytest.mark.parametrize("layout", ["serial", "wide"])
@pytest.mark.parametrize("nbatch", [1, 2])
def test_kernel_index_model_equals_the_glue(layout, nbatch):
    """On the planted windows and on eight windows of random digits: the
    model's class of each bucket is the glue's (identity where not live, an
    add where the run needs a carry from a chain l > 0, else the tail at the
    same flat position; for chain 0 the glue adds the identity, which returns
    the tail), and on the planted windows the values the model selects are
    the plain version's, limb for limb."""
    K, rows = LAYOUTS[layout]
    windows = [(torch.tensor(FIXUP_WINDOWS[nbatch][2]), None, FIXUP_WINDOWS[nbatch][1])]
    windows += [(None, seed, None) for seed in range(8)]
    for keys, seed, B in windows:
        if seed is None:
            args, *_ = fixup_window(keys.tolist(), K, rows, nbatch, B, random.Random(90))
            heads = args[2]
        else:
            keys, heads, K, rows, B = _random_window(layout, nbatch, seed)
        model = kernel_model(keys.tolist(), heads.reshape(-1).tolist(), K, rows, nbatch, B)
        flat, chain_of, needs, live = g1_kernels.bucket_indices(keys, heads, K, rows, nbatch, B)
        for b, cls in enumerate(model):
            if not live[b]:
                assert cls == ("identity",), (seed, b)
            elif needs[b] and chain_of[b] > 0:
                assert cls == ("add", int(flat[b]), int(chain_of[b]) - 1), (seed, b)
            else:
                assert cls == ("tail", int(flat[b])), (seed, b)
        if seed is None:
            scan, _, _, summ = args
            inf = _coords(g1.infinity((1,)))
            cols = []
            for cls in model:
                if cls[0] == "identity":
                    cols.append(inf)
                    continue
                tail = tuple(t.reshape(24, -1)[:, cls[1]:cls[1] + 1] for t in scan)
                if cls[0] == "add":
                    carry = tuple(t[:, cls[2]:cls[2] + 1] for t in summ)
                    tail = _coords(g1.add(g1.JacobianPoints(*tail), g1.JacobianPoints(*carry)))
                cols.append(tail)
            got = tuple(torch.cat([col[i] for col in cols], dim=-1) for i in range(3))
            _assert_limbs(got, _coords(g1_kernels.bucket_fixup_plain(*args, K, rows, nbatch, B)))


def _mock_group(calls):
    def identity(n):
        return (torch.zeros((1, n), dtype=torch.int32),)

    def add(a, b):
        return (((a[0].long() + b[0]) % MOCK_MOD).to(torch.int32),)

    def select(mask, a, b):
        return (torch.where(mask.unsqueeze(0), a[0], b[0]),)

    base = msm.GroupOps(identity=identity, add=add, select=select)

    def horner_chain(ts, c):
        calls.append(len(ts))
        return msm._horner_chain(base, ts, c)

    return dataclasses.replace(base, horner_chain=horner_chain)


def test_generic_engine_calls_the_chain_once():
    """msm_generic hands every window's T_w to one chain call; the result is
    the sum (the per-window Horner step of the JAX engine, which
    tests/test_torch_msm_generic.py pins, gives the same)."""
    rng = random.Random(95)
    n, c = 16, 4
    scalars = [rng.randrange(params.FR_MODULUS) for _ in range(n)]
    xs = [rng.randrange(MOCK_MOD) for _ in range(n)]
    calls = []
    got = msm.msm_generic(_mock_group(calls), (torch.tensor([xs], dtype=torch.int32),),
                          torch.from_numpy(FR.encode(scalars, mont=False)), c, 4)
    assert calls == [-(-msm.SCALAR_BITS // c)]
    assert int(got[0][0, 0]) == sum(k * x for k, x in zip(scalars, xs)) % MOCK_MOD


@pytest.mark.slow
def test_horner_chain_plain_matches_the_jax_window_tail():
    """The chain against the JAX G1 group's window tail (c self-adds, then
    the add, from the identity and the top window down), limb for limb."""
    import jax.numpy as jnp

    from snarkos_tpu.ops import msm as jmsm

    W, n, c = 3, 4, 2
    ts, _ = _chain_inputs(W, n, 99)
    jgroup = jmsm._g1_group(use_pallas=False)
    acc = jgroup.identity(n)
    for w in range(W - 1, -1, -1):
        for _ in range(c):
            acc = jgroup.add(acc, acc)
        acc = jgroup.add(acc, tuple(jnp.asarray(t[w].numpy()) for t in ts))
    got = g1_kernels.horner_chain_plain(ts, c)
    for g, j in zip(_coords(got), acc):
        assert np.array_equal(g.numpy(), np.asarray(j))
