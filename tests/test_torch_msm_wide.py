"""The port's wide-chain MSM engine on the CPU: the plain versions of kernels
B5 (bucket_scan), B6 (bucket_scan_fast) and B7 (bucket_total, the weighted
bucket total) and g1.madd_incomplete against the host reference, the
bucket total of a group without B7 against the JAX package's under a mock
scan, and the fast single MSM with and without an exception. The slow tier
holds the plain versions against the JAX kernels' bodies."""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snarkos_tpu.crypto import params
from snarkos_tpu.crypto.ref import g1 as ref
from snarkos_tpu.ops import msm as jmsm
from snarkos_tpu_torch.ops import g1, msm, msm_kernels
from snarkos_tpu_torch.ops import modarith as fa
from snarkos_tpu_torch.ops.fieldspec import FQ, FR

# the plain versions run many small tensor ops: intra-op threads only add
# contention when test workers share the CPU
torch.set_num_threads(1)

MOCK_MOD = 1_000_000_007
Q = params.FQ_MODULUS


def _point(rng):
    return ref.affine(ref.scalar_mul(rng.randrange(1, params.FR_MODULUS), ref.GENERATOR))


def _enc(vals):
    return torch.from_numpy(np.ascontiguousarray(FQ.encode_fast([int(v) for v in vals], mont=True)))


def _layout(grid, m, K):
    """grid[j][k] -> (24, m, K) limb tensor."""
    return torch.stack([_enc([grid[j][k] for k in range(K)]) for j in range(m)], dim=1)


def _pos(i, l, chunk, K):
    """Row and column of chain l's element i in the wide layout."""
    r, k = divmod(l, K)
    return i * chunk + r, k


# chains of the scan cases at (24, 6, 3), chunk 2: 6 chains of 3 steps
M, K_, CHUNK = 6, 3, 2
MV, KV = M // CHUNK, CHUNK * K_
DBL, NEG, DBL_AT_HEAD, DBL_IN_BUCKET0, HEAD, PLAIN = range(KV)


def _scan_case():
    """Affine points per chain and step, head flags and nonzero flags, with
    P == Q and P == -Q inside live segments, P == Q at a head and in bucket
    0, a head inside a chain, and a chain that starts mid-segment."""
    rng = random.Random(21)
    pts = [[_point(rng) for _ in range(MV)] for _ in range(KV)]
    heads = [[1, 0, 0] for _ in range(KV)]
    nonzero = [[1, 1, 1] for _ in range(KV)]
    pts[DBL][1] = pts[DBL][0]
    pts[NEG][1] = (pts[NEG][0][0], (-pts[NEG][0][1]) % Q)
    pts[DBL_AT_HEAD][1] = pts[DBL_AT_HEAD][0]
    heads[DBL_AT_HEAD][1] = 1
    pts[DBL_IN_BUCKET0][1] = pts[DBL_IN_BUCKET0][0]
    nonzero[DBL_IN_BUCKET0] = [0, 0, 0]
    heads[HEAD][2] = 1
    heads[PLAIN][0] = 0
    gx = [[0] * K_ for _ in range(M)]
    gy = [[0] * K_ for _ in range(M)]
    gf = [[0] * K_ for _ in range(M)]
    gn = [[0] * K_ for _ in range(M)]
    for l in range(KV):
        for i in range(MV):
            j, k = _pos(i, l, CHUNK, K_)
            gx[j][k], gy[j][k] = pts[l][i]
            gf[j][k], gn[j][k] = heads[l][i], nonzero[l][i]
    flags = torch.tensor([gf], dtype=torch.int32)
    nz = torch.tensor([gn], dtype=torch.int32)
    return pts, heads, _layout(gx, M, K_), _layout(gy, M, K_), flags, nz


def _value(out, j, k):
    return g1.decode_points(g1.JacobianPoints(*(t[:, j, k:k + 1] for t in out)))[0]


def test_bucket_scan_plain_matches_reference():
    pts, heads, xs, ys, flags, _ = _scan_case()
    out = msm_kernels.bucket_scan(xs, ys, flags, lanes=K_, chunk=CHUNK)
    for l in range(KV):
        acc = ref.INFINITY
        for i in range(MV):
            q = ref.from_affine(pts[l][i])
            acc = q if heads[l][i] else ref.add(acc, q)
            assert ref.affine(_value(out, *_pos(i, l, CHUNK, K_))) == ref.affine(acc), (l, i)


def test_bucket_scan_fast_plain_flags_and_values():
    """exc is set in exactly the chains with P == +-Q in a live step (not at a
    head, not in bucket 0); the other chains' values equal B5's limb for limb;
    an exceptional step leaves Z = 0 exactly."""
    _, _, xs, ys, flags, nz = _scan_case()
    want = msm_kernels.bucket_scan(xs, ys, flags, lanes=K_, chunk=CHUNK)
    *out, exc = msm_kernels.bucket_scan_fast(xs, ys, flags, nz, lanes=K_, chunk=CHUNK)
    assert exc.shape == (1, CHUNK, K_) and exc.dtype == torch.int32
    assert exc.reshape(-1).tolist() == [1 if l in (DBL, NEG) else 0 for l in range(KV)]
    for l in range(KV):
        for i in range(MV):
            j, k = _pos(i, l, CHUNK, K_)
            if l in (DBL, NEG, DBL_IN_BUCKET0) and i == 1:
                assert int(out[2][:, j, k].abs().sum()) == 0, l
            if l in (DBL, NEG, DBL_IN_BUCKET0) and i >= 1:
                continue
            for got, ref_ in zip(out, want):
                assert torch.equal(got[:, j, k], ref_[:, j, k]), (l, i)


def test_madd_incomplete_matches_reference():
    rng = random.Random(5)
    qs = [_point(rng) for _ in range(5)]
    ps = [ref.scalar_mul(3, ref.from_affine(qs[0])), ref.from_affine(qs[1]),
          ref.neg(ref.from_affine(qs[2])), ref.INFINITY, ref.from_affine(_point(rng))]
    pe = g1.encode_points(ps)
    out, exc = g1.madd_incomplete(pe, _enc([q[0] for q in qs]), _enc([q[1] for q in qs]))
    assert exc.tolist() == [False, True, True, False, False]
    got = g1.decode_points(out)
    for i in (0, 3, 4):
        assert ref.affine(got[i]) == ref.affine(ref.add(ps[i], ref.from_affine(qs[i]))), i
    assert int(out.z[:, 1:3].abs().sum()) == 0


def test_jadd_scan_plain_matches_reference():
    """Kernel B7 (the TPU's ``jadd_scan`` row, now the whole weighted bucket
    total) through its CPU route ``bucket_total``: Jacobian bucket sums with
    identities (Z = 0, arbitrary X and Y), S_b == S_{b+1} and S_b == -S_{b+1},
    at B = 6: T_w == sum_b b S_b, and every suffix of the plain version."""
    rng = random.Random(8)
    pts = [ref.from_affine(_point(rng)) for _ in range(6)]
    pts[2] = pts[3]
    pts[4] = ref.neg(pts[5])
    pts[1] = (rng.randrange(Q), rng.randrange(Q), 0)
    pts[0] = ref.INFINITY
    reps = []
    for x, y, z in pts:
        lam = rng.randrange(1, Q)  # another representative of the same point
        reps.append((x * lam * lam % Q, y * lam ** 3 % Q, z * lam % Q))
    enc = g1.encode_points(reps)
    total = msm_kernels.bucket_total(enc.x, enc.y, enc.z)
    want = ref.INFINITY
    for b, p in enumerate(pts):
        want = ref.add(want, ref.scalar_mul(b, p)) if p[2] else want
    assert ref.affine(g1.decode_points(g1.JacobianPoints(*total))[0]) == ref.affine(want)
    _, suffix = msm_kernels.bucket_total_plain(enc.x, enc.y, enc.z)
    got = g1.decode_points(g1.JacobianPoints(*suffix))
    acc = ref.INFINITY
    for b in range(5, 0, -1):
        acc = ref.add(acc, pts[b])
        assert ref.affine(got[b]) == ref.affine(acc), b
    assert got[0][2] == 0


def test_scan_wrappers_check_the_layout():
    xs = torch.zeros((24, 6, 3), dtype=torch.int32)
    fl = torch.zeros((1, 6, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="lanes"):
        msm_kernels.bucket_scan(xs, xs, fl, lanes=4, chunk=2)
    with pytest.raises(ValueError, match="chunk"):
        msm_kernels.bucket_scan_fast(xs, xs, fl, fl, lanes=3, chunk=4)
    with pytest.raises(ValueError, match="shapes"):
        msm_kernels.bucket_total(xs, xs, xs)
    with pytest.raises(ValueError, match="shapes"):
        msm_kernels.bucket_total(xs[:, 0], xs[:, 0], xs[:, 1, :2])


# -- the weighted bucket total (B7's caller) ------------------------------------------


def _mock3_group():
    def identity(n):
        return tuple(torch.zeros((1, n), dtype=torch.int32) for _ in range(3))

    def add(a, b):
        return tuple(((x.long() + y) % MOCK_MOD).to(torch.int32) for x, y in zip(a, b))

    def select(mask, a, b):
        return tuple(torch.where(mask.unsqueeze(0), x, y) for x, y in zip(a, b))

    return msm.GroupOps(identity=identity, add=add, select=select)


def _jax_mock_jadd_scan(xs, ys, zs, lanes, chunk):
    """A mock of the JAX package's B7 (its per-chain scan) in jnp (int32: a
    sum of two residues stays below 2^31)."""
    L, m, K = xs.shape
    mv = m // chunk
    outs = []
    for v in (xs, ys, zs):
        vv = v.reshape(L, mv, chunk, K)
        carry = jnp.zeros((L, chunk, K), jnp.int32)
        rows = []
        for i in range(mv):
            carry = (carry + vv[:, i]) % MOCK_MOD
            rows.append(carry)
        outs.append(jnp.stack(rows, axis=1).reshape(L, m, K))
    return tuple(outs)


def _jax_mock3_group():
    def identity(n):
        return tuple(jnp.zeros((1, n), jnp.int32) for _ in range(3))

    def add(a, b):
        return tuple((x + y) % MOCK_MOD for x, y in zip(a, b))

    def select(mask, a, b):
        return tuple(jnp.where(mask[None], x, y) for x, y in zip(a, b))

    def gather(p, idx):
        return tuple(jnp.take(t, idx, axis=-1) for t in p)

    return jmsm.GroupOps(identity=identity, add=add, select=select, gather=gather)


@pytest.mark.parametrize("B", [(1 << 11) + 1, 37])
def test_weighted_bucket_total_mock_matches_jax(B, monkeypatch):
    """The port's bucket total for a group without B7 (the suffix scan of
    the live buckets and its tree sum over the group's own add) against the
    JAX package's chunked scans under a mock jadd_scan, at the production
    threshold shape (B = 2^11 + 1) and at B = 37: both equal sum_b b S_b."""
    from snarkos_tpu.ops import msm_pallas

    rng = random.Random(B)
    comps = [[rng.randrange(MOCK_MOD) for _ in range(B)] for _ in range(3)]
    group = _mock3_group()
    sums = tuple(torch.tensor(c, dtype=torch.int32).reshape(1, B) for c in comps)
    total = msm._weighted_bucket_total(sums, group, msm._default_seg_combine(group), B)
    monkeypatch.setattr(msm_pallas, "jadd_scan", _jax_mock_jadd_scan)
    jgroup = _jax_mock3_group()
    want = jmsm._weighted_bucket_total(tuple(jnp.asarray(t.numpy()) for t in sums), jgroup,
                                       jmsm._default_seg_combine(jgroup), B)
    for i in range(3):
        expect = sum(b * v for b, v in enumerate(comps[i]) if b >= 1) % MOCK_MOD
        assert tuple(total[i].shape) == (1, 1)
        assert int(total[i][0, 0]) == expect == int(np.asarray(want[i])[0, 0]), i


def test_weighted_bucket_total_routes_to_bucket_total():
    """The G1 group hands the window's sums to B7's route in one call."""
    seen = []
    group = dataclasses.replace(msm.g1_group("cpu"),
                                bucket_total=lambda sums: seen.append(sums) or 7)
    sums = tuple(torch.zeros((24, 5), dtype=torch.int32) for _ in range(3))
    assert msm._weighted_bucket_total(sums, group, None, 5) == 7 and seen == [sums]
    assert msm.g1_group("cpu").bucket_total is not None


# -- the fast single MSM ------------------------------------------------------------


def _base(n, rng, dup=False):
    pts = [_point(rng) for _ in range(n)]
    if dup:
        pts[1] = pts[0]
    return pts, _enc([p[0] for p in pts]), _enc([p[1] for p in pts])


def _host_msm(scalars, pts):
    acc = ref.INFINITY
    for k, p in zip(scalars, pts):
        acc = ref.add(acc, ref.scalar_mul(k, ref.from_affine(p)))
    return ref.affine(acc)


def _limbs(scalars):
    return torch.from_numpy(FR.encode(scalars, mont=False))


def test_msm_fast_engine_no_exception():
    """The incomplete-add engine (B6's plain version) on 13 random bases
    padded to 16 with copies of base 0 at scalar 0: those collide in bucket
    0, where the flag stays clear, and the point is right."""
    rng = random.Random(31)
    pts, x, y = _base(13, rng)
    scalars = [rng.randrange(params.FR_MODULUS) for _ in range(13)]
    scalars[3] = 0
    out, exc = msm._msm_affine(x, y, _limbs(scalars), c=4, lanes=2, chunk=2,
                               serial=False, fast=True)
    assert int(exc) == 0
    assert ref.affine(g1.decode_points(out)[0]) == _host_msm(scalars, pts)


def test_msm_affine_reruns_on_exception(monkeypatch):
    """Two equal bases with equal scalars meet in every live bucket of their
    windows: the fast engine flags it, and msm_affine reruns the complete
    wide engine (B5) and returns the right point. SERIAL_MAX_N is lowered so
    16 points take the wide engines."""
    rng = random.Random(32)
    pts, x, y = _base(16, rng, dup=True)
    scalars = [rng.randrange(params.FR_MODULUS) for _ in range(16)]
    scalars[1] = scalars[0]
    seen = {"exc": [], "complete": 0}
    fast_scan, complete_scan = msm_kernels.bucket_scan_fast, msm_kernels.bucket_scan

    def fast(*a):
        out = fast_scan(*a)
        seen["exc"].append(int(out[3].max()))
        return out

    def complete(*a):
        seen["complete"] += 1
        return complete_scan(*a)

    monkeypatch.setattr(msm_kernels, "SERIAL_MAX_N", 8)
    monkeypatch.setattr(msm_kernels, "bucket_scan_fast", fast)
    monkeypatch.setattr(msm_kernels, "bucket_scan", complete)
    out = msm.msm_affine(x, y, _limbs(scalars), c=6, lanes=2, chunk=2)
    assert any(seen["exc"]) and seen["complete"] == len(seen["exc"]) == 43
    assert ref.affine(g1.decode_points(out)[0]) == _host_msm(scalars, pts)


# -- slow: limb for limb against the JAX kernels' bodies -------------------------------
#
# The Pallas kernels in interpret mode do not fit here: the XLA:CPU compile of
# bucket_scan's unrolled body passed 40 GB of host memory at (24, 4, 4). So
# the reference is the kernels' plain JAX reference: their bodies
# (msm_pallas._scan_kernel, _scan_kernel_fast, _jadd_scan_kernel) written out
# per grid step with the JAX package's jitted g1 functions.


def _jax_case(rng, m=4, K=4):
    """Random affine inputs at (24, m, K) with P == Q, P == -Q, heads and a
    bucket-0 position."""
    grid = [[_point(rng) for _ in range(K)] for _ in range(m)]
    grid[2][0] = grid[0][0]  # chain (0, 0): step 1 == step 0 (chunk 2)
    grid[2][1] = (grid[0][1][0], (-grid[0][1][1]) % Q)
    grid[3][2] = grid[1][2]
    xs = _layout([[p[0] for p in row] for row in grid], m, K)
    ys = _layout([[p[1] for p in row] for row in grid], m, K)
    flags = torch.zeros((1, m, K), dtype=torch.int32)
    flags[0, :2] = 1
    flags[0, 2, 3] = 1
    nz = torch.ones((1, m, K), dtype=torch.int32)
    nz[0, 3, 2] = 0
    return xs, ys, flags, nz


def _jax_scan(step, xs, ys, flags, chunk, nz=None):
    """One grid step per row block of chunk rows, as the Pallas kernels run:
    the carry starts at all-zero limbs; ``step(carry, qx, qy)`` -> (points,
    exc or None); a head resets the carry to the input point."""
    from snarkos_tpu.ops import g1 as jg1
    from snarkos_tpu.ops import modarith as jfa
    from snarkos_tpu.ops.fieldspec import FQ as JFQ

    L, m, K = xs.shape
    mv, kv = m // chunk, chunk * K
    xv, yv = (jnp.asarray(t.numpy()).reshape(L, mv, kv) for t in (xs, ys))
    fl = jnp.asarray(flags.numpy()).reshape(mv, kv) != 0
    one = jfa.broadcast_const(JFQ, 1, (kv,))
    carry = jg1.JacobianPoints(*(jnp.zeros((L, kv), jnp.int32) for _ in range(3)))
    exc_acc = jnp.zeros((kv,), jnp.int32)
    rows = []
    for i in range(mv):
        qx, qy = xv[:, i], yv[:, i]
        out, exc = step(carry, qx, qy)
        if exc is not None:
            live = ~fl[i] & (jnp.asarray(nz.numpy()).reshape(mv, kv)[i] != 0)
            exc_acc = exc_acc | jnp.where(live, exc.astype(jnp.int32), 0)
        carry = jg1.JacobianPoints(jnp.where(fl[i][None], qx, out.x),
                                   jnp.where(fl[i][None], qy, out.y),
                                   jnp.where(fl[i][None], one, out.z))
        rows.append(carry)
    outs = tuple(np.stack([np.asarray(getattr(r, c)) for r in rows], axis=1).reshape(L, m, K)
                 for c in "xyz")
    return outs, np.asarray(exc_acc).reshape(1, chunk, K)


@pytest.mark.slow
def test_scans_limb_exact_against_jax():
    import jax

    from snarkos_tpu.ops import g1 as jg1

    rng = random.Random(40)
    xs, ys, flags, nz = _jax_case(rng)
    want, _ = _jax_scan(lambda p, qx, qy: (jg1.madd(p, qx, qy), None), xs, ys, flags, 2)
    got = msm_kernels.bucket_scan(xs, ys, flags, lanes=4, chunk=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)

    madd_incomplete = jax.jit(jg1.madd_incomplete_impl)
    want, want_exc = _jax_scan(madd_incomplete, xs, ys, flags, 2, nz)
    got = msm_kernels.bucket_scan_fast(xs, ys, flags, nz, lanes=4, chunk=2)
    assert int(got[3].sum()) > 0
    np.testing.assert_array_equal(got[3].numpy(), want_exc)
    for g, w in zip(got[:3], want):
        np.testing.assert_array_equal(g.numpy(), w)

    # g1.madd_incomplete on P == Q, P == -Q and Jacobian P lanes
    p = g1.JacobianPoints(xs[:, 0, :].clone(), ys[:, 0, :].clone(),
                          fa.broadcast_const(FQ, 1, (4,)).clone())
    jac = g1.add(*(g1.JacobianPoints(*(t[:, row, :] for t in got[:3])) for row in (0, 1)))
    p.x[:, 2:], p.y[:, 2:], p.z[:, 2:] = jac.x[:, 2:], jac.y[:, 2:], jac.z[:, 2:]
    qx, qy = xs[:, 2, :], ys[:, 2, :]
    out, exc = g1.madd_incomplete(p, qx, qy)
    wp, wexc = madd_incomplete(jg1.JacobianPoints(*(jnp.asarray(t.numpy()) for t in (
        p.x, p.y, p.z))), jnp.asarray(qx.numpy()), jnp.asarray(qy.numpy()))
    assert exc.tolist() == [True, True, False, False]
    np.testing.assert_array_equal(exc.numpy(), np.asarray(wexc))
    for c in "xyz":
        np.testing.assert_array_equal(getattr(out, c).numpy(), np.asarray(getattr(wp, c)))


@pytest.mark.slow
def test_bucket_total_same_points_as_jax(monkeypatch):
    """B7's plain version against the JAX package's ``_weighted_bucket_total``
    with its G1 group at B = 37, identities and P == +-Q planted; the JAX
    chunked scan runs as its kernel's body (jitted ``add_impl`` per grid
    step), since Pallas interpret mode does not fit here. XLA:CPU compiles
    the G1 add at width 1024."""
    import jax

    from snarkos_tpu.ops import g1 as jg1
    from snarkos_tpu.ops import msm_pallas

    add_impl = jax.jit(jg1.add_impl)

    def jadd_scan_body(xs, ys, zs, lanes, chunk):
        L, m, K = xs.shape
        mv = m // chunk
        v = [t.reshape(L, mv, chunk * K) for t in (xs, ys, zs)]
        carry = jg1.JacobianPoints(*(jnp.zeros((L, chunk * K), jnp.int32) for _ in range(3)))
        rows = []
        for i in range(mv):
            carry = add_impl(carry, jg1.JacobianPoints(*(t[:, i] for t in v)))
            rows.append(carry)
        return tuple(jnp.stack([getattr(r, c) for r in rows], axis=1).reshape(L, m, K)
                     for c in "xyz")

    rng = random.Random(37)
    B = 37
    pts = [ref.from_affine(_point(rng)) for _ in range(B)]
    pts[3], pts[5], pts[0] = pts[4], ref.neg(pts[6]), ref.INFINITY
    pts[20] = (rng.randrange(Q), rng.randrange(Q), 0)
    enc = g1.encode_points(pts)
    got, _ = msm_kernels.bucket_total_plain(enc.x, enc.y, enc.z)
    monkeypatch.setattr(msm_pallas, "jadd_scan", jadd_scan_body)
    jgroup = jmsm._g1_group(use_pallas=False)
    want = jmsm._weighted_bucket_total(tuple(jnp.asarray(t.numpy()) for t in (enc.x, enc.y, enc.z)),
                                       jgroup, jmsm._default_seg_combine(jgroup), B)
    want = g1.JacobianPoints(*(torch.from_numpy(np.asarray(t)) for t in want))
    assert bool(g1.same_points(g1.JacobianPoints(*got), want).all())
