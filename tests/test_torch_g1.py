"""The port's G1 layer (plain versions of kernels B2-B4, on the CPU) against
the JAX package's host reference (crypto/ref/g1.py) and the golden vectors;
a slow test compares limb for limb with the JAX add_impl/madd_impl."""

import json
import os
import random

import numpy as np
import pytest
import torch

from snarkos_tpu.crypto import params
from snarkos_tpu.crypto.ref import g1 as ref
from snarkos_tpu_torch.ops import g1, g1_kernels, msm_kernels
from snarkos_tpu_torch.ops.fieldspec import FQ, FR

# the plain versions run many small tensor ops: intra-op threads only add
# contention when test workers share the CPU
torch.set_num_threads(1)

FIX = json.load(open(os.path.join(os.path.dirname(__file__), "fixtures", "golden.json")))
Q = params.FQ_MODULUS


def _rng():
    return random.Random(11)


def _point(rng):
    return ref.scalar_mul(rng.randrange(1, params.FR_MODULUS), ref.GENERATOR)


def _rescale(p, rng):
    """Another Jacobian representative of the same point."""
    if not p[2]:
        return p
    x, y = ref.affine(p)
    lam = rng.randrange(1, Q)
    return (x * lam * lam % Q, y * lam ** 3 % Q, lam)


def _pairs(n=8):
    """Jacobian pairs with the special cases in the first lanes: P == Q,
    P == -Q, P = 0, Q = 0, both 0, an identity with arbitrary X, Y."""
    rng = _rng()
    base = [_point(rng) for _ in range(4)]
    P = [_rescale(base[i % 4], rng) for i in range(n)]
    Q_ = [_rescale(base[(i + 1) % 4], rng) for i in range(n)]
    P[0] = _rescale(Q_[0], rng)
    P[1] = _rescale(ref.neg(Q_[1]), rng)
    P[2] = ref.INFINITY
    Q_[3] = ref.INFINITY
    P[4], Q_[4] = ref.INFINITY, ref.INFINITY
    P[5] = (rng.randrange(Q), rng.randrange(Q), 0)
    return P, Q_


def _aff(pts):
    return [ref.affine(p) for p in pts]


def test_add_matches_reference():
    P, Q_ = _pairs()
    out = g1.decode_points(g1_kernels.add(g1.encode_points(P), g1.encode_points(Q_)))
    assert _aff(out) == [ref.affine(ref.add(p, q)) for p, q in zip(P, Q_)]


def test_add_special_cases_keep_the_jax_representatives():
    """Identity operands pass the other operand through unchanged; P == -Q
    zeroes Z only (g1.add_impl's selects)."""
    P, Q_ = _pairs()
    a, b = g1.encode_points(P), g1.encode_points(Q_)
    out = g1.add(a, b)
    for c in "xyz":
        np.testing.assert_array_equal(getattr(out, c)[:, 2].numpy(), getattr(b, c)[:, 2].numpy())
        np.testing.assert_array_equal(getattr(out, c)[:, 3].numpy(), getattr(a, c)[:, 3].numpy())
    assert int(out.z[:, 1].abs().sum()) == 0 and int(out.x[:, 1].abs().sum()) != 0


def test_double_and_madd_match_reference():
    P, Q_ = _pairs()
    out = g1.decode_points(g1.double(g1.encode_points(P)))
    assert _aff(out) == [ref.affine(ref.double(p)) for p in P]
    # affine second operand (never the identity), first operand any point
    qa = [ref.from_affine(ref.affine(q)) if q[2] else ref.GENERATOR for q in Q_]
    enc = g1.encode_points(qa)
    Pm = list(P)
    Pm[1] = _rescale(ref.neg(qa[1]), _rng())  # P == -Q
    out = g1.decode_points(g1.madd(g1.encode_points(Pm), enc.x, enc.y))
    assert _aff(out) == [ref.affine(ref.add(p, q)) for p, q in zip(Pm, qa)]


def test_seg_combine_heads():
    P, Q_ = _pairs()
    a, b = g1.encode_points(P), g1.encode_points(Q_)
    fa_ = torch.tensor([[0, 1, 0, 1, 0, 0, 1, 0]], dtype=torch.int32)
    fb_ = torch.tensor([[0, 0, 1, 1, 0, 1, 0, 0]], dtype=torch.int32)
    of, *xyz = g1_kernels.seg_combine_plain((fa_, a.x, a.y, a.z), (fb_, b.x, b.y, b.z))
    assert of.tolist() == (fa_ | fb_).tolist()
    got = g1.decode_points(g1.JacobianPoints(*xyz))
    want = [q if f else ref.add(p, q) for p, q, f in zip(P, Q_, fb_[0].tolist())]
    assert _aff(got) == _aff(want)


def test_scalar_mul_and_to_affine_golden():
    """The SRS builder's pieces (double-and-add with the complete add, then
    the batched affine conversion) reproduce the golden G1 multiples."""
    rows = FIX["g1_multiples"]
    gen = g1.encode_points([ref.GENERATOR] * len(rows))
    k = torch.from_numpy(np.ascontiguousarray(FR.encode_fast([int(r["k"]) for r in rows])))
    x, y, inf = g1.to_affine(g1.scalar_mul(gen, k))
    assert not inf.any()
    assert [str(v) for v in FQ.decode_fast(x.numpy(), mont=True)] == [r["x"] for r in rows]
    assert [str(v) for v in FQ.decode_fast(y.numpy(), mont=True)] == [r["y"] for r in rows]


def test_bucket_scan_serial_plain():
    """Per-chain segmented scan: chain k walks column k, restarting at heads;
    includes P == Q and P == -Q inside a segment."""
    rng = _rng()
    m, K = 4, 3
    pts = [[ref.affine(_point(rng)) for _ in range(K)] for _ in range(m)]
    pts[1][0] = pts[0][0]  # doubling inside a segment
    pts[1][1] = (pts[0][1][0], (-pts[0][1][1]) % Q)  # P + (-P)
    heads = [[1, 0, 1], [0, 0, 0], [1, 0, 0], [0, 1, 0]]
    xs = torch.from_numpy(np.stack([FQ.encode_fast([pts[j][k][0] for k in range(K)], mont=True)
                                    for j in range(m)], axis=1))
    ys = torch.from_numpy(np.stack([FQ.encode_fast([pts[j][k][1] for k in range(K)], mont=True)
                                    for j in range(m)], axis=1))
    flags = torch.tensor([heads], dtype=torch.int32)
    sx, sy, sz = msm_kernels.bucket_scan_serial(xs, ys, flags, lanes=K)
    for k in range(K):
        acc = ref.INFINITY
        for j in range(m):
            q = ref.from_affine(pts[j][k])
            acc = q if heads[j][k] else ref.add(acc, q)
            got = g1.decode_points(g1.JacobianPoints(sx[:, j, k:k + 1], sy[:, j, k:k + 1],
                                                     sz[:, j, k:k + 1]))[0]
            assert ref.affine(got) == ref.affine(acc), (j, k)


@pytest.mark.slow
def test_add_and_madd_limb_exact_against_jax():
    """Limb for limb against the JAX package's g1.add_impl / madd_impl
    (XLA:CPU compiles each in minutes)."""
    import jax.numpy as jnp

    from snarkos_tpu.ops import g1 as jg1

    P, Q_ = _pairs()
    a, b = g1.encode_points(P), g1.encode_points(Q_)
    ja = jg1.JacobianPoints(*(jnp.asarray(t.numpy()) for t in (a.x, a.y, a.z)))
    jb = jg1.JacobianPoints(*(jnp.asarray(t.numpy()) for t in (b.x, b.y, b.z)))
    want = jg1.add(ja, jb)
    got = g1_kernels.add(a, b)
    for c in "xyz":
        np.testing.assert_array_equal(getattr(got, c).numpy(), np.asarray(getattr(want, c)))
    qa = [ref.from_affine(ref.affine(q)) if q[2] else ref.GENERATOR for q in Q_]
    enc = g1.encode_points(qa)
    want = jg1.madd(ja, jnp.asarray(enc.x.numpy()), jnp.asarray(enc.y.numpy()))
    got = g1.madd(a, enc.x, enc.y)
    for c in "xyz":
        np.testing.assert_array_equal(getattr(got, c).numpy(), np.asarray(getattr(want, c)))
