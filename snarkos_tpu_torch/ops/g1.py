"""Batched BLS12-377 G1 arithmetic on limb tensors (the port of
``snarkos_tpu/ops/g1.py``).

Points are Jacobian (X, Y, Z) with each coordinate an ``(L, *batch)``
Montgomery limb tensor (ops/modarith.py); the identity is Z == 0 with
X = Y = Montgomery one, as in the JAX package.

The addition laws are complete and branchless: the generic add-2007-bl /
madd-2007-bl formulas are computed unconditionally and per-lane selects
patch the special cases (an operand at infinity, P == Q doubling, P == -Q
giving Z = 0 with X, Y kept). ``add``, ``madd`` and ``double`` follow the
JAX ``add_impl``/``madd_impl``/``double_impl`` formula for formula, and
``madd_incomplete`` follows ``madd_incomplete_impl``; they are the combines
of the plain versions of kernels B2-B7 (``csrc/g1.cuh`` computes the same
formulas, so both give the same limbs). They run in int64 and group the
independent multiplies of each formula level into one plain multiply, which
changes no value.

``to_affine`` and ``scalar_mul`` are device code of the main path: their
multiplies go through kernel B1 on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from snarkos_tpu_torch.crypto import params
from snarkos_tpu_torch.ops import modarith as fa
from snarkos_tpu_torch.ops.fieldspec import FQ


@dataclass
class JacobianPoints:
    """A batch of Jacobian points; coordinates are (L, *batch) int32."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @property
    def batch_shape(self):
        return tuple(self.x.shape[1:])


def infinity(batch_shape, device=None) -> JacobianPoints:
    one = fa.broadcast_const(FQ, 1, tuple(batch_shape), device=device).contiguous()
    return JacobianPoints(x=one, y=one.clone(), z=torch.zeros_like(one))


def is_infinity(p: JacobianPoints) -> torch.Tensor:
    return fa.is_zero(FQ, p.z)


def _select(mask, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mask (batch,) -> choose a where True else b, over (L, *batch)."""
    return torch.where(mask.unsqueeze(0), a, b)


def select_points(mask, a: JacobianPoints, b: JacobianPoints) -> JacobianPoints:
    return JacobianPoints(x=_select(mask, a.x, b.x), y=_select(mask, a.y, b.y),
                          z=_select(mask, a.z, b.z))


def same_points(a: JacobianPoints, b: JacobianPoints) -> torch.Tensor:
    """Projective equality, lane by lane: X1 Z2^2 == X2 Z1^2 and
    Y1 Z2^3 == Y2 Z1^3, and Z == 0 on both sides or on neither (identities
    are equal whatever their X and Y). Returns a bool tensor of batch shape.
    Plain PyTorch on any device; kernels whose addition order differs from
    their plain version's (B4) are held to it with this."""
    z1z1, z2z2 = _muls((a.z, a.z), (b.z, b.z))
    x1, x2, z1c, z2c = _muls((a.x, z2z2), (b.x, z1z1), (a.z, z1z1), (b.z, z2z2))
    y1, y2 = _muls((a.y, z2c), (b.y, z1c))
    inf1, inf2 = fa.is_zero(FQ, a.z), fa.is_zero(FQ, b.z)
    finite_eq = fa.eq(FQ, x1, x2) & fa.eq(FQ, y1, y2)
    return (inf1 & inf2) | (~inf1 & ~inf2 & finite_eq)


# -- plain formulas (int64 inside) -------------------------------------------

def _muls(*pairs):
    """Independent Fq products of equally shaped operands, as one plain
    multiply over their concatenation."""
    n = [a.shape[-1] for a, _ in pairs]
    a = torch.cat([a for a, _ in pairs], dim=-1)
    b = torch.cat([b for _, b in pairs], dim=-1)
    return fa.mont_mul_plain(FQ, a, b).split(n, dim=-1)


def _add(a, b):
    return fa.add(FQ, a, b)


def _sub(a, b):
    return fa.sub(FQ, a, b)


def _dbl(a):
    return fa.add(FQ, a, a)


def _long(p: JacobianPoints):
    return p.x.long(), p.y.long(), p.z.long()


def _int32(x, y, z) -> JacobianPoints:
    return JacobianPoints(x.to(torch.int32), y.to(torch.int32), z.to(torch.int32))


def _double_levels(x, y, z):
    """dbl-2009-l (a = 0) as a generator: yields each level's products and
    receives their values, then returns (x3, y3, z3)."""
    A, B, yz = yield ((x, x), (y, y), (y, z))
    xb = _add(x, B)
    C, xb2 = yield ((B, B), (xb, xb))
    D = _dbl(_sub(_sub(xb2, A), C))
    E = fa.mul_small(FQ, A, 3)
    F, = yield ((E, E),)
    x3 = _sub(F, _dbl(D))
    t, = yield ((E, _sub(D, x3)),)
    y3 = _sub(t, fa.mul_small(FQ, C, 8))
    z3 = _dbl(yz)
    return x3, y3, z3


def _run(*formulas):
    """Drive level generators side by side: each round multiplies every
    pending level of every formula in one ``_muls`` call."""
    results = [None] * len(formulas)
    sends = [None] * len(formulas)
    live = list(range(len(formulas)))
    while live:
        asks = {}
        for i in list(live):
            try:
                asks[i] = formulas[i].send(sends[i])
            except StopIteration as stop:
                results[i] = stop.value
                live.remove(i)
        if not asks:
            break
        flat = [pair for i in asks for pair in asks[i]]
        outs = _muls(*flat)
        k = 0
        for i in asks:
            sends[i] = outs[k:k + len(asks[i])]
            k += len(asks[i])
    return results


def double(p: JacobianPoints) -> JacobianPoints:
    """dbl-2009-l (a = 0). Handles the identity for free (Z in, Z out = 0)."""
    (out,) = _run(_double_levels(*_long(p)))
    return _int32(*out)


def _add_levels(x1, y1, z1, x2, y2, z2):
    """Generic add-2007-bl as a level generator (see ``_double_levels``);
    returns ((x3, y3, z3), u1, u2, s1, s2)."""
    zs = _add(z1, z2)
    z1z1, z2z2, y1z2, y2z1, zs2 = yield ((z1, z1), (z2, z2), (y1, z2), (y2, z1), (zs, zs))
    u1, u2, s1, s2 = yield ((x1, z2z2), (x2, z1z1), (y1z2, z2z2), (y2z1, z1z1))
    h = _sub(u2, u1)
    rr = _dbl(_sub(s2, s1))
    h2 = _dbl(h)
    zz = _sub(_sub(zs2, z1z1), z2z2)
    i, rr2, z3 = yield ((h2, h2), (rr, rr), (zz, h))
    j, v = yield ((h, i), (u1, i))
    x3 = _sub(_sub(rr2, j), _dbl(v))
    t, s1j = yield ((rr, _sub(v, x3)), (s1, j))
    y3 = _sub(t, _dbl(s1j))
    return (x3, y3, z3), u1, u2, s1, s2


def add(p: JacobianPoints, q: JacobianPoints) -> JacobianPoints:
    """Complete branchless Jacobian addition (add-2007-bl + selects); the
    plain version of kernel B2."""
    pl, ql = _long(p), _long(q)
    (generic, u1, u2, s1, s2), dbl = _run(_add_levels(*pl, *ql), _double_levels(*pl))
    p_inf = fa.is_zero(FQ, pl[2])
    q_inf = fa.is_zero(FQ, ql[2])
    x_eq = fa.eq(FQ, u1, u2)
    y_eq = fa.eq(FQ, s1, s2)
    both_finite = ~p_inf & ~q_inf
    is_dbl = both_finite & x_eq & y_eq
    is_neg = both_finite & x_eq & ~y_eq
    out = JacobianPoints(*generic)
    out = select_points(is_dbl, JacobianPoints(*dbl), out)
    # P == -Q: Z = 0, X and Y as computed
    out = JacobianPoints(out.x, out.y, torch.where(is_neg.unsqueeze(0), 0, out.z))
    out = select_points(q_inf, JacobianPoints(*pl), out)
    out = select_points(p_inf, JacobianPoints(*ql), out)
    return _int32(out.x, out.y, out.z)


def madd(p: JacobianPoints, qx: torch.Tensor, qy: torch.Tensor,
         one: torch.Tensor | None = None) -> JacobianPoints:
    """Complete branchless MIXED addition: Jacobian p + affine (qx, qy),
    madd-2007-bl (7M+4S) plus the doubling branch 2*(qx, qy) from the affine
    operand (dbl-2009-alnr). The affine operand must be a curve point, never
    the identity. The bucket-scan combine (kernel B4)."""
    if one is None:
        one = fa.broadcast_const(FQ, 1, tuple(qx.shape[1:]), device=qx.device)
    x, y, z = _long(p)
    qx, qy, one = qx.long(), qy.long(), one.long().expand_as(qx)
    z1z1, xx, yy = _muls((z, z), (qx, qx), (qy, qy))
    t1 = _add(qx, yy)
    u2, zz1, yyyy, t12 = _muls((qx, z1z1), (z, z1z1), (yy, yy), (t1, t1))
    h = _sub(u2, x)
    em = fa.mul_small(FQ, xx, 3)
    s2, hh, em2 = _muls((qy, zz1), (h, h), (em, em))
    rr = _dbl(_sub(s2, y))
    i = fa.mul_small(FQ, hh, 4)
    s = _dbl(_sub(_sub(t12, xx), yyyy))
    dx3 = _sub(em2, _dbl(s))
    zh = _add(z, h)
    j, v, rr2, zh2, dt = _muls((h, i), (x, i), (rr, rr), (zh, zh), (em, _sub(s, dx3)))
    x3 = _sub(_sub(rr2, j), _dbl(v))
    z3 = _sub(_sub(zh2, z1z1), hh)
    t, yj = _muls((rr, _sub(v, x3)), (y, j))
    y3 = _sub(t, _dbl(yj))
    dy3 = _sub(dt, fa.mul_small(FQ, yyyy, 8))
    dz3 = _dbl(qy)

    p_inf = fa.is_zero(FQ, z)
    x_eq = fa.eq(FQ, u2, x)
    y_eq = fa.eq(FQ, s2, y)
    is_dbl = ~p_inf & x_eq & y_eq
    is_neg = ~p_inf & x_eq & ~y_eq
    out = JacobianPoints(x3, y3, z3)
    out = select_points(is_dbl, JacobianPoints(dx3, dy3, dz3), out)
    out = JacobianPoints(out.x, out.y, torch.where(is_neg.unsqueeze(0), 0, out.z))
    out = select_points(p_inf, JacobianPoints(qx, qy, one), out)
    return _int32(out.x, out.y, out.z)


def madd_incomplete(p: JacobianPoints, qx: torch.Tensor, qy: torch.Tensor,
                    one: torch.Tensor | None = None):
    """INCOMPLETE mixed addition: the generic madd-2007-bl path only (11 Fq
    multiplies) plus the p-at-infinity select. P == +-Q (u2 == X1 with P
    finite) is not patched: the lane's value is garbage (h = 0, so Z3 = 0
    exactly) and its flag is raised. Returns (points, exc (batch,) bool).
    The combine of kernel B6."""
    if one is None:
        one = fa.broadcast_const(FQ, 1, tuple(qx.shape[1:]), device=qx.device)
    x, y, z = _long(p)
    qx, qy, one = qx.long(), qy.long(), one.long().expand_as(qx)
    z1z1, = _muls((z, z))
    u2, zz1 = _muls((qx, z1z1), (z, z1z1))
    h = _sub(u2, x)
    s2, hh = _muls((qy, zz1), (h, h))
    rr = _dbl(_sub(s2, y))
    i = fa.mul_small(FQ, hh, 4)
    zh = _add(z, h)
    j, v, rr2, zh2 = _muls((h, i), (x, i), (rr, rr), (zh, zh))
    x3 = _sub(_sub(rr2, j), _dbl(v))
    z3 = _sub(_sub(zh2, z1z1), hh)
    t, yj = _muls((rr, _sub(v, x3)), (y, j))
    y3 = _sub(t, _dbl(yj))

    p_inf = fa.is_zero(FQ, z)
    exc = ~p_inf & fa.eq(FQ, u2, x)
    out = select_points(p_inf, JacobianPoints(qx, qy, one), JacobianPoints(x3, y3, z3))
    return _int32(out.x, out.y, out.z), exc


# -- device code of the main path (B1 on the card) ---------------------------

def to_affine(p: JacobianPoints):
    """-> (x, y, is_inf). Batched inversion via Fermat (lanes at infinity
    produce zeros, flagged by is_inf)."""
    zinv = fa.inv(FQ, p.z)
    zinv2 = fa.mont_sqr(FQ, zinv)
    x = fa.mont_mul(FQ, p.x, zinv2)
    y = fa.mont_mul(FQ, p.y, fa.mont_mul(FQ, zinv, zinv2))
    return x, y, is_infinity(p)


def scalar_mul(p: JacobianPoints, scalar_limbs: torch.Tensor) -> JacobianPoints:
    """Per-lane scalar multiply: p (batch (n,)) times canonical Fr limbs
    (16, n), MSB-first double-and-add with the complete add (kernel B2 on
    the card; doubling is add(acc, acc))."""
    from snarkos_tpu_torch.ops import g1_kernels  # it imports this module

    acc = infinity(p.batch_shape, device=p.x.device)
    limbs = scalar_limbs.long()
    for bit in range(params.FR_BITS - 1, -1, -1):
        acc = g1_kernels.add(acc, acc)
        set_ = ((limbs[bit // 16] >> (bit % 16)) & 1) != 0
        acc = select_points(set_, g1_kernels.add(acc, p), acc)
    return acc


# -- host conversion ---------------------------------------------------------

def encode_points(pts, device=None) -> JacobianPoints:
    """List of reference Jacobian tuples -> batched Montgomery limb tensors."""
    def enc(vals):
        limbs = FQ.encode_fast([int(v) for v in vals], mont=True)
        return torch.from_numpy(np.ascontiguousarray(limbs)).to(device)

    return JacobianPoints(x=enc(p[0] for p in pts), y=enc(p[1] for p in pts),
                          z=enc(p[2] for p in pts))


def decode_points(p: JacobianPoints) -> list[tuple]:
    """Batched points -> list of reference Jacobian tuples (compare through
    ref.g1.affine: Jacobian coordinates are class representatives)."""
    xs = FQ.decode_fast(p.x.cpu().numpy(), mont=True)
    ys = FQ.decode_fast(p.y.cpu().numpy(), mont=True)
    zs = FQ.decode_fast(p.z.cpu().numpy(), mont=True)
    return list(zip(xs, ys, zs))
