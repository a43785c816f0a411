"""Host BLS12-377 pairing: Fq2 / Fq12 tower, G2, ate pairing (the port's
own copy of ``snarkos_tpu/crypto/ref/pairing.py``).

Used by the KZG verifier (``ops/kzg.py``, ``crypto/ref/kzg.py``) and the SRS
artifact check. ``g2_scalar_mul``, ``multi_pairing`` and ``pairing_check``
run on the host pairing engine (``utils/native.py``, ``csrc/host/
pairing377.cpp``: a few ms a check), bit for bit their plain versions
``g2_scalar_mul_plain`` and ``multi_pairing_plain`` (~1 s a pairing), which
take the one case the engine refuses: a point off its curve. The plain
versions are written for auditability: the Miller loop works on the curve
over Fq12 directly (points untwisted from E'(Fq2)), with affine slope
arithmetic, and the final exponentiation is a plain big-int pow.

Tower:  Fq2 = Fq[u]/(u^2 + 5),  Fq12 = Fq2[w]/(w^6 - u).
Twist:  E'(Fq2): y^2 = x^3 + 1/u  (D-type, xi = u);
        untwist psi(x, y) = (x * w^2, y * w^3).
"""

from __future__ import annotations

from snarkos_tpu_torch.crypto import params
from snarkos_tpu_torch.crypto.ref import g1 as g1ref
from snarkos_tpu_torch.utils import native

Q = params.FQ_MODULUS
R = params.FR_MODULUS
# u^2 = -5
NR = Q - 5

# ---------------------------------------------------------------- Fq2 ------
F2_ZERO = (0, 0)
F2_ONE = (1, 0)


def f2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def f2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def f2_neg(a):
    return ((-a[0]) % Q, (-a[1]) % Q)


def f2_mul(a, b):
    return ((a[0] * b[0] + NR * a[1] % Q * b[1]) % Q, (a[0] * b[1] + a[1] * b[0]) % Q)


def f2_sq(a):
    return f2_mul(a, a)


def f2_scalar(a, k):
    return (a[0] * k % Q, a[1] * k % Q)


def f2_inv(a):
    # (a0 + a1 u)^-1 = (a0 - a1 u) / (a0^2 - NR a1^2)
    norm = (a[0] * a[0] - NR * a[1] % Q * a[1]) % Q
    ninv = pow(norm, -1, Q)
    return (a[0] * ninv % Q, (-a[1]) % Q * ninv % Q)


def f2_mul_by_u(a):
    # u * (a0 + a1 u) = NR*a1 + a0 u
    return (NR * a[1] % Q, a[0])


# --------------------------------------------------------------- Fq12 ------
# Elements: tuple of 6 Fq2 coefficients (c0 + c1 w + ... + c5 w^5), w^6 = u.
F12_ZERO = (F2_ZERO,) * 6
F12_ONE = (F2_ONE,) + (F2_ZERO,) * 5


def f12_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f12_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f12_neg(a):
    return tuple(f2_neg(x) for x in a)


def f12_mul(a, b):
    # Schoolbook polynomial multiply, reduce w^6 -> u.
    acc = [F2_ZERO] * 11
    for i in range(6):
        if a[i] == F2_ZERO:
            continue
        for j in range(6):
            acc[i + j] = f2_add(acc[i + j], f2_mul(a[i], b[j]))
    out = list(acc[:6])
    for k in range(6, 11):
        out[k - 6] = f2_add(out[k - 6], f2_mul_by_u(acc[k]))
    return tuple(out)


def f12_sq(a):
    return f12_mul(a, a)


def f12_pow(a, e: int):
    result = F12_ONE
    base = a
    while e > 0:
        if e & 1:
            result = f12_mul(result, base)
        base = f12_sq(base)
        e >>= 1
    return result


def f12_inv(a):
    # Inverse via solving with the conjugate tower is fiddly; use the
    # resultant-free approach: invert through Fq2[w]/(w^6-u) using the
    # extended Euclid on polynomials over Fq2.
    # Polynomial gcd(a(w), w^6 - u) = 1 -> s(w) a(w) = 1 mod (w^6 - u).
    def poly_trim(p):
        while p and p[-1] == F2_ZERO:
            p = p[:-1]
        return p

    def poly_divmod(num, den):
        num = list(num)
        deg_d = len(den) - 1
        lead_inv = f2_inv(den[-1])
        quo = [F2_ZERO] * (max(len(num) - deg_d, 0))
        while len(poly_trim(num)) - 1 >= deg_d and poly_trim(num):
            num = poly_trim(num)
            shift = len(num) - 1 - deg_d
            coeff = f2_mul(num[-1], lead_inv)
            quo[shift] = f2_add(quo[shift], coeff)
            for i, dcoef in enumerate(den):
                num[shift + i] = f2_sub(num[shift + i], f2_mul(coeff, dcoef))
        return quo, poly_trim(num)

    modulus = [f2_neg((0, 1))] + [F2_ZERO] * 5 + [F2_ONE]  # w^6 - u
    r0, r1 = modulus, poly_trim(list(a))
    s0, s1 = [F2_ZERO], [F2_ONE]
    while len(r1) > 1:
        q_poly, rem = poly_divmod(r0, r1)
        # s_new = s0 - q * s1
        prod = [F2_ZERO] * (len(q_poly) + len(s1) - 1) if q_poly and s1 else [F2_ZERO]
        for i, qc in enumerate(q_poly):
            for j, sc in enumerate(s1):
                prod[i + j] = f2_add(prod[i + j], f2_mul(qc, sc))
        s_new = [
            f2_sub(s0[i] if i < len(s0) else F2_ZERO, prod[i] if i < len(prod) else F2_ZERO)
            for i in range(max(len(s0), len(prod)))
        ]
        r0, r1, s0, s1 = r1, rem, s1, poly_trim(s_new) or [F2_ZERO]
    if not r1:
        raise ZeroDivisionError("inverse of zero in Fq12")
    c_inv = f2_inv(r1[0])
    out = [f2_mul(c, c_inv) for c in s1]
    out += [F2_ZERO] * (6 - len(out))
    return tuple(out[:6])


def f12_from_f2(c):
    return (c,) + (F2_ZERO,) * 5


def f12_from_fq(c: int):
    return f12_from_f2((c % Q, 0))


# ----------------------------------------------------------------- G2 ------
G2_GENERATOR = (params.G2_GENERATOR_X, params.G2_GENERATOR_Y)
G2_B = params.G2_COEFF_B


def g2_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return f2_sub(f2_sq(y), f2_add(f2_mul(f2_sq(x), x), G2_B)) == F2_ZERO


def g2_add(p, q):
    """Affine twisted-curve addition (None = infinity)."""
    if p is None:
        return q
    if q is None:
        return p
    if p[0] == q[0]:
        if f2_add(p[1], q[1]) == F2_ZERO:
            return None
        # doubling: s = 3x^2 / 2y
        s = f2_mul(f2_scalar(f2_sq(p[0]), 3), f2_inv(f2_scalar(p[1], 2)))
    else:
        s = f2_mul(f2_sub(q[1], p[1]), f2_inv(f2_sub(q[0], p[0])))
    x3 = f2_sub(f2_sub(f2_sq(s), p[0]), q[0])
    y3 = f2_sub(f2_mul(s, f2_sub(p[0], x3)), p[1])
    return (x3, y3)


def g2_neg(p):
    if p is None:
        return None
    return (p[0], f2_neg(p[1]))


def g2_scalar_mul(k: int, p):
    """k p on the engine (None = infinity); a p off the twist goes to the
    plain version."""
    k %= R
    if k and p is not None:
        out = native.g2_scalar_mul(k, p)
        if out is native.G2_INF:
            return None
        if out is not None:
            return out
    return g2_scalar_mul_plain(k, p)


def g2_scalar_mul_plain(k: int, p):
    """k p by double-and-add (None = infinity)."""
    k %= R
    acc = None
    for bit in bin(k)[2:] if k else "":
        acc = g2_add(acc, acc)
        if bit == "1":
            acc = g2_add(acc, p)
    return acc


# ----------------------------------------------------- untwist & E(Fq12) ---
def untwist(p):
    """psi: E'(Fq2) -> E(Fq12), (x, y) -> (x w^2, y w^3)."""
    if p is None:
        return None
    x = (F2_ZERO, F2_ZERO, p[0], F2_ZERO, F2_ZERO, F2_ZERO)
    y = (F2_ZERO, F2_ZERO, F2_ZERO, p[1], F2_ZERO, F2_ZERO)
    return (x, y)


def e12_add(p, q):
    """Affine addition on E(Fq12): y^2 = x^3 + 1."""
    if p is None:
        return q
    if q is None:
        return p
    if p[0] == q[0]:
        if f12_add(p[1], q[1]) == F12_ZERO:
            return None
        s = f12_mul(
            f12_mul(f12_sq(p[0]), f12_from_fq(3)),
            f12_inv(f12_mul(p[1], f12_from_fq(2))),
        )
    else:
        s = f12_mul(f12_sub(q[1], p[1]), f12_inv(f12_sub(q[0], p[0])))
    x3 = f12_sub(f12_sub(f12_sq(s), p[0]), q[0])
    y3 = f12_sub(f12_mul(s, f12_sub(p[0], x3)), p[1])
    return (x3, y3)


# -------------------------------------------------------------- pairing ----
def _line(a, b, at):
    """Evaluate the line through a, b (on E(Fq12)) at the Fq12 point `at`.

    Returns l(at) in Fq12. Handles a == b (tangent) and vertical lines.
    """
    ax, ay = a
    px, py = at
    if a[0] == b[0] and f12_add(a[1], b[1]) == F12_ZERO:
        # vertical: x - ax
        return f12_sub(px, ax)
    if a == b:
        s = f12_mul(
            f12_mul(f12_sq(ax), f12_from_fq(3)),
            f12_inv(f12_mul(ay, f12_from_fq(2))),
        )
    else:
        s = f12_mul(f12_sub(b[1], ay), f12_inv(f12_sub(b[0], ax)))
    # l = (py - ay) - s (px - ax)
    return f12_sub(f12_sub(py, ay), f12_mul(s, f12_sub(px, ax)))


def miller_loop(p_g1, q_g2) -> tuple:
    """f_{x, psi(Q)}(P) for the ate pairing (loop length = BLS parameter x)."""
    if p_g1 is None or q_g2 is None or (len(p_g1) == 3 and p_g1[2] == 0):
        return F12_ONE
    # G1 point as E(Fq12) point with Fq coords.
    if len(p_g1) == 3:
        p_g1 = g1ref.affine(p_g1)
        if p_g1 is None:
            return F12_ONE
    P = (f12_from_fq(p_g1[0]), f12_from_fq(p_g1[1]))
    Qp = untwist(q_g2)

    f = F12_ONE
    T = Qp
    for bit in bin(params.BLS_X)[3:]:
        f = f12_mul(f12_sq(f), _line(T, T, P))
        T = e12_add(T, T)
        if bit == "1":
            f = f12_mul(f, _line(T, Qp, P))
            T = e12_add(T, Qp)
    return f


FINAL_EXP = (Q**12 - 1) // R


def final_exponentiation(f):
    return f12_pow(f, FINAL_EXP)


def pairing(p_g1, q_g2):
    """e(P, Q) in the r-th roots of unity subgroup of Fq12."""
    return multi_pairing([(p_g1, q_g2)])


def _normalize_pairs(pairs):
    """G1 inputs may arrive Jacobian; convert to affine-or-None once."""
    out = []
    for p, q in pairs:
        if p is not None and len(p) == 3:
            p = g1ref.affine(p)
        out.append((p, q))
    return out


def multi_pairing(pairs) -> tuple:
    """prod_i e(P_i, Q_i) on the engine; pairs with a point off its curve go
    to the plain version."""
    pairs = _normalize_pairs(pairs)
    out = native.multi_pairing(pairs)
    if out is not None:
        return out
    return multi_pairing_plain(pairs)


def multi_pairing_plain(pairs) -> tuple:
    """prod_i e(P_i, Q_i), sharing the single final exponentiation: one
    pure-Python Miller loop a pair."""
    pairs = _normalize_pairs(pairs)
    f = F12_ONE
    for p_g1, q_g2 in pairs:
        f = f12_mul(f, miller_loop(p_g1, q_g2))
    return final_exponentiation(f)


def pairing_check(pairs) -> bool:
    """prod_i e(P_i, Q_i) == 1: the verifier's admission check. The engine
    skips the exact value's cube-root correction (the final exponentiation's
    image has prime order r and gcd(3, r) = 1, so the cubed product is 1
    iff the product is); pairs with a point off its curve go to the plain
    version."""
    pairs = _normalize_pairs(pairs)
    out = native.pairing_check(pairs)
    if out is not None:
        return out
    return multi_pairing_plain(pairs) == F12_ONE
