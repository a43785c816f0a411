"""Host BLS12-377 G1 arithmetic in Jacobian coordinates (the port's own copy
of the parts of ``snarkos_tpu/crypto/ref/g1.py`` it needs).

Points are (X, Y, Z) tuples of Python ints with affine (X/Z^2, Y/Z^3); the
identity is Z == 0 with (X, Y) = (1, 1). Used to encode results as bytes and
as an independent check of the device MSMs (``chip_smoke.py``); ``msm`` is
the plain host MSM behind ``kzg.commit``.
"""

from __future__ import annotations

from snarkos_tpu_torch.crypto import params

Q = params.FQ_MODULUS

INFINITY = (1, 1, 0)


def is_infinity(p) -> bool:
    return p[2] == 0


def affine(p):
    """Jacobian -> affine (x, y); None for infinity."""
    if p[2] == 0:
        return None
    zinv = pow(p[2], -1, Q)
    zinv2 = zinv * zinv % Q
    return (p[0] * zinv2 % Q, p[1] * zinv2 * zinv % Q)


def from_affine(xy):
    if xy is None:
        return INFINITY
    return (xy[0], xy[1], 1)


def on_curve(p) -> bool:
    if p[2] == 0:
        return True
    x, y = affine(p)
    return (y * y - (x * x * x + params.G1_COEFF_B)) % Q == 0


def double(p):
    """dbl-2009-l (a = 0)."""
    X1, Y1, Z1 = p
    if Z1 == 0:
        return INFINITY
    A = X1 * X1 % Q
    B = Y1 * Y1 % Q
    C = B * B % Q
    D = 2 * ((X1 + B) * (X1 + B) - A - C) % Q
    E = 3 * A % Q
    F = E * E % Q
    X3 = (F - 2 * D) % Q
    Y3 = (E * (D - X3) - 8 * C) % Q
    Z3 = 2 * Y1 * Z1 % Q
    return (X3, Y3, Z3)


def add(p, q):
    """add-2007-bl with explicit identity/doubling handling."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    if Z1 == 0:
        return q
    if Z2 == 0:
        return p
    Z1Z1 = Z1 * Z1 % Q
    Z2Z2 = Z2 * Z2 % Q
    U1 = X1 * Z2Z2 % Q
    U2 = X2 * Z1Z1 % Q
    S1 = Y1 * Z2 * Z2Z2 % Q
    S2 = Y2 * Z1 * Z1Z1 % Q
    if U1 == U2:
        if S1 != S2:
            return INFINITY
        return double(p)
    H = (U2 - U1) % Q
    I = 4 * H * H % Q
    J = H * I % Q
    r = 2 * (S2 - S1) % Q
    V = U1 * I % Q
    X3 = (r * r - J - 2 * V) % Q
    Y3 = (r * (V - X3) - 2 * S1 * J) % Q
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) % Q * H % Q
    return (X3, Y3, Z3)


def neg(p):
    return (p[0], (-p[1]) % Q, p[2])


def scalar_mul(k: int, p):
    k %= params.FR_MODULUS
    acc = INFINITY
    for bit in bin(k)[2:] if k else "":
        acc = double(acc)
        if bit == "1":
            acc = add(acc, p)
    return acc


def msm(scalars, points):
    """Multi-scalar multiplication sum_i scalars[i] * points[i] on the host:
    windowed Pippenger (c-bit buckets, suffix-sum bucket reduction), the same
    group element as the naive sum."""
    n = len(scalars)
    if n == 0:
        return INFINITY
    c = max(2, min(13, n.bit_length() + 1))
    ks = [k % params.FR_MODULUS for k in scalars]
    num_windows = -(-253 // c)
    mask = (1 << c) - 1
    acc = INFINITY
    for w in range(num_windows - 1, -1, -1):
        for _ in range(c):
            acc = double(acc)
        buckets = [INFINITY] * (1 << c)
        shift = c * w
        for k, p in zip(ks, points):
            d = (k >> shift) & mask
            if d:
                buckets[d] = add(buckets[d], p)
        running = INFINITY
        total = INFINITY
        for b in range(len(buckets) - 1, 0, -1):
            running = add(running, buckets[b])
            total = add(total, running)
        acc = add(acc, total)
    return acc


GENERATOR = (params.G1_GENERATOR_X, params.G1_GENERATOR_Y, 1)
