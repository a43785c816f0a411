"""BLS12-377 as the benchmark's plain reference needs it: the two prime
fields and G1 (y^2 = x^3 + 1 over Fq) in Jacobian coordinates, on Python
ints. Written for this benchmark from the curve's published constants; it
imports nothing of the program under test.

A point is (X, Y, Z) with affine (X / Z^2, Y / Z^3); Z == 0 is the identity.
"""

from __future__ import annotations

Q = 0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001
R = 0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001
GENERATOR = (
    81937999373150964239938255573465948239988671502647976594219695644855304257327692006745978603320413799295628339695,
    241266749859715473739788878240585681733927191168601896383759122102112907357779751001206799952863815012735208165030,
    1,
)
INFINITY = (1, 1, 0)
# the limb layout the inputs are made in: 16-bit little-endian limbs, and
# Montgomery form over 2^(16 * limbs)
LIMB_BITS = 16
FR_LIMBS = 16
FR_MONT_R = pow(2, LIMB_BITS * FR_LIMBS, R)
FR_MONT_RINV = pow(FR_MONT_R, -1, R)


def on_curve(p) -> bool:
    a = affine(p)
    return a is None or (a[1] * a[1] - a[0] ** 3 - 1) % Q == 0


def affine(p):
    """(x, y), or None for the identity."""
    if p[2] % Q == 0:
        return None
    zi = pow(p[2], -1, Q)
    zi2 = zi * zi % Q
    return (p[0] * zi2 % Q, p[1] * zi2 * zi % Q)


def double(p):
    x, y, z = p
    if z == 0 or y == 0:
        return INFINITY
    a = x * x % Q
    b = y * y % Q
    c = b * b % Q
    d = 2 * ((x + b) ** 2 - a - c) % Q
    e = 3 * a % Q
    x3 = (e * e - 2 * d) % Q
    y3 = (e * (d - x3) - 8 * c) % Q
    return (x3, y3, 2 * y * z % Q)


def add(p, q):
    x1, y1, z1 = p
    x2, y2, z2 = q
    if z1 == 0:
        return q
    if z2 == 0:
        return p
    z1z1, z2z2 = z1 * z1 % Q, z2 * z2 % Q
    u1, u2 = x1 * z2z2 % Q, x2 * z1z1 % Q
    s1, s2 = y1 * z2 * z2z2 % Q, y2 * z1 * z1z1 % Q
    if u1 == u2:
        return double(p) if s1 == s2 else INFINITY
    h = (u2 - u1) % Q
    i = 4 * h * h % Q
    j = h * i % Q
    r = 2 * (s2 - s1) % Q
    v = u1 * i % Q
    x3 = (r * r - j - 2 * v) % Q
    y3 = (r * (v - x3) - 2 * s1 * j) % Q
    z3 = ((z1 + z2) ** 2 - z1z1 - z2z2) * h % Q
    return (x3, y3, z3)


def mul(k: int, p=GENERATOR):
    """k p by double-and-add, k taken mod r."""
    acc = INFINITY
    for bit in bin(k % R)[2:]:
        acc = double(acc)
        if bit == "1":
            acc = add(acc, p)
    return acc


def to_bytes(p) -> bytes:
    """The 97-byte encoding the puzzle's solutions carry: x and y, 48 bytes
    each little-endian, then 0; the identity is 96 zero bytes and 1."""
    a = affine(p)
    if a is None:
        return b"\x00" * 96 + b"\x01"
    return a[0].to_bytes(48, "little") + a[1].to_bytes(48, "little") + b"\x00"


def fr_from_limbs(limbs, mont: bool) -> list[int]:
    """(16, n) 16-bit limbs (any integer array) -> n ints mod r; with
    ``mont`` the limbs hold x 2^256 mod r and x is returned."""
    import numpy as np

    arr = np.asarray(limbs).astype("<u2")
    n = arr.shape[1]
    buf = np.ascontiguousarray(arr.T).tobytes()
    w = 2 * FR_LIMBS
    f = FR_MONT_RINV if mont else 1
    return [int.from_bytes(buf[i * w:(i + 1) * w], "little") * f % R for i in range(n)]
