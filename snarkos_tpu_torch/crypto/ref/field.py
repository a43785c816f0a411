"""Reference prime-field arithmetic over Python ints (the port's own copy
of ``snarkos_tpu/crypto/ref/field.py``).

The host field of the node's modules, with the Montgomery helpers of the
16-bit limb layout that ``ops/modarith.py`` uses.
All values are canonical representatives in [0, p).
"""

from __future__ import annotations

from snarkos_tpu_torch.crypto import params


class PrimeField:
    """Arithmetic mod a prime, plus the Montgomery-domain helpers of the
    limb layout."""

    def __init__(self, modulus: int, nlimbs: int, limb_bits: int = params.LIMB_BITS):
        self.p = modulus
        self.nlimbs = nlimbs
        self.limb_bits = limb_bits
        self.mont_r = pow(2, limb_bits * nlimbs, modulus)
        self.mont_r2 = pow(2, 2 * limb_bits * nlimbs, modulus)
        self.n0inv = (-pow(modulus, -1, 1 << limb_bits)) % (1 << limb_bits)

    # -- canonical-domain ops --
    def add(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.p

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.p

    def neg(self, a: int) -> int:
        return (-a) % self.p

    def inv(self, a: int) -> int:
        if a % self.p == 0:
            raise ZeroDivisionError("inverse of zero")
        return pow(a, -1, self.p)

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.p)

    def legendre(self, a: int) -> int:
        """1 if QR, p-1 if QNR, 0 if zero."""
        return pow(a, (self.p - 1) // 2, self.p)

    def sqrt(self, a: int) -> int | None:
        """Tonelli-Shanks square root; None if not a QR."""
        a %= self.p
        if a == 0:
            return 0
        if self.legendre(a) != 1:
            return None
        p = self.p
        q, s = p - 1, 0
        while q % 2 == 0:
            q //= 2
            s += 1
        # Find a QNR z.
        z = 2
        while self.legendre(z) != p - 1:
            z += 1
        m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
        while t != 1:
            i, t2 = 0, t
            while t2 != 1:
                t2 = t2 * t2 % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, b * b % p
            t, r = t * c % p, r * b % p
        return r

    # -- Montgomery domain (the limb layout's) --
    def to_mont(self, a: int) -> int:
        return a * self.mont_r % self.p

    def from_mont(self, a: int) -> int:
        return a * pow(self.mont_r, -1, self.p) % self.p

    def mont_mul(self, a: int, b: int) -> int:
        """a * b * R^{-1} mod p (a, b already in Montgomery form)."""
        return a * b * pow(self.mont_r, -1, self.p) % self.p

    # -- limb conversion --
    def to_limbs(self, a: int) -> list[int]:
        mask = (1 << self.limb_bits) - 1
        return [(a >> (self.limb_bits * i)) & mask for i in range(self.nlimbs)]

    def from_limbs(self, limbs) -> int:
        acc = 0
        for i, limb in enumerate(limbs):
            acc += int(limb) << (self.limb_bits * i)
        return acc % self.p


FQ = PrimeField(params.FQ_MODULUS, params.FQ_NLIMBS)
FR = PrimeField(params.FR_MODULUS, params.FR_NLIMBS)
# Edwards-BLS12 scalar field (signature scalars); not limb-decomposed on the
# device, so give it Fr-sized limbs for uniformity.
FS = PrimeField(params.EDWARDS_SUBGROUP_ORDER, params.FR_NLIMBS)
