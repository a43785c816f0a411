"""Reference Edwards-BLS12 arithmetic + Schnorr accounts.

The console/account curve: twisted Edwards -x^2 + y^2 = 1 + d x^2 y^2 over
Fr(BLS12-377), prime-order subgroup of 251 bits, cofactor 4. snarkOS uses
this through snarkVM for every handshake signature, batch-proposal
signature, and the ``account`` CLI (SURVEY.md §2.10 "Schnorr sign/verify",
account/src/lib.rs:27-88).

Signature scheme (Schnorr, Poseidon challenge):
    sign(sk, msg):  k <- nonce;  R = k*G
                    c = HashToScalar(R.x, pk.x, msg...)
                    s = k - c * sk  (mod subgroup order)
    verify(pk, msg, (c, s)):  R' = s*G + c*pk;  accept iff
                    c == HashToScalar(R'.x, pk.x, msg...)
"""

from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass

from snarkos_tpu_torch.crypto import params
from snarkos_tpu_torch.crypto.ref import poseidon

R = params.FR_MODULUS  # base field of the Edwards curve
D = params.EDWARDS_D
ORDER = params.EDWARDS_SUBGROUP_ORDER

IDENTITY = (0, 1)
GENERATOR = (params.EDWARDS_GENERATOR_X, params.EDWARDS_GENERATOR_Y)


def on_curve(p) -> bool:
    x, y = p
    return (-x * x + y * y - 1 - D * x * x % R * y % R * y) % R == 0


def in_subgroup(p) -> bool:
    """Prime-order-subgroup membership (cofactor 4): ORDER * p == O.
    Host-side validation for group values entering proof statements.
    (scalar_mul reduces its scalar mod ORDER, so the ladder is inlined
    unreduced here.)"""
    if not on_curve(p):
        return False
    acc = IDENTITY
    for bit in bin(ORDER)[2:]:
        acc = add(acc, acc)
        if bit == "1":
            acc = add(acc, p)
    return acc == IDENTITY


def add(p, q):
    x1, y1 = p
    x2, y2 = q
    dxy = D * x1 % R * x2 % R * y1 % R * y2 % R
    x3 = (x1 * y2 + y1 * x2) % R * pow(1 + dxy, -1, R) % R
    y3 = (y1 * y2 + x1 * x2) % R * pow(1 - dxy, -1, R) % R
    return (x3, y3)


def neg(p):
    return ((-p[0]) % R, p[1])


def scalar_mul(k: int, p):
    k %= ORDER
    acc = IDENTITY
    for bit in bin(k)[2:] if k else "":
        acc = add(acc, acc)
        if bit == "1":
            acc = add(acc, p)
    return acc


# --------------------------------------------------------------------------
# Accounts (private key -> address) and Schnorr signatures.
# --------------------------------------------------------------------------

SIGNATURE_DOMAIN = "snarkos_tpu.signature"
ACCOUNT_DOMAIN = "snarkos_tpu.account"


def seed_to_sk(seed: bytes) -> int:
    """Derive the signing scalar from a 32-byte seed (hash-to-scalar)."""
    digest = hashlib.sha512(ACCOUNT_DOMAIN.encode() + seed).digest()
    sk = int.from_bytes(digest, "little") % ORDER
    return sk or 1


@dataclass(frozen=True)
class Account:
    seed: bytes
    sk: int
    pk: tuple  # Edwards point

    @classmethod
    def new(cls, seed: bytes | None = None) -> "Account":
        seed = seed if seed is not None else secrets.token_bytes(32)
        sk = seed_to_sk(seed)
        return cls(seed=seed, sk=sk, pk=scalar_mul(sk, GENERATOR))

    @property
    def address(self) -> str:
        """Bech32-free textual address: 'aleo1' + hex of compressed point."""
        return "aleo1" + compress(self.pk).hex()

    def sign(self, msg_fields: list[int], nonce: int | None = None):
        return sign(self.sk, self.pk, msg_fields, nonce)


def compress(p) -> bytes:
    """y with the sign bit of x in the top bit (32 bytes, little-endian)."""
    x, y = p
    enc = y | ((x & 1) << 255)
    return enc.to_bytes(32, "little")


def decompress(b: bytes):
    enc = int.from_bytes(b, "little")
    x_sign = enc >> 255
    y = enc & ((1 << 255) - 1)
    if y >= R:
        raise ValueError("non-canonical y coordinate")
    # -x^2 + y^2 = 1 + d x^2 y^2  =>  x^2 = (y^2 - 1) / (d y^2 + 1)
    num = (y * y - 1) % R
    den = (D * y % R * y + 1) % R
    from snarkos_tpu_torch.crypto.ref.field import FR

    x2 = num * pow(den, -1, R) % R
    x = FR.sqrt(x2)
    if x is None:
        raise ValueError("invalid point encoding")
    if x & 1 != x_sign:
        x = (-x) % R
    return (x, y)


def sign(sk: int, pk, msg_fields: list[int], nonce: int | None = None):
    k = (nonce if nonce is not None else secrets.randbelow(ORDER - 1) + 1) % ORDER
    big_r = scalar_mul(k, GENERATOR)
    c = poseidon.hash_to_scalar(
        [big_r[0], pk[0]] + [m % R for m in msg_fields], ORDER, rate=4,
        domain=SIGNATURE_DOMAIN,
    )
    s = (k - c * sk) % ORDER
    return (c, s)


def verify(pk, msg_fields: list[int], sig) -> bool:
    c, s = sig
    if not (0 <= c < ORDER and 0 <= s < ORDER):
        return False
    big_r = add(scalar_mul(s, GENERATOR), scalar_mul(c, pk))
    c_prime = poseidon.hash_to_scalar(
        [big_r[0], pk[0]] + [m % R for m in msg_fields], ORDER, rate=4,
        domain=SIGNATURE_DOMAIN,
    )
    return c_prime == c


def message_bytes_to_fields(msg: bytes) -> list[int]:
    """Pack bytes into 31-byte field chunks (little-endian), length-tagged."""
    fields = [len(msg) % R]
    for i in range(0, len(msg), 31):
        fields.append(int.from_bytes(msg[i : i + 31], "little"))
    return fields


def sign_bytes(sk: int, pk, msg: bytes, nonce: int | None = None):
    return sign(sk, pk, message_bytes_to_fields(msg), nonce)


def verify_bytes(pk, msg: bytes, sig) -> bool:
    return verify(pk, message_bytes_to_fields(msg), sig)
