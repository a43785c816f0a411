"""Record encryption: ECIES over Edwards-BLS12 with a Poseidon KDF.

The reference's `developer decrypt` / `transfer_private` commands
(cli/src/commands/developer/mod.rs:58-77) operate on ciphertext records
only the owner's view key can read. This module provides the equivalent
capability for this framework's transaction payloads:

    encrypt(address_pk, plaintext) -> record ciphertext
        k <- ephemeral scalar; N = k*G (the nonce point)
        S = k*pk (shared secret); key = Poseidon(S.x, N.x)
        ciphertext = N || stream(key) XOR plaintext

    decrypt(sk, record) -> plaintext
        S = sk*N  (same shared secret; owner-only)

The owner check is implicit: a wrong key yields a MAC mismatch.
"""

from __future__ import annotations

import hashlib
import secrets

from snarkos_tpu_torch.crypto import params
from snarkos_tpu_torch.crypto.ref import edwards, poseidon

R = params.FR_MODULUS
KDF_DOMAIN = "snarkos_tpu.record.kdf"
MAC_DOMAIN = "snarkos_tpu.record.mac"


def _stream(key: int, n: int) -> bytes:
    out = b""
    ctr = 0
    seed = key.to_bytes(32, "little")
    while len(out) < n:
        out += hashlib.sha256(seed + ctr.to_bytes(4, "little")).digest()
        ctr += 1
    return out[:n]


def encrypt(pk, plaintext: bytes, ephemeral: int | None = None) -> bytes:
    """pk: owner's Edwards public key (address point)."""
    k = (ephemeral if ephemeral is not None
         else secrets.randbelow(edwards.ORDER - 1) + 1) % edwards.ORDER
    nonce_pt = edwards.scalar_mul(k, edwards.GENERATOR)
    shared = edwards.scalar_mul(k, pk)
    key = poseidon.hash1([shared[0], nonce_pt[0]], rate=2, domain=KDF_DOMAIN)
    mac = poseidon.hash1(
        [key, int.from_bytes(hashlib.sha256(plaintext).digest(), "little") % R],
        rate=2, domain=MAC_DOMAIN,
    )
    body = bytes(a ^ b for a, b in zip(plaintext, _stream(key, len(plaintext))))
    return (edwards.compress(nonce_pt) + mac.to_bytes(32, "little")
            + len(body).to_bytes(4, "little") + body)


def decrypt(sk: int, record: bytes) -> bytes:
    """sk: owner's view scalar. Raises ValueError if not the owner."""
    if len(record) < 68:
        raise ValueError("malformed record")
    nonce_pt = edwards.decompress(record[:32])
    mac = int.from_bytes(record[32:64], "little")
    n = int.from_bytes(record[64:68], "little")
    body = record[68 : 68 + n]
    if len(body) != n:
        raise ValueError("truncated record")
    shared = edwards.scalar_mul(sk, nonce_pt)
    key = poseidon.hash1([shared[0], nonce_pt[0]], rate=2, domain=KDF_DOMAIN)
    plaintext = bytes(a ^ b for a, b in zip(body, _stream(key, n)))
    expect = poseidon.hash1(
        [key, int.from_bytes(hashlib.sha256(plaintext).digest(), "little") % R],
        rate=2, domain=MAC_DOMAIN,
    )
    if expect != mac:
        raise ValueError("record is not owned by this key (MAC mismatch)")
    return plaintext
