"""Reference BHP (Bowe-Hopwood-Pedersen) collision-resistant hash.

The reference reaches BHP256 through snarkVM's console hashing: snarkOS
uses it to key the cached dev-mode genesis block on disk
(cli/src/commands/start.rs:740-742, SURVEY.md §2.10 "BHP256 hash").

Structure (faithful to the BHP construction; parameters are this
framework's own): the input bit string is split into 3-bit chunks; chunk
(b0, b1, b2) selects the multiple (1 + b0 + 2*b1) of a per-chunk Edwards
base point, negated when b2 is set — i.e. a signed window in
{±1, ±2, ±3, ±4}. The selected multiples are summed over the curve and
the x-coordinate of the sum is the digest. Bases are derived
deterministically from a domain string via try-and-increment
hash-to-curve (cofactor-cleared).
"""

from __future__ import annotations

import hashlib

from snarkos_tpu_torch.crypto import params
from snarkos_tpu_torch.crypto.ref import edwards

R = params.FR_MODULUS

# BHP256: 3 windows x 57 chunks x 3 bits = 513 input bits per "block";
# longer inputs are Merkle-Damgard chained through the x-coordinate.
WINDOW_BITS = 3
NUM_CHUNKS = 57
NUM_WINDOWS = 3
BLOCK_BITS = NUM_WINDOWS * NUM_CHUNKS * WINDOW_BITS


def _hash_to_point(tag: bytes):
    """Try-and-increment hash-to-curve with cofactor clearing."""
    ctr = 0
    while True:
        digest = hashlib.sha256(tag + ctr.to_bytes(4, "little")).digest()
        y = int.from_bytes(digest, "little") % R
        try:
            pt = edwards.decompress((y | (0 << 255)).to_bytes(32, "little"))
        except ValueError:
            ctr += 1
            continue
        # clear the cofactor (4) to land in the prime-order subgroup
        pt = edwards.add(edwards.add(pt, pt), edwards.add(pt, pt))
        if pt != edwards.IDENTITY:
            return pt
        ctr += 1


_BASES_CACHE: dict[str, list] = {}


def bases(domain: str = "snarkos_tpu.bhp256") -> list:
    """One base per chunk: NUM_WINDOWS * NUM_CHUNKS points."""
    cached = _BASES_CACHE.get(domain)
    if cached is not None:
        return cached
    out = [
        _hash_to_point(f"{domain}.base.{i}".encode())
        for i in range(NUM_WINDOWS * NUM_CHUNKS)
    ]
    _BASES_CACHE[domain] = out
    return out


def _bits_le(data: bytes) -> list[int]:
    return [(byte >> i) & 1 for byte in data for i in range(8)]


def _hash_block(bits: list[int], domain: str) -> int:
    assert len(bits) <= BLOCK_BITS
    bs = bases(domain)
    acc = edwards.IDENTITY
    for i in range(0, len(bits), WINDOW_BITS):
        chunk = bits[i : i + WINDOW_BITS] + [0] * (WINDOW_BITS - len(bits[i:]))
        b0, b1, b2 = chunk[0], chunk[1], chunk[2]
        mult = 1 + b0 + 2 * b1
        base = bs[i // WINDOW_BITS]
        pt = edwards.scalar_mul(mult, base)
        if b2:
            pt = edwards.neg(pt)
        acc = edwards.add(acc, pt)
    return acc[0]


def hash_bits(bits: list[int], domain: str = "snarkos_tpu.bhp256") -> int:
    """BHP digest of a little-endian bit string -> Fr element."""
    # length prefix defends against trivial padding collisions (and makes
    # the empty input well-defined)
    prefix = _bits_le(len(bits).to_bytes(8, "little"))
    bits = prefix + list(bits)
    state = 0
    for off in range(0, len(bits), BLOCK_BITS - 253):
        block = bits[off : off + BLOCK_BITS - 253]
        chain = [(state >> i) & 1 for i in range(253)]
        state = _hash_block(chain + block, domain)
    return state


def hash_bytes(data: bytes, domain: str = "snarkos_tpu.bhp256") -> int:
    return hash_bits(_bits_le(data), domain)


def bhp256(data: bytes) -> bytes:
    """32-byte digest (the Fr element, little-endian)."""
    return hash_bytes(data).to_bytes(32, "little")
