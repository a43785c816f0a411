"""Field specifications and host-side limb encode/decode (the port's own
copy of ``snarkos_tpu/ops/fieldspec.py``).

A ``FieldSpec`` bundles everything the field kernels need about a prime
field: the modulus limbs, the Montgomery constants for the 16-bit-limb
CIOS reduction, and numpy encode/decode helpers used at the host boundary
and in tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np

from snarkos_tpu_torch.crypto import params

LIMB_BITS = params.LIMB_BITS
LIMB_MASK = (1 << LIMB_BITS) - 1


@dataclass(frozen=True)
class FieldSpec:
    name: str
    p: int
    nlimbs: int

    @cached_property
    def mont_r(self) -> int:
        return pow(2, LIMB_BITS * self.nlimbs, self.p)

    @cached_property
    def mont_r2(self) -> int:
        return pow(2, 2 * LIMB_BITS * self.nlimbs, self.p)

    @cached_property
    def mont_rinv(self) -> int:
        return pow(self.mont_r, -1, self.p)

    @cached_property
    def n0inv(self) -> int:
        return (-pow(self.p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    @cached_property
    def p_limbs(self) -> list[int]:
        return int_to_limbs(self.p, self.nlimbs)

    @cached_property
    def r2_limbs(self) -> list[int]:
        return int_to_limbs(self.mont_r2, self.nlimbs)

    @cached_property
    def one_mont_limbs(self) -> list[int]:
        return int_to_limbs(self.mont_r % self.p, self.nlimbs)

    # -- host-side conversions ----------------------------------------------
    def encode(self, values, mont: bool = True) -> np.ndarray:
        """Python ints -> (nlimbs, B) int32 limb array (Montgomery form by
        default, matching what the kernels operate on)."""
        out = np.zeros((self.nlimbs, len(values)), dtype=np.int32)
        r = self.mont_r
        for col, v in enumerate(values):
            v = v % self.p
            if mont:
                v = v * r % self.p
            for i in range(self.nlimbs):
                out[i, col] = (v >> (LIMB_BITS * i)) & LIMB_MASK
        return out

    def decode(self, arr, mont: bool = True) -> list[int]:
        """(nlimbs, B) limb array -> canonical Python ints."""
        arr = np.asarray(arr)
        assert arr.shape[0] == self.nlimbs, arr.shape
        flat = arr.reshape(self.nlimbs, -1)
        out = []
        rinv = self.mont_rinv
        for col in range(flat.shape[1]):
            v = 0
            for i in range(self.nlimbs):
                v |= (int(flat[i, col]) & LIMB_MASK) << (LIMB_BITS * i)
            v %= self.p
            if mont:
                v = v * rinv % self.p
            out.append(v)
        return out

    def random(self, batch: int, rng: np.random.Generator) -> np.ndarray:
        """Uniform field elements as (nlimbs, batch) int32 limbs.

        Sampled directly in the limb domain by rejection against p (a
        uniform Montgomery-form element is just a uniform element), so no
        Python bigint loop — usable for 2^22+ bench inputs.
        """
        top_bits = self.p.bit_length() - LIMB_BITS * (self.nlimbs - 1)
        out = np.zeros((self.nlimbs, batch), dtype=np.int64)
        need = np.ones(batch, dtype=bool)
        p_limbs = np.array(self.p_limbs, dtype=np.int64)[:, None]
        while need.any():
            n = int(need.sum())
            cand = rng.integers(0, 1 << LIMB_BITS, size=(self.nlimbs, n), dtype=np.int64)
            cand[-1] &= (1 << max(top_bits, 1)) - 1
            # lexicographic comparison cand < p from the top limb down
            lt = np.zeros(n, dtype=bool)
            decided = np.zeros(n, dtype=bool)
            for i in range(self.nlimbs - 1, -1, -1):
                lt |= (~decided) & (cand[i] < p_limbs[i, 0])
                decided |= cand[i] != p_limbs[i, 0]
            need_idx = np.flatnonzero(need)
            acc = np.flatnonzero(lt)
            out[:, need_idx[acc]] = cand[:, acc]
            need[need_idx[acc]] = False
        return out.astype(np.int32)


    # -- fast bulk paths (bytes-level, no per-limb Python loops) ------------
    def encode_fast(self, values, mont: bool = False) -> np.ndarray:
        """Python ints -> (nlimbs, B) int32 via to_bytes/frombuffer.
        ~20x faster than encode() for large batches."""
        p, r = self.p, self.mont_r
        nbytes = self.nlimbs * 2
        if mont:
            buf = b"".join((v % p * r % p).to_bytes(nbytes, "little") for v in values)
        else:
            buf = b"".join((v % p).to_bytes(nbytes, "little") for v in values)
        arr = np.frombuffer(buf, dtype="<u2").reshape(len(values), self.nlimbs)
        return arr.T.astype(np.int32)

    def decode_fast(self, arr, mont: bool = False) -> list[int]:
        """(nlimbs, B) int32 -> canonical ints via tobytes/from_bytes."""
        arr = np.asarray(arr).reshape(self.nlimbs, -1)
        nbytes = self.nlimbs * 2
        buf = arr.T.astype("<u2").tobytes()
        rinv, p = self.mont_rinv, self.p
        out = []
        for i in range(arr.shape[1]):
            v = int.from_bytes(buf[i * nbytes : (i + 1) * nbytes], "little") % p
            if mont:
                v = v * rinv % p
            out.append(v)
        return out


FQ = FieldSpec("fq", params.FQ_MODULUS, params.FQ_NLIMBS)
FR = FieldSpec("fr", params.FR_MODULUS, params.FR_NLIMBS)


def int_to_limbs(v: int, nlimbs: int) -> list[int]:
    return [(v >> (LIMB_BITS * i)) & LIMB_MASK for i in range(nlimbs)]


def limbs_to_int(limbs) -> int:
    v = 0
    for i, limb in enumerate(limbs):
        v |= (int(limb) & LIMB_MASK) << (LIMB_BITS * i)
    return v
