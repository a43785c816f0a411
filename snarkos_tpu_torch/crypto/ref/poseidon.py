"""Host Poseidon sponge over BLS12-377 Fr (the port's own copy of
``snarkos_tpu/crypto/ref/poseidon.py``).

Parameters (ARK round constants + Cauchy MDS matrix) come from the
Grain-LFSR procedure of the Poseidon reference implementation: alpha = 17,
8 full rounds, 31 partial rounds, capacity 1. The sponge is a duplex
construction: state = [capacity || rate], absorb-by-addition, permute per
full rate block.

It serves the puzzle's Fiat-Shamir challenge, the constants of the
batched device sponge (``ops/poseidon.py``), and the node's host hashing
(the Varuna transcript, accounts and signatures, records, the VM).
``hash_many`` runs rates 1-8 on the host sponge engine (``utils/native.py``,
``csrc/host/poseidon377.cpp``), bit for bit its plain version
``hash_many_plain``, which takes every other rate.
"""

from __future__ import annotations

import functools

from snarkos_tpu_torch.crypto import params
from snarkos_tpu_torch.utils import native

R = params.FR_MODULUS
ALPHA = 17
FULL_ROUNDS = 8
PARTIAL_ROUNDS = 31
CAPACITY = 1


class _GrainLFSR:
    """80-bit Grain LFSR parameter generator (Poseidon reference procedure)."""

    def __init__(self, prime_num_bits: int, state_len: int, num_full: int, num_partial: int):
        s = [False] * 80
        # b0..b1: field tag (01 = prime field)
        s[1] = True
        # b2..b5: sbox tag (0000 = x^alpha)
        # b6..b17: prime_num_bits, big-endian
        cur = prime_num_bits
        for i in range(17, 5, -1):
            s[i] = (cur & 1) == 1
            cur >>= 1
        # b18..b29: state length t
        cur = state_len
        for i in range(29, 17, -1):
            s[i] = (cur & 1) == 1
            cur >>= 1
        # b30..b39: number of full rounds
        cur = num_full
        for i in range(39, 29, -1):
            s[i] = (cur & 1) == 1
            cur >>= 1
        # b40..b49: number of partial rounds
        cur = num_partial
        for i in range(49, 39, -1):
            s[i] = (cur & 1) == 1
            cur >>= 1
        # b50..b79: ones
        for i in range(50, 80):
            s[i] = True
        self.state = s
        self.head = 0
        self.prime_num_bits = prime_num_bits
        for _ in range(160):
            self._update()

    def _update(self) -> bool:
        s, h = self.state, self.head
        new_bit = (
            s[(h + 62) % 80]
            ^ s[(h + 51) % 80]
            ^ s[(h + 38) % 80]
            ^ s[(h + 23) % 80]
            ^ s[(h + 13) % 80]
            ^ s[h]
        )
        s[h] = new_bit
        self.head = (h + 1) % 80
        return new_bit

    def _next_filtered_bit(self) -> bool:
        # Bits are evaluated in pairs: first bit 1 -> emit second; else skip.
        while True:
            b1 = self._update()
            b2 = self._update()
            if b1:
                return b2

    def _get_bits(self, n: int) -> int:
        val = 0
        for _ in range(n):
            val = (val << 1) | int(self._next_filtered_bit())
        return val

    def field_elements_rejection(self, num: int, modulus: int) -> list[int]:
        out = []
        while len(out) < num:
            val = self._get_bits(self.prime_num_bits)
            if val < modulus:
                out.append(val)
        return out

    def field_elements_mod_p(self, num: int, modulus: int) -> list[int]:
        return [self._get_bits(self.prime_num_bits) % modulus for _ in range(num)]


@functools.lru_cache(maxsize=None)
def poseidon_params(rate: int, modulus: int = R, prime_bits: int = params.FR_BITS):
    """(ark, mds) for state width t = rate + 1.

    ark: (FULL+PARTIAL) x t round constants (rejection-sampled);
    mds: t x t Cauchy matrix 1/(x_i + y_j).
    """
    t = rate + CAPACITY
    lfsr = _GrainLFSR(prime_bits, t, FULL_ROUNDS, PARTIAL_ROUNDS)
    ark = [
        lfsr.field_elements_rejection(t, modulus)
        for _ in range(FULL_ROUNDS + PARTIAL_ROUNDS)
    ]
    while True:
        xs = lfsr.field_elements_mod_p(t, modulus)
        ys = lfsr.field_elements_mod_p(t, modulus)
        if all((x + y) % modulus != 0 for x in xs for y in ys):
            break
    mds = [[pow((x + y) % modulus, -1, modulus) for y in ys] for x in xs]
    return ark, mds


def _sbox(x: int) -> int:
    return pow(x, ALPHA, R)


def permute(state: list[int], rate: int) -> list[int]:
    """The Poseidon permutation on a state of width rate+1.

    Round schedule: FULL/2 full rounds, PARTIAL partial rounds (s-box on
    state[0] only), FULL/2 full rounds. Each round: add-round-key, s-box,
    MDS multiply.
    """
    ark, mds = poseidon_params(rate)
    t = rate + CAPACITY
    assert len(state) == t
    s = list(state)
    half = FULL_ROUNDS // 2
    for rnd in range(FULL_ROUNDS + PARTIAL_ROUNDS):
        is_full = rnd < half or rnd >= half + PARTIAL_ROUNDS
        s = [(s[i] + ark[rnd][i]) % R for i in range(t)]
        if is_full:
            s = [_sbox(x) for x in s]
        else:
            s[0] = _sbox(s[0])
        s = [sum(mds[i][j] * s[j] for j in range(t)) % R for i in range(t)]
    return s


def _domain_to_field(domain: str) -> int:
    return int.from_bytes(domain.encode(), "little") % R


def hash_many(inputs: list[int], rate: int, num_outputs: int = 1, domain: str = "") -> list[int]:
    """Duplex sponge hash: absorb ``inputs``, squeeze ``num_outputs``; on the
    engine at rates 1-8, else the plain version."""
    if 1 <= rate <= native.POSEIDON_MAX_RATE:
        return native.poseidon_hash_many(inputs, rate, num_outputs, _domain_to_field(domain))
    return hash_many_plain(inputs, rate, num_outputs, domain)


def hash_many_plain(inputs: list[int], rate: int, num_outputs: int = 1,
                    domain: str = "") -> list[int]:
    """Duplex sponge hash: absorb ``inputs``, squeeze ``num_outputs``.

    State layout: [capacity, rate_0, ..., rate_{r-1}]. The capacity slot is
    initialized from the (optional) domain separator. Inputs are added into
    rate slots; the permutation runs after each full rate block and before
    each squeeze block.
    """
    t = rate + CAPACITY
    state = [0] * t
    state[0] = _domain_to_field(domain)
    # absorb
    pos = 0
    for x in inputs:
        if pos == rate:
            state = permute(state, rate)
            pos = 0
        state[CAPACITY + pos] = (state[CAPACITY + pos] + x) % R
        pos += 1
    # squeeze
    out = []
    while len(out) < num_outputs:
        state = permute(state, rate)
        take = min(rate, num_outputs - len(out))
        out.extend(state[CAPACITY : CAPACITY + take])
    return out


def hash1(inputs: list[int], rate: int = 2, domain: str = "") -> int:
    return hash_many(inputs, rate, 1, domain)[0]


def hash_to_scalar(inputs: list[int], scalar_modulus: int, rate: int = 2, domain: str = "") -> int:
    """Hash to the Edwards scalar field by truncating the Fr digest to the
    scalar field's bit length - 1 (the Schnorr challenges of
    ``edwards.py``)."""
    digest = hash1(inputs, rate, domain)
    nbits = scalar_modulus.bit_length() - 1
    return digest & ((1 << nbits) - 1)
