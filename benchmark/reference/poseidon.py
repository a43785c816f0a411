"""The Poseidon sponge over BLS12-377 Fr, plain Python, for the benchmark's
reference: alpha = 17, 8 full and 31 partial rounds, capacity 1, round
constants and the Cauchy MDS matrix from the Grain LFSR of the Poseidon
paper's reference procedure. The capacity slot starts at the domain string
read as a little-endian integer; inputs are added into the rate slots, a
permutation between full rate blocks and before each squeezed block.
"""

from __future__ import annotations

import functools

from benchmark.reference.bls12_377 import R

ALPHA = 17
FULL_ROUNDS = 8
PARTIAL_ROUNDS = 31
FR_BITS = 253


class _Grain:
    """The 80-bit Grain LFSR that draws the parameters."""

    def __init__(self, t: int):
        bits = [0, 1] + [0] * 4  # prime field, s-box x^alpha
        for value, width in ((FR_BITS, 12), (t, 12), (FULL_ROUNDS, 10), (PARTIAL_ROUNDS, 10)):
            bits += [(value >> (width - 1 - i)) & 1 for i in range(width)]
        bits += [1] * 30
        self.s = bits
        for _ in range(160):
            self._step()

    def _step(self) -> int:
        s = self.s
        b = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        self.s = s[1:] + [b]
        return b

    def _bit(self) -> int:
        while True:
            first, second = self._step(), self._step()
            if first:
                return second

    def _word(self) -> int:
        v = 0
        for _ in range(FR_BITS):
            v = (v << 1) | self._bit()
        return v

    def below_r(self, n: int) -> list[int]:
        out = []
        while len(out) < n:
            v = self._word()
            if v < R:
                out.append(v)
        return out

    def mod_r(self, n: int) -> list[int]:
        return [self._word() % R for _ in range(n)]


@functools.lru_cache(maxsize=None)
def params(rate: int):
    """(round constants, MDS rows) of the permutation of width rate + 1."""
    t = rate + 1
    g = _Grain(t)
    ark = [g.below_r(t) for _ in range(FULL_ROUNDS + PARTIAL_ROUNDS)]
    while True:
        xs, ys = g.mod_r(t), g.mod_r(t)
        if all((x + y) % R for x in xs for y in ys):
            break
    mds = [[pow(x + y, -1, R) for y in ys] for x in xs]
    return ark, mds


def _pow17(x: int) -> int:
    x2 = x * x % R
    x4 = x2 * x2 % R
    x8 = x4 * x4 % R
    return x8 * x8 % R * x % R


def permute(state: list[int], rate: int) -> list[int]:
    ark, mds = params(rate)
    half = FULL_ROUNDS // 2
    s = list(state)
    for rnd, consts in enumerate(ark):
        s = [v + c for v, c in zip(s, consts)]
        if rnd < half or rnd >= half + PARTIAL_ROUNDS:
            s = [_pow17(v % R) for v in s]
        else:
            s[0] = _pow17(s[0] % R)
        s = [sum(m * v for m, v in zip(row, s)) % R for row in mds]
    return s


def domain_field(domain: str) -> int:
    return int.from_bytes(domain.encode(), "little") % R


def sponge(inputs: list[int], rate: int, domain: str, outputs: int = 1) -> list[int]:
    state = [domain_field(domain)] + [0] * rate
    pos = 0
    for x in inputs:
        if pos == rate:
            state = permute(state, rate)
            pos = 0
        state[1 + pos] = (state[1 + pos] + x) % R
        pos += 1
    out = []
    while len(out) < outputs:
        state = permute(state, rate)
        out += state[1:1 + min(rate, outputs - len(out))]
    return out
