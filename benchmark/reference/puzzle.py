"""The plain reference of the Prover's puzzle: one nonce's solution worked
out from the epoch hash, the address, the nonce and the SRS's secret tau,
on Python ints (and numpy for the epoch program's random stream).

    seed    = sha256(epoch_hash || address || nonce as 8 bytes LE) mod r
    leaf_j  = Poseidon(rate 2, domain COEFF_DOMAIN)(seed, j), j < K
    p       = the epoch program (12 steps drawn from the epoch hash) on the leaves
    C       = p(tau) G                      the KZG commitment, with tau known
    z       = Poseidon(rate 2, domain CHALLENGE_DOMAIN)(C.x mod r)
    y       = p(z)
    W       = ((p(tau) - y) / (tau - z)) G  the commitment of (p - y) / (X - z)
    id      = first 8 bytes LE of sha256(sha256(C || y as 32 bytes LE))

The epoch program is drawn as the puzzle defines it: numpy's default_rng
seeded from sha256("snarkos_tpu.epoch.prog" || epoch_hash) as uint32
words gives 12 permutations of K, then 12 x K selectors in [0, 4), then 12
K constants as 16-bit limbs rejection-sampled below r and read in
Montgomery form (limbs x 2^-256). Step s maps lane k, with v its value and
u the value at perm_s[k], to v u + c, v^2 + u, v c - u or v^2 - u^2 + c by
the selector.
"""

from __future__ import annotations

import hashlib

import numpy as np

from benchmark.reference import bls12_377 as curve
from benchmark.reference import poseidon

R = curve.R
COEFF_DOMAIN = "snarkos_tpu.puzzle.coeff"
CHALLENGE_DOMAIN = "snarkos_tpu.puzzle.challenge"
EPOCH_STEPS = 12
# the dev SRS's secret: 22^0xDEADBEEF mod r, 22 generating Fr^*
DEV_TAU = pow(22, 0xDEADBEEF, R)


def seed_field(epoch_hash: bytes, address: str, nonce: int) -> int:
    h = hashlib.sha256(epoch_hash + address.encode() + nonce.to_bytes(8, "little")).digest()
    return int.from_bytes(h, "little") % R


def leaves(seed: int, k: int) -> list[int]:
    return [poseidon.sponge([seed, j], 2, COEFF_DOMAIN)[0] for j in range(k)]


def _below_r_limbs(n: int, rng: np.random.Generator) -> np.ndarray:
    """n elements as (16, n) 16-bit limbs, uniform below r: candidates with
    the top limb cut to r's top bits, kept where they are below r, drawn
    again for the rest."""
    r_limbs = [(R >> (16 * i)) & 0xFFFF for i in range(16)]
    top_bits = R.bit_length() - 16 * 15
    out = np.zeros((16, n), dtype=np.int64)
    todo = np.arange(n)
    while todo.size:
        cand = rng.integers(0, 1 << 16, size=(16, todo.size), dtype=np.int64)
        cand[-1] &= (1 << top_bits) - 1
        vals = [sum(int(cand[i, j]) << (16 * i) for i in range(16)) for j in range(todo.size)]
        ok = np.array([v < R for v in vals], dtype=bool)
        out[:, todo[ok]] = cand[:, ok]
        todo = todo[~ok]
    return out


class EpochProgram:
    def __init__(self, epoch_hash: bytes, k: int):
        seed = hashlib.sha256(b"snarkos_tpu.epoch.prog" + epoch_hash).digest()
        rng = np.random.default_rng(np.frombuffer(seed, dtype=np.uint32))
        self.perms = [rng.permutation(k) for _ in range(EPOCH_STEPS)]
        self.sels = rng.integers(0, 4, size=(EPOCH_STEPS, 1, k), dtype=np.int32)[:, 0, :]
        limbs = _below_r_limbs(EPOCH_STEPS * k, rng).reshape(16, EPOCH_STEPS, k)
        self.consts = [curve.fr_from_limbs(limbs[:, s, :], mont=True)
                       for s in range(EPOCH_STEPS)]

    def apply(self, v: list[int]) -> list[int]:
        for perm, sel, c in zip(self.perms, self.sels, self.consts):
            u = [v[int(i)] for i in perm]
            out = []
            for vi, ui, si, ci in zip(v, u, sel.tolist(), c):
                if si == 0:
                    out.append((vi * ui + ci) % R)
                elif si == 1:
                    out.append((vi * vi + ui) % R)
                elif si == 2:
                    out.append((vi * ci - ui) % R)
                else:
                    out.append((vi * vi - ui * ui + ci) % R)
            v = out
        return v


def evaluate(coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R
    return acc


def sha64(data: bytes) -> int:
    return int.from_bytes(hashlib.sha256(hashlib.sha256(data).digest()).digest()[:8], "little")


def solution(program: EpochProgram, epoch_hash: bytes, address: str, nonce: int, k: int,
             tau: int = DEV_TAU) -> dict:
    """The solution of one nonce: commitment and witness as their 97-byte
    encodings, eval_y and the solution id."""
    p = program.apply(leaves(seed_field(epoch_hash, address, nonce), k))
    p_tau = evaluate(p, tau)
    c = curve.to_bytes(curve.mul(p_tau))
    z = poseidon.sponge([int.from_bytes(c[:48], "little") % R], 2, CHALLENGE_DOMAIN)[0]
    y = evaluate(p, z)
    w = curve.to_bytes(curve.mul((p_tau - y) * pow(tau - z, -1, R)))
    return {"commitment": c, "eval_y": y, "witness": w,
            "solution_id": sha64(c + y.to_bytes(32, "little"))}
