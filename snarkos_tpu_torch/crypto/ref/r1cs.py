"""R1CS constraint system + the transaction-authorization circuit.

The reference reaches R1CS through snarkVM's circuit crate on every
transaction (Varuna proves/verifies program execution —
node/bft/ledger-service/src/ledger.rs:318-343 is where the
node invokes it). This module is the new framework's own constraint
system: rows are sparse linear combinations over Fr, constraints are
``<A_i, z> * <B_i, z> = <C_i, z>``, and the shipped circuit proves
knowledge of an authorization key k with ``Poseidon2(k, m) = t`` for the
transaction binding field m and public tag t (one full rate-2 Poseidon
permutation in-circuit: x^17 s-boxes cost 5 multiplication constraints
each).

Variable indexing convention (Marlin input-domain layout): the full
assignment z lives on the NTT domain H of size n; PUBLIC inputs occupy
the subgroup I = {omega^(i*n/l)} (indices i*n/l), so that
z(X) = w_hat(X) * v_I(X) + x_hat(X) with v_I = X^l - 1. Witness variables
fill the remaining indices.
"""

from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass, field

from snarkos_tpu_torch.crypto import params
from snarkos_tpu_torch.crypto.ref import poseidon

R = params.FR_MODULUS

LinComb = dict  # var index -> coefficient (mod R)


def _lc_add(a: LinComb, b: LinComb, k: int = 1) -> LinComb:
    out = dict(a)
    for v, c in b.items():
        out[v] = (out.get(v, 0) + k * c) % R
    return {v: c for v, c in out.items() if c}


def _lc_scale(a: LinComb, k: int) -> LinComb:
    return {v: c * k % R for v, c in a.items() if c * k % R}


@dataclass
class R1CS:
    """Sparse R1CS over Fr with Marlin-style public-input placement."""

    num_public: int  # l, a power of two (includes the constant-1 slot)
    n: int  # domain size (power of two) >= max(vars, constraints)
    rows_a: list = field(default_factory=list)  # list[LinComb]
    rows_b: list = field(default_factory=list)
    rows_c: list = field(default_factory=list)
    _next_aux: int = 0

    def __post_init__(self):
        assert self.n & (self.n - 1) == 0
        assert self.num_public & (self.num_public - 1) == 0
        self._public_idx = [i * (self.n // self.num_public)
                            for i in range(self.num_public)]
        self._aux_free = [i for i in range(self.n) if i not in set(self._public_idx)]

    # -- variables -----------------------------------------------------------
    @property
    def one(self) -> int:
        """Index of the constant-1 public slot."""
        return 0

    def public(self, i: int) -> int:
        """Index of public input i (0 is the constant one)."""
        return self._public_idx[i]

    def alloc(self) -> int:
        idx = self._aux_free[self._next_aux]
        self._next_aux += 1
        return idx

    # -- constraints ----------------------------------------------------------
    def enforce(self, a: LinComb, b: LinComb, c: LinComb) -> None:
        assert len(self.rows_a) < self.n, "constraint count exceeds domain"
        self.rows_a.append(a)
        self.rows_b.append(b)
        self.rows_c.append(c)

    @property
    def num_constraints(self) -> int:
        return len(self.rows_a)

    # -- evaluation -----------------------------------------------------------
    def eval_lc(self, lc: LinComb, z: list[int]) -> int:
        return sum(c * z[v] for v, c in lc.items()) % R

    def matvec(self, rows: list, z: list[int]) -> list[int]:
        """M z over the full domain (rows beyond num_constraints are 0)."""
        out = [0] * self.n
        for i, lc in enumerate(rows):
            out[i] = self.eval_lc(lc, z)
        return out

    def digest(self) -> bytes:
        """sha256 of the system's content (sizes and every row of A, B, C,
        each in its insertion order, which orders the index's entries): the
        key of the Varuna index cache."""
        h = hashlib.sha256(f"{self.num_public} {self.n}".encode())
        for rows in (self.rows_a, self.rows_b, self.rows_c):
            h.update(b"|")
            for lc in rows:
                h.update(repr(list(lc.items())).encode())
        return h.digest()

    def is_satisfied(self, z: list[int]) -> bool:
        for a, b, c in zip(self.rows_a, self.rows_b, self.rows_c):
            if self.eval_lc(a, z) * self.eval_lc(b, z) % R != self.eval_lc(c, z):
                return False
        return True


# --------------------------------------------------------------------------
# the authorization circuit: Poseidon2(k, m) == t
# --------------------------------------------------------------------------

AUTH_DOMAIN = "snarkos_tpu.tx.auth"


def _sbox17(cs: R1CS, x: LinComb, z: list | None) -> LinComb:
    """x^17 as five R1CS squarings/products; z (if given) is extended with
    the witness values (trace mode)."""
    cur = x
    # x^2, x^4, x^8, x^16
    for _ in range(4):
        sq = cs.alloc()
        cs.enforce(cur, cur, {sq: 1})
        if z is not None:
            z[sq] = cs.eval_lc(cur, z) ** 2 % R
        cur = {sq: 1}
    out = cs.alloc()
    cs.enforce(cur, x, {out: 1})
    if z is not None:
        z[out] = cs.eval_lc(cur, z) * cs.eval_lc(x, z) % R
    return {out: 1}


def _poseidon_circuit(cs: R1CS, state: list[LinComb], z: list | None,
                      rate: int = 2) -> list[LinComb]:
    """One Poseidon permutation (state width rate+1) over symbolic affine
    state (mirrors poseidon.permute bit for bit)."""
    ark, mds = poseidon.poseidon_params(rate)
    t = rate + 1
    half = poseidon.FULL_ROUNDS // 2
    s = list(state)
    for rnd in range(poseidon.FULL_ROUNDS + poseidon.PARTIAL_ROUNDS):
        is_full = rnd < half or rnd >= half + poseidon.PARTIAL_ROUNDS
        s = [_lc_add(s[i], {cs.one: ark[rnd][i]}) for i in range(t)]
        if is_full:
            s = [_sbox17(cs, x, z) for x in s]
        else:
            s[0] = _sbox17(cs, s[0], z)
        s = [
            functools.reduce(_lc_add, (_lc_scale(s[j], mds[i][j])
                                       for j in range(t)))
            for i in range(t)
        ]
    return s


def auth_circuit(n: int = 512):
    """Builds the circuit: public x = [1, m, t, 0]; witness k with
    Poseidon2_hash1([k, m], domain=AUTH_DOMAIN) = t. Returns (cs, k_var)."""
    cs = R1CS(num_public=4, n=n)
    k = cs.alloc()
    m = {cs.public(1): 1}
    t_pub = {cs.public(2): 1}
    dom = poseidon._domain_to_field(AUTH_DOMAIN)
    state = [{cs.one: dom}, {k: 1}, dict(m)]
    out = _poseidon_circuit(cs, state, None)
    # out[1] == t  (hash1 squeezes rate slot 0 = state[CAPACITY])
    cs.enforce(_lc_add(out[1], _lc_scale(t_pub, R - 1)), {cs.one: 1}, {})
    return cs, k


def auth_statement(k: int, m: int) -> int:
    """The honest tag t for key k and binding field m."""
    return poseidon.hash1([k, m], rate=2, domain=AUTH_DOMAIN)


def auth_assignment(cs: R1CS, k_var: int, k: int, m: int, t: int) -> list[int]:
    """Traces a full satisfying assignment z over the domain (re-running
    the circuit construction in trace mode against a FRESH identical
    system so witness indices line up)."""
    cs2 = R1CS(num_public=cs.num_public, n=cs.n)
    z = [0] * cs.n
    z[cs2.one] = 1
    z[cs2.public(1)] = m % R
    z[cs2.public(2)] = t % R
    k2 = cs2.alloc()
    z[k2] = k % R
    dom = poseidon._domain_to_field(AUTH_DOMAIN)
    state = [{cs2.one: dom}, {k2: 1}, {cs2.public(1): 1}]
    _poseidon_circuit(cs2, state, z)
    return z
