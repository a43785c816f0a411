"""Batched Poseidon sponge over Fr (the port of ``snarkos_tpu/ops/poseidon.py``).

Bit-exact against crypto/ref/poseidon.py. The batch axis is data-parallel;
the x^17 s-box is four squarings and a multiply, the MDS mix t^2 constant
multiplies, all through ``modarith.mont_mul`` (kernel B1 on the card).

State layout: (t, L, B) int32 — t state slots of L 16-bit-limb Montgomery
Fr elements over batch B.
"""

from __future__ import annotations

import functools

import torch

from snarkos_tpu_torch.crypto.ref import poseidon as ref
from snarkos_tpu_torch.ops import modarith as fa
from snarkos_tpu_torch.ops.fieldspec import FR

ALPHA = ref.ALPHA
FULL_ROUNDS = ref.FULL_ROUNDS
PARTIAL_ROUNDS = ref.PARTIAL_ROUNDS


@functools.lru_cache(maxsize=None)
def _consts(rate: int, device: torch.device):
    """(ark, mds) as Montgomery limb tensors: ark (rounds, t, L, 1), mds
    (t, t, L, 1)."""
    ark, mds = ref.poseidon_params(rate)
    t = rate + 1
    ark_t = torch.stack([torch.from_numpy(FR.encode_fast(row, mont=True)).T.unsqueeze(-1)
                         for row in ark])
    mds_t = torch.stack([torch.from_numpy(FR.encode_fast(row, mont=True)).T.unsqueeze(-1)
                         for row in mds])
    assert ark_t.shape == (FULL_ROUNDS + PARTIAL_ROUNDS, t, FR.nlimbs, 1)
    return ark_t.contiguous().to(device), mds_t.contiguous().to(device)


def _sbox(x: torch.Tensor) -> torch.Tensor:
    """x^17 = ((((x^2)^2)^2)^2) * x."""
    y = x
    for _ in range(4):
        y = fa.mont_sqr(FR, y)
    return fa.mont_mul(FR, y, x)


def _mix(state: list, mds: torch.Tensor) -> list:
    """MDS matrix multiply: out_i = sum_j mds[i][j] * s_j."""
    t = len(state)
    rows = []
    for i in range(t):
        acc = None
        for j in range(t):
            term = fa.mont_mul(FR, mds[i, j], state[j])
            acc = term if acc is None else fa.add(FR, acc, term)
        rows.append(acc)
    return rows


def permute(state: torch.Tensor, rate: int) -> torch.Tensor:
    """The Poseidon permutation on (t, L, B) state (Montgomery form)."""
    ark, mds = _consts(rate, state.device)
    t = rate + 1
    assert state.shape[0] == t
    half = FULL_ROUNDS // 2
    s = list(state)
    for rnd in range(FULL_ROUNDS + PARTIAL_ROUNDS):
        s = [fa.add(FR, s[i], ark[rnd, i]) for i in range(t)]
        if rnd < half or rnd >= half + PARTIAL_ROUNDS:
            s = [_sbox(v) for v in s]
        else:
            s[0] = _sbox(s[0])
        s = _mix(s, mds)
    return torch.stack(s)


def hash_fixed(inputs: torch.Tensor, rate: int, domain: str = "",
               num_outputs: int = 1) -> torch.Tensor:
    """Sponge-hash a fixed number of field elements per lane.

    inputs: (n, L, B) Montgomery Fr elements; returns (num_outputs, L, B).
    Mirrors ref.poseidon.hash_many: capacity slot seeded from the domain,
    absorb-by-addition per rate block, permute between blocks."""
    n, L, B = inputs.shape
    t = rate + 1
    cap = fa.broadcast_const(FR, ref._domain_to_field(domain), (B,), device=inputs.device)
    zero = torch.zeros((L, B), dtype=torch.int32, device=inputs.device)
    slots = [cap] + [zero] * rate
    pos = 0
    for k in range(n):
        if pos == rate:
            slots = list(permute(torch.stack(slots), rate))
            pos = 0
        slots[1 + pos] = fa.add(FR, slots[1 + pos], inputs[k])
        pos += 1
    outs = []
    state = torch.stack([s.expand(L, B) for s in slots])
    while len(outs) < num_outputs:
        state = permute(state, rate)
        take = min(rate, num_outputs - len(outs))
        outs.extend(state[1 + i] for i in range(take))
    return torch.stack(outs[:num_outputs])
