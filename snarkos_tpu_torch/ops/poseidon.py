"""Batched Poseidon sponge over Fr (the port of ``snarkos_tpu/ops/poseidon.py``).

Bit-exact against crypto/ref/poseidon.py. The batch axis is data-parallel.
``permute`` runs the whole permutation in one launch of
``fr_poseidon_permute`` (``csrc/mont_mul.cu``, kernel B1's Fr pass) on a
CUDA tensor, and its plain version, one field op at a time, on a CPU tensor:
the x^17 s-box is four squarings and a multiply, the MDS mix t^2 constant
multiplies.

State layout: (t, L, B) int32 — t state slots of L 16-bit-limb Montgomery
Fr elements over batch B.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from snarkos_tpu_torch.crypto.ref import poseidon as ref
from snarkos_tpu_torch.ops import _build
from snarkos_tpu_torch.ops import modarith as fa
from snarkos_tpu_torch.ops.fieldspec import FR

ALPHA = ref.ALPHA
FULL_ROUNDS = ref.FULL_ROUNDS
PARTIAL_ROUNDS = ref.PARTIAL_ROUNDS
ROUNDS = FULL_ROUNDS + PARTIAL_ROUNDS
# the rates whose state widths the permute kernel is built for
KERNEL_RATES = (2, 4)


@functools.lru_cache(maxsize=None)
def packed_consts(rate: int) -> torch.Tensor:
    """The permutation's constants as one contiguous int32 tensor of
    Montgomery limbs, (ROUNDS t + t^2, L): the round constants ark
    (ROUNDS, t, L), then the MDS matrix (t, t, L), t = rate + 1."""
    ark, mds = ref.poseidon_params(rate)
    flat = [v for row in ark for v in row] + [v for row in mds for v in row]
    return torch.from_numpy(np.ascontiguousarray(FR.encode_fast(flat, mont=True).T))


@functools.lru_cache(maxsize=None)
def _device_consts(rate: int, device: torch.device) -> torch.Tensor:
    return packed_consts(rate).to(device)


def _consts(rate: int, device: torch.device):
    """(ark, mds) for the plain version: ark (ROUNDS, t, L, 1), mds
    (t, t, L, 1)."""
    t = rate + 1
    packed = _device_consts(rate, device)
    return (packed[:ROUNDS * t].reshape(ROUNDS, t, FR.nlimbs, 1),
            packed[ROUNDS * t:].reshape(t, t, FR.nlimbs, 1))


def _sbox(x: torch.Tensor) -> torch.Tensor:
    """x^17 = ((((x^2)^2)^2)^2) * x."""
    y = x
    for _ in range(4):
        y = fa.mont_mul_plain(FR, y, y)
    return fa.mont_mul_plain(FR, y, x)


def _mix(state: list, mds: torch.Tensor) -> list:
    """MDS matrix multiply: out_i = sum_j mds[i][j] * s_j."""
    t = len(state)
    rows = []
    for i in range(t):
        acc = None
        for j in range(t):
            term = fa.mont_mul_plain(FR, mds[i, j], state[j])
            acc = term if acc is None else fa.add(FR, acc, term)
        rows.append(acc)
    return rows


def permute_plain(state: torch.Tensor, rate: int) -> torch.Tensor:
    """Plain PyTorch version of the permutation on (t, L, B) state
    (Montgomery form), on any device."""
    ark, mds = _consts(rate, state.device)
    t = rate + 1
    assert state.shape[0] == t
    half = FULL_ROUNDS // 2
    s = list(state)
    for rnd in range(ROUNDS):
        s = [fa.add(FR, s[i], ark[rnd, i]) for i in range(t)]
        if rnd < half or rnd >= half + PARTIAL_ROUNDS:
            s = [_sbox(v) for v in s]
        else:
            s[0] = _sbox(s[0])
        s = _mix(s, mds)
    return torch.stack(s)


def permute_kernel(state: torch.Tensor, rate: int) -> torch.Tensor:
    """Launch ``fr_poseidon_permute`` on a (rate + 1, L, B) int32 CUDA
    tensor; rates other than ``KERNEL_RATES`` raise."""
    t, _, B = state.shape if state.dim() == 3 else (None, None, None)
    _build.check(state, (rate + 1, FR.nlimbs, B), "permute state")
    if rate not in KERNEL_RATES:
        raise ValueError(f"permute_kernel: no kernel for rate {rate} (built for {KERNEL_RATES})")
    out = torch.empty_like(state)
    if B:
        fn = _build.entry("mont_mul", "fr_poseidon_permute", 3, 2)
        _build.launch(fn, (state, _device_consts(rate, state.device), out), (B, t),
                      state.device)
        permute_kernel.launches += 1
    return out


permute_kernel.launches = 0


def permute(state: torch.Tensor, rate: int) -> torch.Tensor:
    """The Poseidon permutation on (t, L, B) state (Montgomery form): one
    launch of the permute kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    if state.device.type == "cpu":
        return permute_plain(state, rate)
    return permute_kernel(state.to(torch.int32).contiguous(), rate)


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
