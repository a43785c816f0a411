"""The port's counterpart of ``__graft_entry__.entry()``: one forward step
of the flagship pipeline over Fr limbs, counter-mode Poseidon coefficient
generation, then the radix-2 NTT, then a pointwise square.

    forward, (seed, ctr) = entry(log_n=22)
    out = forward(seed, ctr)

On the card a call is one ``fr_poseidon_permute``, ``len(ntt._pass_plan(log_n))``
``fr_ntt_pass`` (three at 2^22) and one ``mont_mul`` launch (kernel B1), once
the NTT's twiddle tables for the size are cached.
"""

from __future__ import annotations

import numpy as np
import torch

from snarkos_tpu_torch.ops import _build, ntt, poseidon
from snarkos_tpu_torch.ops import modarith as fa
from snarkos_tpu_torch.ops.fieldspec import FR

DOMAIN = "graft.entry"


def forward(seed: torch.Tensor, ctr: torch.Tensor) -> torch.Tensor:
    """(L, n) Montgomery seed and counter lanes -> (L, n) squared
    evaluations of the Poseidon coefficient vector."""
    coeffs = poseidon.hash_fixed(torch.stack([seed, ctr]), rate=2, domain=DOMAIN)[0]
    evals = ntt.ntt(coeffs)
    return fa.mont_mul(FR, evals, evals)


def entry(log_n: int = 10, device=None):
    """``(forward, (seed, ctr))`` at n = 2^log_n on ``device`` (None: the
    card), built as the JAX package's entry builds them: seed uniform Fr
    limbs from ``np.random.default_rng(0)``, ctr limb 0 = i & 0xFFFF and the
    other limbs 0."""
    device = _build.resolve_device(device)
    n = 1 << log_n
    seed = FR.random(n, np.random.default_rng(0))
    ctr = np.zeros((FR.nlimbs, n), dtype=np.int32)
    ctr[0] = np.arange(n) & 0xFFFF
    return forward, tuple(torch.from_numpy(a).to(device) for a in (seed, ctr))
