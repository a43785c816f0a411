"""Radix-2 NTT helpers over Fr (the port of ``snarkos_tpu/ops/ntt.py``).

Only ``geometric_powers`` is ported so far: the KZG eval/quotient of the
puzzle prover needs it. The transforms themselves wait (ROADMAP.md).
"""

from __future__ import annotations

import torch

from snarkos_tpu_torch.ops import modarith as fa
from snarkos_tpu_torch.ops.fieldspec import FR


def geometric_powers(base: torch.Tensor, m: int) -> torch.Tensor:
    """(L, *batch, 1) Montgomery base -> (L, *batch, m) powers
    [1, b, b^2, ..., b^{m-1}].

    Blocked as in the JAX package: the first block of 2^bbits powers comes
    from the bits of each index (bbits squarings and bbits masked
    multiplies), later blocks by multiplying by b^(2^bbits)."""
    batch = tuple(base.shape[1:-1])
    device = base.device
    if m == 1:
        return fa.broadcast_const(FR, 1, batch + (1,), device=device)
    bbits = min(12, (m - 1).bit_length())
    B = 1 << bbits
    pows = []
    b = base
    for _ in range(bbits):
        pows.append(b)
        b = fa.mont_sqr(FR, b)
    base_B = b
    i = torch.arange(B, device=device)
    block = fa.broadcast_const(FR, 1, batch + (B,), device=device)
    for k, pk in enumerate(pows):
        sel = ((i >> k) & 1) != 0
        block = torch.where(sel, fa.mont_mul(FR, block, pk), block)
    nblocks = -(-m // B)
    blocks = [block]
    for _ in range(nblocks - 1):
        blocks.append(fa.mont_mul(FR, blocks[-1], base_B))
    return torch.cat(blocks, dim=-1)[..., :m]
