"""Distributed radix-2 NTT over Fr by the four-step algorithm (the port of
``snarkos_tpu/parallel/ntt_dist.py``, BASELINE config #2).

A length-N transform is viewed as an (N1, N2) matrix and computed as column
NTTs, a twiddle scaling and row NTTs, with an all_to_all between the phases
so that every local transform is a batch of whole single-device transforms
(``ntt.ntt_batched``, kernel B1's ``fr_ntt_pass`` on the card).

Derivation (omega = omega_N, j = j1 N2 + j2, k = k1 + N1 k2):
    X[k1 + N1 k2] = NTT2_{j2->k2}( omega^{j2 k1} NTT1_{j1->k1}(A[j1, j2]) )
so with the input viewed as A[j1, j2] (row-major) the output lands in
natural order after one more transpose, which is the third all_to_all.

Each rank holds its (L, N/D) block of the trailing axis (``mesh.shard_last``)
in Montgomery Fr limbs, and gets back its block of the natural-order output.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from snarkos_tpu_torch.crypto import params
from snarkos_tpu_torch.crypto.ref import ntt as ref
from snarkos_tpu_torch.ops import modarith as fa
from snarkos_tpu_torch.ops import ntt
from snarkos_tpu_torch.ops.fieldspec import FR
from snarkos_tpu_torch.parallel.mesh import Mesh, all_to_all

R = params.FR_MODULUS


def _split(n: int) -> tuple[int, int]:
    """N = N1 * N2 with N1 <= N2, both powers of two."""
    log_n = n.bit_length() - 1
    log_n1 = log_n // 2
    return 1 << log_n1, 1 << (log_n - log_n1)


# A block lives on its device and holds N/D words a limb (256 MiB at 2^22 on
# one rank), so the cache is bounded, as ntt._master_table's is.
@functools.lru_cache(maxsize=4)
def _twiddle_matrix(n: int, invert: bool, device: torch.device, rank: int = 0,
                    world: int = 1) -> torch.Tensor:
    """Rank ``rank``'s columns [rank N2/world, (rank + 1) N2/world) of T[k1,
    j2] = omega^(k1 j2), as (L, N1, N2/world) Montgomery limbs, contiguous on
    ``device`` (omega of order n, or its inverse); the whole matrix at the
    defaults.

    Built on the device as the JAX package builds it: the row R_b[j2] =
    omega^(2^b j2) from ``ntt.geometric_powers`` and repeated squaring, and
    T = the product over the set bits b of k1, one masked ``mont_mul`` (B1 on
    the card) a bit; only this rank's columns of the row are kept."""
    n1, n2 = _split(n)
    w2 = n2 // world
    omega = ref.root_of_unity(n)
    if invert:
        omega = pow(omega, -1, R)
    base = torch.from_numpy(np.ascontiguousarray(FR.encode_fast([omega], mont=True))).to(device)
    row = ntt.geometric_powers(base, n2)[:, rank * w2:(rank + 1) * w2].contiguous()
    t = fa.broadcast_const(FR, 1, (n1, w2), device=device)
    k1 = torch.arange(n1, device=device).unsqueeze(1)  # (n1, 1)
    for b in range(n1.bit_length() - 1):
        term = fa.mont_mul(FR, t, row.unsqueeze(1))
        t = torch.where(((k1 >> b) & 1) != 0, term, t)
        row = fa.mont_sqr(FR, row)
    return t.contiguous()


def steps(mesh: Mesh, n: int, invert: bool = False) -> tuple:
    """``ntt_dist``'s body at size n as named steps ((name, fn), ...), each
    fn taking the previous step's output: this rank's (L, N/D) input block
    in, its (L, N/D) output block out. Apart, so that each can be timed."""
    L = FR.nlimbs
    d = mesh.world
    n1, n2 = _split(n)
    if n1 % d or n2 % d:
        raise ValueError(f"ntt_dist: {d} ranks do not divide N1 = {n1} and N2 = {n2}")
    tw = _twiddle_matrix(n, invert, mesh.device, mesh.rank, d)  # (L, n1, n2/d)
    return (
        # this rank's N1/D contiguous rows of the (N1, N2) matrix -> its N2/D
        # columns, so that the column NTTs are local
        ("exchange 1", lambda a: all_to_all(mesh, a.reshape(L, n1 // d, n2), 2, 1)),
        ("transpose 1", lambda a: a.transpose(1, 2).contiguous()),  # (L, n2/d, n1)
        # column NTTs (length n1, a batch over the local j2), then the twiddles
        ("column ntt_batched", lambda a: ntt.ntt_batched(a, invert)),
        ("transpose 2", lambda a: a.transpose(1, 2).contiguous()),  # (L, n1, n2/d)
        ("twiddle mont_mul", lambda a: fa.mont_mul(FR, a, tw)),
        # -> N1/D rows a rank, so that the row NTTs are local
        ("exchange 2", lambda a: all_to_all(mesh, a, 1, 2)),  # (L, n1/d, n2)
        ("row ntt_batched", lambda a: ntt.ntt_batched(a, invert)),
        # natural order: X[k1 + n1 k2] is the transpose (k2, k1), resharded
        ("transpose 3", lambda a: a.transpose(1, 2).contiguous()),  # (L, n2, n1/d)
        ("exchange 3", lambda a: all_to_all(mesh, a, 1, 2).reshape(L, n // d)),
    )


def ntt_dist(x_local: torch.Tensor, mesh: Mesh, invert: bool = False) -> torch.Tensor:
    """Distributed NTT: this rank's (L, N/D) block of the input in, its
    (L, N/D) block [r N/D, (r + 1) N/D) of the natural-order output back.
    D must divide N1 and N2. The inverse carries no extra 1/N: the column
    pass scales by 1/N1 and the row pass by 1/N2."""
    a = x_local
    for _, step in steps(mesh, x_local.shape[-1] * mesh.world, invert):
        a = step(a)
    return a


def intt_dist(x_local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return ntt_dist(x_local, mesh, invert=True)
