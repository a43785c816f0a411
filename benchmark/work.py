"""The work an algorithm needs for a call's shapes: the numerators of the
roofline shares, fixed here and never read from the program.

``msm_products(n)`` counts the Fq products of Pippenger's bucket method
over n affine bases at the window c that needs the fewest for n (not the
program's c): with signed c-bit digits a scalar of 254 bits has W =
ceil(254 / c) windows of 2^(c-1) buckets; each window adds every base into
a bucket (a mixed add, 11 products), sums the buckets by a running sum (2
2^(c-1) full adds, 16 products each), and the windows are joined by c
doublings (7 products) and one full add each.

``sponge_permutations`` and ``poseidon_ops`` count the leaves' sponge as
its least form (the sparse partial rounds of the Poseidon paper);
``epoch_program_ops`` counts one Fr product a lane a step.
"""

from __future__ import annotations

from benchmark import peaks

SCALAR_BITS = 254  # 253-bit scalars and the signed digits' carry
MADD, ADD, DBL = 11, 16, 7  # Fq products of a mixed add, a full add, a doubling
FQ_BYTES, FR_BYTES = 48, 32


def pippenger_products(n: int, c: int) -> int:
    w = -(-SCALAR_BITS // c)
    return w * (n * MADD + (1 << c) * ADD) + (w - 1) * (c * DBL + ADD)


def best_window(n: int) -> int:
    return min(range(1, 25), key=lambda c: (pippenger_products(n, c), c))


def msm_products(n: int) -> int:
    return pippenger_products(n, best_window(n))


def msm_work(n: int, count: int = 1) -> tuple:
    """(32-bit multiplies, bytes) of ``count`` MSMs of n points over one
    shared affine base: the base read once, each scalar read once, each
    result written once (an affine point)."""
    muls = count * msm_products(n) * peaks.FQ_MUL_OPS
    nbytes = n * 2 * FQ_BYTES + count * (n * FR_BYTES + 2 * FQ_BYTES)
    return muls, nbytes


def poseidon_ops(t: int) -> int:
    """32-bit multiplies of one permutation of width t in its least form: 8
    full rounds of t s-boxes (x^17: four squarings and a product) and t MDS
    rows (t wide products, one reduction a chunk of at most 13); 31 partial
    rounds of one s-box, one row of t and t - 1 products (the sparse
    matrix)."""
    sbox = 4 * (peaks.FR_WIDE_SQR + peaks.FR_REDC) + peaks.FR_MUL_OPS
    row = t * peaks.FR_WIDE_MUL + -(-t // 13) * peaks.FR_REDC
    return 8 * t * (sbox + row) + 31 * (sbox + row + (t - 1) * peaks.FR_MUL_OPS)


def sponge_permutations(rate: int, n_in: int, n_out: int) -> int:
    """Permutations of the sponge: one between full rate blocks absorbed,
    one before each squeezed block."""
    blocks = max(1, -(-n_in // rate))
    return blocks - 1 + -(-n_out // rate)


def sponge_work(lanes: int, rate: int, n_in: int, n_out: int) -> tuple:
    muls = lanes * sponge_permutations(rate, n_in, n_out) * poseidon_ops(rate + 1)
    return muls, lanes * (n_in + n_out) * FR_BYTES


EPOCH_STEPS = 12


def epoch_program_work(nonces: int, k: int) -> tuple:
    """12 steps, one Fr product a lane a step; the leaves read and the
    coefficients written once, the program's wiring (4 bytes) and constant
    (32 bytes) a lane a step read once."""
    muls = EPOCH_STEPS * nonces * k * peaks.FR_MUL_OPS
    return muls, 2 * nonces * k * FR_BYTES + EPOCH_STEPS * k * (4 + FR_BYTES)
