"""The peaks a roofline share is taken against, and the cost of the field
arithmetic in 32-bit multiplies.

Published NVIDIA H100 SXM peaks (NVIDIA's H100 data sheet, dense rates at
the full 700 W power limit; a card set below it runs slower, so every run
records its power limit beside the shares): 3.35 TB/s of HBM3, and 67
TFLOP/s of float32 outside the tensor cores, that is 33.5 T fused
multiply-adds a second. Hopper issues 32-bit integer multiply-adds at half
the float32 FMA rate (64 against 128 per SM and clock), so 16.75 T/s. This
integer peak is derived, not measured. A 32 x 32 -> 64-bit word product
costs two of them (the low and the high half).
"""

HBM_BYTES_PER_S = 3.35e12
INT32_MULS_PER_S = 67e12 / 2 / 2

# 32-bit multiplies of one Montgomery product (CIOS: n^2 word products for
# the product, n^2 + n for the reduction, each word product two multiplies)
FQ_MUL_OPS = 2 * (2 * 12 * 12 + 12)  # Fq: 12 words of 32 bits
FR_MUL_OPS = 2 * (2 * 8 * 8 + 8)  # Fr: 8 words
# pieces of the least form of the Poseidon permutation: a 512-bit product
# (64 word products), a 512-bit square (36) and a reduction of 512 bits (64
# word products and 8 word multipliers m)
FR_WIDE_MUL, FR_WIDE_SQR, FR_REDC = 2 * 64, 2 * 36, 2 * 64 + 8


def bound_seconds(muls: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the 32-bit
    multiplies over the integer peak and the bytes over HBM's bandwidth."""
    return max(muls / INT32_MULS_PER_S, nbytes / HBM_BYTES_PER_S)
