"""The puzzle's evaluation and quotient (``ops/kzg.eval_and_quotient_multi``):
y = p(z) and q = (p - y) / (X - z) of every nonce's polynomial. Work in its
least form: Horner's rule for y and synthetic division for q, one Fr product
a coefficient each; each coefficient read and each quotient coefficient
written once."""

from benchmark import peaks

LAYER = "evaluation and quotient (ops/kzg)"
TARGETS = ["snarkos_tpu_torch.ops.kzg:eval_and_quotient_multi"]


def work(target: str, args: dict) -> tuple:
    _, nonces, k = args["coeffs_mont"].shape  # (L, B, K)
    return 2 * nonces * k * peaks.FR_MUL_OPS, 2 * nonces * k * 32
