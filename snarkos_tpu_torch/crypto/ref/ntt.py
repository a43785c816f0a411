"""Reference radix-2 NTT over BLS12-377 Fr (the port's own copy of
``snarkos_tpu/crypto/ref/ntt.py``, pure Python).

The host oracle of ``ops/ntt.py``. Forward transform:
    NTT(a)[k] = sum_j a[j] * omega^(j*k) mod r
with omega a primitive n-th root of unity derived from the verified
2-adic root (params.FR_ROOT_OF_UNITY, order 2^47).
"""

from __future__ import annotations

from snarkos_tpu_torch.crypto import params

R = params.FR_MODULUS


def root_of_unity(n: int) -> int:
    """Primitive n-th root of unity in Fr (n a power of two, n <= 2^47)."""
    assert n & (n - 1) == 0, "n must be a power of two"
    log_n = n.bit_length() - 1
    assert log_n <= params.FR_TWO_ADICITY
    root = params.FR_ROOT_OF_UNITY
    for _ in range(params.FR_TWO_ADICITY - log_n):
        root = root * root % R
    return root


def bit_reverse(x: int, bits: int) -> int:
    out = 0
    for _ in range(bits):
        out = (out << 1) | (x & 1)
        x >>= 1
    return out


def ntt(a: list[int], invert: bool = False) -> list[int]:
    """In-order iterative Cooley-Tukey NTT (natural in, natural out)."""
    n = len(a)
    assert n & (n - 1) == 0
    log_n = n.bit_length() - 1
    a = [a[bit_reverse(i, log_n)] % R for i in range(n)]
    omega_n = root_of_unity(n)
    if invert:
        omega_n = pow(omega_n, -1, R)
    length = 2
    while length <= n:
        w_len = pow(omega_n, n // length, R)
        for start in range(0, n, length):
            w = 1
            for j in range(length // 2):
                u = a[start + j]
                v = a[start + j + length // 2] * w % R
                a[start + j] = (u + v) % R
                a[start + j + length // 2] = (u - v) % R
                w = w * w_len % R
        length <<= 1
    if invert:
        n_inv = pow(n, -1, R)
        a = [x * n_inv % R for x in a]
    return a


def intt(a: list[int]) -> list[int]:
    return ntt(a, invert=True)


def poly_eval(coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R
    return acc
