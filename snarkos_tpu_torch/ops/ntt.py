"""Radix-2 NTT over Fr (the port of ``snarkos_tpu/ops/ntt.py``).

Bit-exact against crypto/ref/ntt.py. Decimation in time: one bit-reversal
gather, then log2(n) butterfly stages; the stage of half-length m = 2^s
pairs u = a[g 2m + j] with v = a[g 2m + j + m] and writes u + w, u - w with
w = v W[j n / 2m], where W[i] = omega^i is one master table of n/2
Montgomery powers (omega of order n, or its inverse), shared by every stage.

On a CUDA tensor a transform is log2(n) + 1 launches of kernel B1's two NTT
entries (``csrc/ntt.cu``): ``fr_ntt_bitrev`` (the gather, with n^-1 folded
in for the inverse) and ``fr_ntt_stage`` (one stage, in place). On a CPU
tensor each runs its plain version. ``ntt_plain`` is the JAX package's
stage loop (``_ntt_kernel``) in plain PyTorch, with its separate n^-1
pass: the yardstick of the tests and of chip_smoke.py.

Not ported: the JAX package's four-step (Bailey) path for n >= 2^12
(``_ntt_four_step_kernel`` and its tables). It exists because the TPU's
128-lane axis wastes lanes at small m; the card has no such axis, so the
port runs the one stage loop at every size, with the same field values.

``geometric_powers`` serves the KZG eval/quotient of the puzzle prover.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from snarkos_tpu_torch.crypto import params
from snarkos_tpu_torch.crypto.ref import ntt as ref
from snarkos_tpu_torch.ops import _build
from snarkos_tpu_torch.ops import modarith as fa
from snarkos_tpu_torch.ops.fieldspec import FR

R = params.FR_MODULUS

_DIGIT_BITS = 8


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


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _bitrev_perm(n: int) -> np.ndarray:
    log_n = n.bit_length() - 1
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros_like(idx)
    for _ in range(log_n):
        rev = (rev << 1) | (idx & 1)
        idx >>= 1
    return rev.astype(np.int32)


# A cached table lives on its device: at n = 2^22 an entry is (16, 2^21)
# int32, 128 MiB, so the cache is bounded (4 entries = forward and inverse
# of two active sizes) rather than growing with every size seen.
@functools.lru_cache(maxsize=4)
def _master_table(n: int, invert: bool, device: torch.device) -> torch.Tensor:
    """(L, n/2) Montgomery table W[i] = omega^i (omega of order n, or its
    inverse), contiguous on ``device``. The host computes the powers of
    each 8-bit digit of i with Python ints; the device gathers them by
    digit (``index_select``) and multiplies the digits' columns together,
    at most two ``fa.mont_mul`` calls (B1 on the card)."""
    omega = ref.root_of_unity(n)
    if invert:
        omega = pow(omega, -1, R)
    half = max(n // 2, 1)
    ndigits = max(1, -(-max(half.bit_length() - 1, 1) // _DIGIT_BITS))
    idx = torch.arange(half, device=device)
    mask = (1 << _DIGIT_BITS) - 1
    out = None
    for k in range(ndigits):
        base = pow(omega, 1 << (_DIGIT_BITS * k), R)
        size = min(1 << _DIGIT_BITS, half)
        table = torch.from_numpy(np.ascontiguousarray(
            FR.encode_fast([pow(base, d, R) for d in range(size)], mont=True))).to(device)
        col = table.index_select(1, (idx >> (_DIGIT_BITS * k)) & mask)
        out = col if out is None else fa.mont_mul(FR, out, col)
    return out.contiguous()


@functools.lru_cache(maxsize=None)
def _n_inv_const(n: int, device: torch.device) -> torch.Tensor:
    """(L, 1) Montgomery n^-1, contiguous on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(
        FR.encode_fast([pow(n, -1, R)], mont=True))).to(device)


def _log2(n) -> int:
    """log2 of a power of two 2 <= n <= 2^31 (the kernels' range)."""
    if n < 2 or n & (n - 1) or n > 1 << 31:
        raise ValueError(f"ntt kernels: size {n} is not a power of two in [2, 2^31]")
    return n.bit_length() - 1


# ---------------------------------------------------------------------------
# kernel B1's NTT entries (csrc/ntt.cu) and their plain versions
# ---------------------------------------------------------------------------


def bitrev_plain(a: torch.Tensor, scale: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of ``fr_ntt_bitrev`` on (L, B, n), any device:
    out[:, b, i] = a[:, b, rev(i)], times ``scale`` ((L, 1) Montgomery) if
    given."""
    n = a.shape[-1]
    out = a.index_select(-1, torch.from_numpy(_bitrev_perm(n)).to(a.device).long())
    if scale is not None:
        out = fa.mont_mul_plain(FR, out, scale.view(FR.nlimbs, 1, 1))
    return out


def bitrev_kernel(a: torch.Tensor, scale: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``fr_ntt_bitrev`` on a (L, B, n) int32 CUDA tensor (and an
    (L, 1) scale, or None); writes a new tensor."""
    L, B, n = a.shape if a.dim() == 3 else (None, None, None)
    _build.check(a, (FR.nlimbs, B, n), "ntt bitrev a")
    if scale is not None:
        _build.check(scale, (FR.nlimbs, 1), "ntt bitrev scale")
    log_n = _log2(n)
    out = torch.empty_like(a)
    if B:
        fn = _build.entry("ntt", "fr_ntt_bitrev", 3, 3)
        _build.launch(fn, (a, out, scale), (n, B, log_n), a.device)
        bitrev_kernel.launches += 1
    return out


bitrev_kernel.launches = 0


def bitrev(a: torch.Tensor, scale: torch.Tensor | None = None) -> torch.Tensor:
    """The bit-reversal gather: the kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if a.device.type == "cpu":
        return bitrev_plain(a, scale)
    return bitrev_kernel(a.to(torch.int32).contiguous(), scale)


def stage_plain(a: torch.Tensor, master: torch.Tensor, s: int) -> torch.Tensor:
    """Plain PyTorch version of ``fr_ntt_stage`` on (L, B, n), any device:
    the radix-2 stage of half-length m = 2^s with the twiddles W[j n / 2m]
    of the (L, n/2) master table; returns a new tensor."""
    L, B, n = a.shape
    m = 1 << s
    v = a.reshape(L, B, n // (2 * m), 2, m)
    u, w = v[:, :, :, 0], v[:, :, :, 1]
    w = fa.mont_mul_plain(FR, w, master[:, :: n // (2 * m)].reshape(L, 1, 1, m))
    return torch.stack([fa.add(FR, u, w), fa.sub(FR, u, w)], dim=3).reshape(L, B, n)


def stage_kernel(a: torch.Tensor, master: torch.Tensor, s: int) -> torch.Tensor:
    """Launch ``fr_ntt_stage`` on a (L, B, n) int32 CUDA tensor with the
    (L, n/2) master table: stage s of the transform, in place; returns
    ``a``."""
    L, B, n = a.shape if a.dim() == 3 else (None, None, None)
    _build.check(a, (FR.nlimbs, B, n), "ntt stage a")
    log_n = _log2(n)
    _build.check(master, (FR.nlimbs, n // 2), "ntt stage master")
    if not 0 <= s < log_n:
        raise ValueError(f"ntt stage: s = {s} outside [0, {log_n})")
    if B:
        fn = _build.entry("ntt", "fr_ntt_stage", 2, 3)
        _build.launch(fn, (a, master), (n, B, s), a.device)
        stage_kernel.launches += 1
    return a


stage_kernel.launches = 0


def stage(a: torch.Tensor, master: torch.Tensor, s: int) -> torch.Tensor:
    """One butterfly stage: the kernel (in place) on a CUDA tensor, the
    plain version on a CPU tensor."""
    if a.device.type == "cpu":
        return stage_plain(a, master, s)
    return stage_kernel(a, master, s)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


def _check_size(n: int) -> None:
    if n < 1 or n & (n - 1):
        raise ValueError(f"ntt: size {n} must be a power of two")


def _transform(a: torch.Tensor, invert: bool) -> torch.Tensor:
    """(L, B, n), n >= 2: the gather (times n^-1 for the inverse), then the
    log2(n) stages. No host read, no host sync."""
    n = a.shape[-1]
    master = _master_table(n, invert, a.device)
    out = bitrev(a, _n_inv_const(n, a.device) if invert else None)
    for s in range(n.bit_length() - 1):
        out = stage(out, master, s)
    return out


def ntt_plain(a: torch.Tensor, invert: bool = False) -> torch.Tensor:
    """Plain PyTorch NTT of (L, n) or (L, B, n), any device: the JAX
    package's stage loop, the inverse scaled by n^-1 after the stages."""
    n = a.shape[-1]
    _check_size(n)
    if n == 1:
        return a
    a3 = a.reshape(FR.nlimbs, -1, n)
    master = _master_table(n, invert, a.device)
    out = bitrev_plain(a3)
    for s in range(n.bit_length() - 1):
        out = stage_plain(out, master, s)
    if invert:
        out = fa.mont_mul_plain(FR, out, _n_inv_const(n, a.device).view(FR.nlimbs, 1, 1))
    return out.reshape(a.shape)


def ntt(a: torch.Tensor, invert: bool = False) -> torch.Tensor:
    """(L, N) Montgomery Fr coefficients -> (L, N) evaluations (or inverse),
    on the input's device.

    Natural order in, natural order out: NTT(a)[k] = sum_j a_j omega^{jk}.
    """
    L, n = a.shape
    _check_size(n)
    if n == 1:
        return a
    return _transform(a.reshape(L, 1, n), invert).reshape(L, n)


def intt(a: torch.Tensor) -> torch.Tensor:
    return ntt(a, invert=True)


def ntt_batched(a: torch.Tensor, invert: bool = False) -> torch.Tensor:
    """(L, B, N): independent NTTs over the trailing axis per batch row."""
    L, B, n = a.shape
    _check_size(n)
    if n == 1:
        return a
    return _transform(a, invert)
