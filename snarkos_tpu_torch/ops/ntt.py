"""Radix-2 NTT over Fr (the port of ``snarkos_tpu/ops/ntt.py``).

Bit-exact against crypto/ref/ntt.py. Decimation in time: a bit-reversal
gather, then log2(n) butterfly stages; the stage of half-length m = 2^s
pairs u = a[g 2m + j] with v = a[g 2m + j + m] and writes u + w, u - w with
w = v omega_{2m}^j. The twiddles of every stage come from one (16, n - 1)
stage table a size and direction (``_stage_table``: stage s at offset
2^s - 1), cut from the (16, n/2) master table of omega powers.

On a CUDA tensor a transform is ``len(_pass_plan(log2 n))`` launches of
kernel B1's NTT entry ``fr_ntt_pass`` (``csrc/ntt.cu``), at most three at
2^22: each runs k consecutive stages in shared memory, the first one with
the gather (and n^-1 for the inverse) folded in, out of place; the others
in place. On a CPU tensor each pass runs its plain version (``pass_plain``:
``bitrev_plain``, then ``stage_plain``). ``ntt_plain`` is the JAX package's
stage loop (``_ntt_kernel``) in plain PyTorch, with the master table and
its separate n^-1 pass: the yardstick of the tests and of chip_smoke.py.

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


# The per-stage table holds twice the master table's words (256 MiB at 2^22),
# so the two caches hold at most 4 x (128 + 256) MiB at 2^22.
@functools.lru_cache(maxsize=4)
def _stage_table(n: int, invert: bool, device: torch.device) -> torch.Tensor:
    """(L, n - 1) Montgomery table, contiguous on ``device``: stage s starts
    at offset 2^s - 1 and its element j is omega_{2^(s+1)}^j (the JAX
    package's ``_stage_twiddles``, concatenated), a strided slice of the
    master table a stage."""
    master = _master_table(n, invert, device)
    return torch.cat([master[:, :: n >> (s + 1)] for s in range(n.bit_length() - 1)],
                     dim=1).contiguous()


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
# kernel B1's NTT entry (csrc/ntt.cu) and its plain version
# ---------------------------------------------------------------------------

# The pass plan and tile: at most K_MAX stages a pass, tiles of up to
# 2^PASS_LOG_ELEMS elements (cols = 2^(PASS_LOG_ELEMS - k) columns, cut to
# what the pass has), PASS_THREADS threads a block. From the sweep of
# chip_smoke.py phase 9 at 2^22 and 2^20 (PERF.md).
K_MAX = 8
PASS_LOG_ELEMS = 10
PASS_THREADS = 256
PASS_SMEM_MAX = 232448  # bytes of shared memory a block may use on sm_90


def _pass_plan(log_n: int, k_max: int | None = None) -> tuple:
    """The passes ((s0, k), ...) of a transform of 2^log_n: ceil(log_n /
    k_max) runs of consecutive stages that tile [0, log_n), as even as
    possible, the longer first (8 + 7 + 7 at 2^22)."""
    k_max = K_MAX if k_max is None else k_max
    if log_n < 1 or k_max < 1:
        raise ValueError(f"ntt pass plan: log_n = {log_n}, k_max = {k_max}")
    count = -(-log_n // k_max)
    base, extra = divmod(log_n, count)
    plan, s0 = [], 0
    for i in range(count):
        k = base + (i < extra)
        plan.append((s0, k))
        s0 += k
    return tuple(plan)


def _pass_cols(log_n: int, s0: int, k: int, log_elems: int | None = None) -> int:
    """Columns of a pass's tile: 2^(log_elems - k), at most the pass's
    chunks (2^(log_n - k)) in the first pass and its columns (2^s0) in a
    later one, at least 1."""
    log_elems = PASS_LOG_ELEMS if log_elems is None else log_elems
    return 1 << min(log_n - k if s0 == 0 else s0, max(0, log_elems - k))


def _pass_smem(k: int, cols: int, first: bool) -> int:
    """Bytes of shared memory of a pass's block: the tile's 8 word planes,
    2^k rows of cols + 1 words, and the first pass's 2^k twiddle slots."""
    return 4 * 8 * ((1 << k) * (cols + 1) + ((1 << k) if first else 0))


def bitrev_plain(a: torch.Tensor, scale: torch.Tensor | None = None) -> torch.Tensor:
    """The bit-reversal gather in plain PyTorch on (L, B, n), any device:
    out[:, b, i] = a[:, b, rev(i)], times ``scale`` ((L, 1) Montgomery) if
    given."""
    n = a.shape[-1]
    out = a.index_select(-1, torch.from_numpy(_bitrev_perm(n)).to(a.device).long())
    if scale is not None:
        out = fa.mont_mul_plain(FR, out, scale.view(FR.nlimbs, 1, 1))
    return out


def stage_plain(a: torch.Tensor, twiddles: torch.Tensor, s: int) -> torch.Tensor:
    """One radix-2 DIT stage in plain PyTorch on (L, B, n), any device: the
    stage of half-length m = 2^s with its (L, m) twiddles omega_{2m}^j;
    returns a new tensor."""
    L, B, n = a.shape
    m = 1 << s
    v = a.reshape(L, B, n // (2 * m), 2, m)
    u, w = v[:, :, :, 0], v[:, :, :, 1]
    w = fa.mont_mul_plain(FR, w, twiddles.reshape(L, 1, 1, m))
    return torch.stack([fa.add(FR, u, w), fa.sub(FR, u, w)], dim=3).reshape(L, B, n)


def _stage_twiddles(table: torch.Tensor, s: int) -> torch.Tensor:
    return table[:, (1 << s) - 1:(2 << s) - 1]


def pass_plain(a: torch.Tensor, table: torch.Tensor, s0: int, k: int,
               scale: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of ``fr_ntt_pass`` on (L, B, n), any device:
    the gather (times ``scale``) when s0 == 0, then stages s0 .. s0 + k - 1
    with the twiddles of the (L, n - 1) stage table; returns a new
    tensor."""
    if s0 != 0 and scale is not None:
        raise ValueError("ntt pass: only the first pass scales")
    out = bitrev_plain(a, scale) if s0 == 0 else a
    for s in range(s0, s0 + k):
        out = stage_plain(out, _stage_twiddles(table, s), s)
    return out


def pass_kernel(a: torch.Tensor, out: torch.Tensor, table: torch.Tensor, s0: int, k: int,
                scale: torch.Tensor | None = None, *, cols: int | None = None,
                threads: int | None = None) -> torch.Tensor:
    """Launch ``fr_ntt_pass`` on (L, B, n) int32 CUDA tensors: stages s0 ..
    s0 + k - 1 with the (L, n - 1) stage table, from ``a`` into ``out``. The
    first pass (s0 == 0) gathers into a new ``out`` (times an (L, 1)
    ``scale``, or None); a later one runs in place (``out is a``). ``cols``
    and ``threads`` override the tile's columns and the block size (the
    sweep). Returns ``out``."""
    L, B, n = a.shape if a.dim() == 3 else (None, None, None)
    _build.check(a, (FR.nlimbs, B, n), "ntt pass a")
    _build.check(out, (FR.nlimbs, B, n), "ntt pass out")
    log_n = _log2(n)
    _build.check(table, (FR.nlimbs, n - 1), "ntt pass table")
    if scale is not None:
        _build.check(scale, (FR.nlimbs, 1), "ntt pass scale")
    if s0 < 0 or k < 1 or s0 + k > log_n:
        raise ValueError(f"ntt pass: stages [{s0}, {s0 + k}) outside [0, {log_n})")
    if (out.data_ptr() == a.data_ptr()) != (s0 != 0) or (s0 != 0 and scale is not None):
        raise ValueError("ntt pass: the first pass writes a new tensor (and may scale); "
                         "a later one runs in place")
    if B:
        fn = _build.entry("ntt", "fr_ntt_pass", 4, 6)
        _build.launch(fn, (a, out, table, scale),
                      (n, B, s0, k, cols or _pass_cols(log_n, s0, k), threads or PASS_THREADS),
                      a.device)
        pass_kernel.launches += 1
    return out


pass_kernel.launches = 0


def pass_(a: torch.Tensor, out: torch.Tensor | None, table: torch.Tensor, s0: int, k: int,
          scale: torch.Tensor | None = None) -> torch.Tensor:
    """One pass of the plan: the kernel on a CUDA tensor (into ``out``), the
    plain version on a CPU tensor (a new tensor; ``out`` is not used)."""
    if a.device.type == "cpu":
        return pass_plain(a, table, s0, k, scale)
    return pass_kernel(a.to(torch.int32).contiguous(), out, table, s0, k, scale)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


def _check_size(n: int) -> None:
    if n < 1 or n & (n - 1):
        raise ValueError(f"ntt: size {n} must be a power of two")


def _transform(a: torch.Tensor, invert: bool) -> torch.Tensor:
    """(L, B, n), n >= 2: the passes of the plan, the first one gathering
    (times n^-1 for the inverse) into a new tensor, the others in place. No
    host read, no host sync."""
    n = a.shape[-1]
    table = _stage_table(n, invert, a.device)
    scale = _n_inv_const(n, a.device) if invert else None
    out = None if a.device.type == "cpu" else torch.empty(a.shape, dtype=torch.int32,
                                                           device=a.device)
    for s0, k in _pass_plan(n.bit_length() - 1):
        a = pass_(a, out, table, s0, k, scale if s0 == 0 else None)
    return a


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
        out = stage_plain(out, master[:, :: n >> (s + 1)], s)
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
