"""Batched multi-precision modular arithmetic in 16-bit limbs (the port of
``snarkos_tpu/ops/modarith.py``).

Representation
--------------
The JAX package's layout: a batch of field elements is an int32 tensor of
shape ``(L, *batch)`` of little-endian 16-bit limbs, in Montgomery form with
R = 2^(16 L) (2^384 for Fq, 2^256 for Fr), canonical (< p) between ops.
Because R is the JAX package's R and every result is canonical, the outputs
equal the JAX outputs limb for limb.

Montgomery multiply (kernel B1)
-------------------------------
``mont_mul`` launches ``csrc/mont_mul.cu`` on a CUDA tensor and runs the
plain version, ``mont_mul_plain``, on a CPU tensor. The plain version does
the JAX limb arithmetic in int64 tensors (never relying on an int32 multiply
that wraps): the operand product as columns of 16-bit limb products, the SOS
Montgomery reduction, the carry normalisation and the conditional subtract
(``modarith.py:51-79, 314-361`` of the JAX package). SOS picks the limb
multipliers m_i one at a time; together they form the unique m < R with
T + m p = 0 (mod R), i.e. m = (T mod R) (-p^-1) mod R, and the plain version
computes that m in one product so that it runs as a few whole-tensor ops
instead of L dependent steps. Carries resolve the same way: a few parallel
carry passes, then one carry-lookahead step (``_normalize``).

Field add, sub and neg are plain PyTorch on every device.
"""

from __future__ import annotations

import functools

import torch

from snarkos_tpu_torch.ops import _build
from snarkos_tpu_torch.ops.fieldspec import LIMB_BITS, LIMB_MASK, FieldSpec

# ---------------------------------------------------------------------------
# constants as int64 limb vectors, one copy per (spec, device)
# ---------------------------------------------------------------------------


def _limbs(v: int, n: int) -> list[int]:
    return [(v >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n)]


@functools.lru_cache(maxsize=None)
def _consts(spec: FieldSpec, device: torch.device) -> dict:
    L = spec.nlimbs
    R = 1 << (LIMB_BITS * L)
    t = functools.partial(torch.tensor, dtype=torch.int64, device=device)
    return {
        "p": t(spec.p_limbs),
        "r_minus_p": t(_limbs(R - spec.p, L)),
        "nprime": t(_limbs((-pow(spec.p, -1, R)) % R, L)),
        "lsb": t([1] + [0] * (L - 1)),
        # Toeplitz matrices of the constant factors, for exact float64
        # products (every partial sum stays below 2^53)
        "nprime_mat": _toeplitz(_limbs((-pow(spec.p, -1, R)) % R, L), L, device),
        "p_mat": _toeplitz(spec.p_limbs, 2 * L - 1, device),
    }


def _toeplitz(limbs: list[int], rows: int, device) -> torch.Tensor:
    """(rows, L) float64 matrix M with M[k, i] = limbs[k - i]: M @ x gives
    the product columns of the constant and the limb vector x."""
    L = len(limbs)
    m = torch.zeros(rows, L, dtype=torch.float64)
    for k in range(rows):
        for i in range(max(0, k - L + 1), min(k, L - 1) + 1):
            m[k, i] = limbs[k - i]
    return m.to(device)


def _col(vec: torch.Tensor, ndim: int) -> torch.Tensor:
    """(k,) constant -> (k, 1, ..., 1) against an ndim-dimensional tensor."""
    return vec.view((-1,) + (1,) * (ndim - 1))


# ---------------------------------------------------------------------------
# carries and the conditional subtract
# ---------------------------------------------------------------------------


def _normalize(cols: torch.Tensor, nout: int, bits: int) -> torch.Tensor:
    """Carry propagation: nonnegative int64 columns (k <= nout rows, each
    < 2^bits) -> ``nout`` canonical 16-bit limbs. A carry out of the top limb
    is dropped; call sites size ``nout`` so that it is zero or unwanted.

    Each parallel pass moves every column's carry one limb up and shrinks the
    largest value by 16 bits; once all limbs are <= 2^16 the remaining 0/1
    carries are resolved at once by carry-lookahead (``_ripple``)."""
    x = cols.new_zeros((nout,) + tuple(cols.shape[1:]))
    x[:cols.shape[0]] = cols
    while True:
        c = x >> LIMB_BITS
        x &= LIMB_MASK
        x[1:] += c[:-1]
        if bits <= LIMB_BITS + 1:
            break
        bits = max(LIMB_BITS, bits - LIMB_BITS) + 1
    return _ripple(x)


def _ripple(x: torch.Tensor) -> torch.Tensor:
    """Limbs in [0, 2^16] -> canonical limbs. A limb equal to 2^16 generates
    a carry, 0xFFFF propagates one, anything else stops it: the carry into
    limb k is set iff the last non-propagating limb below k generates."""
    gen = x == (1 << LIMB_BITS)
    if not bool(gen.any()):
        return x
    stop = gen | (x != LIMB_MASK)
    idx = _col(torch.arange(x.shape[0], device=x.device), x.dim())
    last = torch.where(stop, idx, -1).cummax(0).values[:-1]
    carry_in = (last >= 0) & gen.gather(0, last.clamp(min=0))
    x[1:] += carry_in
    return x & LIMB_MASK


def _cond_sub_p(spec: FieldSpec, v: torch.Tensor) -> torch.Tensor:
    """Subtract p once if v >= p (v < 2p, canonical limbs): v + (R - p)
    carries out of the top limb exactly when v >= p."""
    L = spec.nlimbs
    s = _normalize(v + _col(_consts(spec, v.device)["r_minus_p"], v.dim()), L + 1,
                   LIMB_BITS + 1)
    return torch.where(s[L:] != 0, s[:L], v)


def _pick_reduced(spec: FieldSpec, lo: torch.Tensor, hi: torch.Tensor, bits: int):
    """Normalise two candidate column sets together and return ``hi``'s low
    L limbs where ``hi`` carried out of limb L, else ``lo``'s."""
    L = spec.nlimbs
    both = _normalize(torch.stack([lo, hi], 1), L + 1, bits)
    return torch.where(both[L:, 1] != 0, both[:L, 1], both[:L, 0])


# ---------------------------------------------------------------------------
# public ops — (L, *batch) limb tensors in Montgomery form; plain PyTorch
# on every device unless a kernel is named
# ---------------------------------------------------------------------------


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dtype = a.dtype
    a, b = torch.broadcast_tensors(a.long(), b.long())
    cols = a + b
    rmp = _col(_consts(spec, a.device)["r_minus_p"], a.dim())
    # a + b < 2p; a + b + (R - p) carries out iff a + b >= p
    return _pick_reduced(spec, cols, cols + rmp, LIMB_BITS + 2).to(dtype)


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dtype = a.dtype
    a, b = torch.broadcast_tensors(a.long(), b.long())
    c = _consts(spec, a.device)
    # (R - 1 - b) is limb-wise 0xFFFF - b, so t = a - b + R carries out of
    # limb L iff a >= b; otherwise u = t + p holds a - b + p below R
    t = a + (LIMB_MASK - b) + _col(c["lsb"], a.dim())
    return _pick_reduced(spec, t + _col(c["p"], a.dim()), t, LIMB_BITS + 2).to(dtype)


def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return sub(spec, torch.zeros_like(a), a)


def double(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return add(spec, a, a)


def mul_small(spec: FieldSpec, a: torch.Tensor, k: int) -> torch.Tensor:
    """Multiply by a small constant 0 <= k <= 8 via add chain."""
    assert 0 <= k <= 8
    if k == 0:
        return torch.zeros_like(a)
    acc = None
    addend = a
    while k:
        if k & 1:
            acc = addend if acc is None else add(spec, acc, addend)
        k >>= 1
        if k:
            addend = add(spec, addend, addend)
    return acc


def _product_cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(L, *batch) x (L, *batch) int64 limbs -> 2L-1 columns of the
    product, sum_{i+j=k} a_i b_j (unnormalised, < L 2^32)."""
    L = a.shape[0]
    batch = tuple(a.shape[1:])
    buf = a.new_zeros((L, 2 * L) + batch)
    inner = buf[0].numel() // (2 * L)
    # row i of the outer product lands at columns i .. i+L-1 of buf[i]
    view = buf.as_strided((L, L) + batch,
                          (2 * L * inner + inner, inner) + tuple(buf.stride()[2:]))
    torch.mul(a.unsqueeze(1), b.unsqueeze(0), out=view)
    return buf.sum(0)[:2 * L - 1]


def _const_product(mat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Columns of (constant) x (limb vector x): mat @ x in float64, exact
    while every column sum stays below 2^53."""
    flat = x.reshape(x.shape[0], -1).to(torch.float64)
    return (mat @ flat).to(torch.int64).reshape((mat.shape[0],) + tuple(x.shape[1:]))


def mont_mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel B1: a * b * R^-1 mod p, on any device."""
    dtype = a.dtype
    a, b = torch.broadcast_tensors(a.long(), b.long())
    a, b = a.contiguous(), b.contiguous()
    L = spec.nlimbs
    c = _consts(spec, a.device)
    # operand product: columns < L 2^32 < 2^37
    t = _product_cols(a, b)
    # SOS multiplier m = (T mod R) * (-p^-1) mod R from the low columns,
    # split into 16-bit halves so the float64 sums stay exact (< 2^42)
    low = t[:L]
    m_cols = _const_product(c["nprime_mat"], low & LIMB_MASK)
    m_cols[1:] += _const_product(c["nprime_mat"], low >> LIMB_BITS)[:-1]
    m = _normalize(m_cols, L, 43)
    # T + m p = 0 mod R; its high half is the result, < 2p
    u = t + _const_product(c["p_mat"], m)
    r = _normalize(u, 2 * L + 1, 38)[L:2 * L]
    return _cond_sub_p(spec, r).to(dtype)


# ---------------------------------------------------------------------------
# kernel B1 (csrc/mont_mul.cu)
# ---------------------------------------------------------------------------


def mont_mul_kernel(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch ``mont_mul_fq``/``mont_mul_fr`` on (L, n) int32 CUDA tensors."""
    L, n = a.shape if a.dim() == 2 else (None, None)
    if L != spec.nlimbs:
        raise ValueError(f"mont_mul_kernel: expected ({spec.nlimbs}, n), got {tuple(a.shape)}")
    _build.check(a, (L, n), "mont_mul_kernel a")
    _build.check(b, (L, n), "mont_mul_kernel b")
    out = torch.empty_like(a)
    if n:
        fn = _build.entry("mont_mul", f"mont_mul_{spec.name}", 3, 1)
        _build.launch(fn, (a, b, out), (n,), a.device)
        mont_mul_kernel.launches += 1
    return out


mont_mul_kernel.launches = 0


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * R^-1 mod p over broadcast (L, *batch) limb tensors. A CUDA
    tensor goes to kernel B1; a CPU tensor to the plain version."""
    if a.device.type == "cpu":
        return mont_mul_plain(spec, a, b)
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    a = a.to(torch.int32).reshape(shape[0], -1).contiguous()
    b = b.to(torch.int32).reshape(shape[0], -1).contiguous()
    return mont_mul_kernel(spec, a, b).reshape(shape)


def mont_sqr(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, a, a)


def mont_pow(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e in Montgomery form for a host exponent e (square and multiply)."""
    acc = broadcast_const(spec, 1, tuple(a.shape[1:]), device=a.device)
    for bit in bin(e)[2:] if e else "":
        acc = mont_sqr(spec, acc)
        if bit == "1":
            acc = mont_mul(spec, acc, a)
    return acc


def inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Batched inversion via Fermat: a^(p-2). The inverse of 0 is 0."""
    return mont_pow(spec, a, spec.p - 2)


def to_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, a, broadcast_const(spec, spec.mont_r2, tuple(a.shape[1:]),
                                             mont=False, device=a.device))


def from_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, a, broadcast_const(spec, 1, tuple(a.shape[1:]), mont=False,
                                             device=a.device))


def is_zero(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Boolean tensor of batch shape (canonical input)."""
    return (a == 0).all(0)


def eq(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(0)


@functools.lru_cache(maxsize=None)
def _const_limbs(spec: FieldSpec, value: int, mont: bool) -> tuple:
    v = value % spec.p
    if mont:
        v = v * spec.mont_r % spec.p
    return tuple(_limbs(v, spec.nlimbs))


def broadcast_const(spec: FieldSpec, value: int, batch_shape: tuple, mont: bool = True,
                    device=None) -> torch.Tensor:
    """A constant field element broadcast to (L, *batch_shape) int32.

    With ``mont=True`` the value is canonical and converted; ``mont=False``
    places raw limbs (e.g. R^2 itself)."""
    col = torch.tensor(_const_limbs(spec, value, mont), dtype=torch.int32, device=device)
    return col.view((spec.nlimbs,) + (1,) * len(batch_shape)).expand(
        (spec.nlimbs,) + tuple(batch_shape))

