"""The MSM's scan kernels, the port of ``snarkos_tpu/ops/msm_pallas.py``:
B4 the serial-chain bucket scan, B5 the wide-chain bucket scan, B6 its fast
variant with the incomplete add and an exception flag, B7 the Jacobian scan
of the bucket total.

Wide-chain layout (B5-B7): a (L, m, K) tensor holds KV = chunk * K
independent virtual chains of mv = m / chunk elements; chain l = r * K + k
(r < chunk) owns the contiguous sorted run [l * mv, (l + 1) * mv), and its
element i sits at row j = i * chunk + r, column k. Each plain version walks
the mv steps with one group operation over all KV lanes at once.

A CUDA tensor launches the kernel in ``csrc/``; a CPU tensor runs the plain
version.
"""

from __future__ import annotations

import torch

from snarkos_tpu_torch.ops import _build, g1
from snarkos_tpu_torch.ops import modarith as fa
from snarkos_tpu_torch.ops.fieldspec import FQ

_L = FQ.nlimbs

# Largest MSM (points x batch) that runs on the serial-chain engine; above
# it the wide-chain scans take over.
SERIAL_MAX_N = 1 << 15
# threads that scan one serial chain together (B4's team; PERF.md has the
# sweep on the card)
SERIAL_TEAM = 64
LANES = 512
CHUNK = 8
# the bucket total's Jacobian scan (B7) layout
JADD_LANES = 128
JADD_CHUNK = 8


def _check_layout(name, xs, lanes, chunk):
    _, m, K = xs.shape
    if K != lanes or chunk < 1 or m % chunk:
        raise ValueError(f"{name}: shape {tuple(xs.shape)} does not fit lanes = {lanes}, "
                         f"chunk = {chunk}")


def _contig(*ts):
    return tuple(t.to(torch.int32).contiguous() for t in ts)


def _zeros(n: int, device) -> g1.JacobianPoints:
    """The scans' initial running sums: all-zero limbs, the identity (Z = 0)."""
    return g1.JacobianPoints(*(torch.zeros((_L, n), dtype=torch.int32, device=device)
                               for _ in range(3)))


def _stack(rows, shape):
    """Per-step (L, KV) points -> three (L, m, K) tensors in the chain layout."""
    return tuple(torch.stack([getattr(r, c) for r in rows], dim=1).reshape(shape) for c in "xyz")


def _madd_scan_plain(xs, ys, flags, chunk, combine):
    """The segmented scan of B4-B6: ``combine(acc, qx, qy, one)`` -> (points,
    exc or None) at every step, reset to the input point at every head."""
    L, m, K = xs.shape
    mv, kv = m // chunk, chunk * K
    xv, yv = xs.reshape(L, mv, kv), ys.reshape(L, mv, kv)
    fl = flags.reshape(mv, kv)
    one = fa.broadcast_const(FQ, 1, (kv,), device=xs.device)
    acc = _zeros(kv, xs.device)
    rows, excs = [], []
    for i in range(mv):
        qx, qy = xv[:, i], yv[:, i]
        reset = fl[i] != 0
        out, exc = combine(acc, qx, qy, one)
        acc = g1.select_points(reset, g1.JacobianPoints(qx, qy, one.expand_as(qx)), out)
        rows.append(acc)
        excs.append(exc)
    return _stack(rows, (L, m, K)), excs


def _madd(acc, qx, qy, one):
    return g1.madd(acc, qx, qy, one=one), None


# -- B4: serial chains -----------------------------------------------------------

def bucket_scan_serial_plain(xs: torch.Tensor, ys: torch.Tensor, flags: torch.Tensor):
    """Plain PyTorch version of B4: chain k (column k) scans rows j = 0..m-1
    with the complete mixed add, restarting at every head flag (the wide
    layout with chunk 1)."""
    return _madd_scan_plain(xs, ys, flags, 1, _madd)[0]


def bucket_scan_serial_kernel(xs: torch.Tensor, ys: torch.Tensor, flags: torch.Tensor,
                              team: int = SERIAL_TEAM):
    """One block of ``team`` threads per chain (``csrc/bucket_scan_serial.cu``);
    the team is cut to the power of two at or above m, since a thread with no
    rows only lengthens the carry scan."""
    L, m, K = xs.shape
    _build.check(xs, (_L, m, K), "bucket_scan_serial xs")
    _build.check(ys, (_L, m, K), "bucket_scan_serial ys")
    _build.check(flags, (1, m, K), "bucket_scan_serial flags")
    out = [torch.empty_like(xs) for _ in range(3)]
    if m and K:
        team = min(team, 1 << (m - 1).bit_length())
        fn = _build.entry("bucket_scan_serial", "bucket_scan_serial", 6, 3)
        _build.launch(fn, (xs, ys, flags, *out), (m, K, team), xs.device)
        bucket_scan_serial_kernel.launches += 1
    return tuple(out)


bucket_scan_serial_kernel.launches = 0


def bucket_scan_serial(xs: torch.Tensor, ys: torch.Tensor, flags: torch.Tensor,
                       lanes: int = LANES, chunk: int = CHUNK):
    """Serial-chain segmented inclusive scan (K chains of m steps).

    xs, ys: (L, m, K) sorted affine coordinates (Montgomery limbs); flags:
    (1, m, K) int32 segment-head markers. Returns (sx, sy, sz), (L, m, K)
    Jacobian scan values. Kernel B4 on a CUDA tensor, the plain version on a
    CPU tensor; B4 associates the additions otherwise than the plain serial
    walk, so its values are other representatives of the same points.
    ``lanes`` and ``chunk`` are the JAX signature's layout arguments; this
    layout checks only K == lanes."""
    if xs.shape[2] != lanes:
        raise ValueError(f"bucket_scan_serial: K = {xs.shape[2]} != lanes = {lanes}")
    if xs.device.type == "cpu":
        return bucket_scan_serial_plain(xs, ys, flags)
    return bucket_scan_serial_kernel(*_contig(xs, ys, flags))


# -- B5: wide chains, complete mixed add ----------------------------------------------

def bucket_scan_plain(xs: torch.Tensor, ys: torch.Tensor, flags: torch.Tensor, chunk: int):
    """Plain PyTorch version of B5: the segmented scan over chunk * K
    virtual chains with the complete mixed add."""
    return _madd_scan_plain(xs, ys, flags, chunk, _madd)[0]


def bucket_scan_kernel(xs: torch.Tensor, ys: torch.Tensor, flags: torch.Tensor, chunk: int):
    L, m, K = xs.shape
    _build.check(xs, (_L, m, K), "bucket_scan xs")
    _build.check(ys, (_L, m, K), "bucket_scan ys")
    _build.check(flags, (1, m, K), "bucket_scan flags")
    out = [torch.empty_like(xs) for _ in range(3)]
    if m and K:
        fn = _build.entry("bucket_scan", "bucket_scan", 6, 3)
        _build.launch(fn, (xs, ys, flags, *out), (m, K, chunk), xs.device)
        bucket_scan_kernel.launches += 1
    return tuple(out)


bucket_scan_kernel.launches = 0


def bucket_scan(xs: torch.Tensor, ys: torch.Tensor, flags: torch.Tensor,
                lanes: int = LANES, chunk: int = CHUNK):
    """Segmented inclusive scan of sorted affine points over chunk * K
    virtual chains (module docstring). xs, ys: (L, m, K) Montgomery limbs;
    flags: (1, m, K) int32 segment heads; m % chunk == 0. Returns (sx, sy,
    sz), (L, m, K) Jacobian scan values. Kernel B5 on a CUDA tensor, the
    plain version on a CPU tensor."""
    _check_layout("bucket_scan", xs, lanes, chunk)
    if xs.device.type == "cpu":
        return bucket_scan_plain(xs, ys, flags, chunk)
    return bucket_scan_kernel(*_contig(xs, ys, flags), chunk)


# -- B6: wide chains, incomplete mixed add and exception flag ------------------------

def bucket_scan_fast_plain(xs: torch.Tensor, ys: torch.Tensor, flags: torch.Tensor,
                           nonzero: torch.Tensor, chunk: int):
    """Plain PyTorch version of B6: B5's scan with ``g1.madd_incomplete``;
    exc (1, chunk, K) int32 is the OR over steps of exc & ~head & nonzero."""
    L, m, K = xs.shape
    mv, kv = m // chunk, chunk * K
    heads = flags.reshape(mv, kv) != 0
    live = ~heads & (nonzero.reshape(mv, kv) != 0)
    out, excs = _madd_scan_plain(
        xs, ys, flags, chunk, lambda acc, qx, qy, one: g1.madd_incomplete(acc, qx, qy, one=one))
    exc = (torch.stack(excs) & live).any(0)
    return out + (exc.to(torch.int32).reshape(1, chunk, K),)


def bucket_scan_fast_kernel(xs: torch.Tensor, ys: torch.Tensor, flags: torch.Tensor,
                            nonzero: torch.Tensor, chunk: int):
    L, m, K = xs.shape
    _build.check(xs, (_L, m, K), "bucket_scan_fast xs")
    _build.check(ys, (_L, m, K), "bucket_scan_fast ys")
    _build.check(flags, (1, m, K), "bucket_scan_fast flags")
    _build.check(nonzero, (1, m, K), "bucket_scan_fast nonzero")
    out = [torch.empty_like(xs) for _ in range(3)]
    exc = torch.zeros((1, chunk, K), dtype=torch.int32, device=xs.device)
    if m and K:
        fn = _build.entry("bucket_scan_fast", "bucket_scan_fast", 8, 3)
        _build.launch(fn, (xs, ys, flags, nonzero, *out, exc), (m, K, chunk), xs.device)
        bucket_scan_fast_kernel.launches += 1
    return tuple(out) + (exc,)


bucket_scan_fast_kernel.launches = 0


def bucket_scan_fast(xs: torch.Tensor, ys: torch.Tensor, flags: torch.Tensor,
                     nonzero: torch.Tensor, lanes: int = LANES, chunk: int = CHUNK):
    """Incomplete-add segmented scan: ``bucket_scan``'s contract plus
    ``nonzero`` ((1, m, K) int32, 1 where the position's bucket key is > 0)
    and a fourth output exc, (1, chunk, K) int32, nonzero in the chains that
    hit P == +-Q in a live bucket (their values are garbage: the caller
    reruns the complete engine). Kernel B6 on a CUDA tensor, the plain
    version on a CPU tensor."""
    _check_layout("bucket_scan_fast", xs, lanes, chunk)
    if xs.device.type == "cpu":
        return bucket_scan_fast_plain(xs, ys, flags, nonzero, chunk)
    return bucket_scan_fast_kernel(*_contig(xs, ys, flags, nonzero), chunk)


# -- B7: wide chains, complete Jacobian add, no segments ----------------------------

def jadd_scan_plain(xs: torch.Tensor, ys: torch.Tensor, zs: torch.Tensor, chunk: int):
    """Plain PyTorch version of B7: inclusive scan of Jacobian points over
    chunk * K virtual chains with the complete add, from the identity."""
    L, m, K = xs.shape
    mv, kv = m // chunk, chunk * K
    pts = [t.reshape(L, mv, kv) for t in (xs, ys, zs)]
    acc = _zeros(kv, xs.device)
    rows = []
    for i in range(mv):
        acc = g1.add(acc, g1.JacobianPoints(*(t[:, i] for t in pts)))
        rows.append(acc)
    return _stack(rows, (L, m, K))


def jadd_scan_kernel(xs: torch.Tensor, ys: torch.Tensor, zs: torch.Tensor, chunk: int):
    L, m, K = xs.shape
    for t, what in zip((xs, ys, zs), "xyz"):
        _build.check(t, (_L, m, K), f"jadd_scan {what}s")
    out = [torch.empty_like(xs) for _ in range(3)]
    if m and K:
        fn = _build.entry("jadd_scan", "jadd_scan", 6, 3)
        _build.launch(fn, (xs, ys, zs, *out), (m, K, chunk), xs.device)
        jadd_scan_kernel.launches += 1
    return tuple(out)


jadd_scan_kernel.launches = 0


def jadd_scan(xs: torch.Tensor, ys: torch.Tensor, zs: torch.Tensor,
              lanes: int = JADD_LANES, chunk: int = JADD_CHUNK):
    """Inclusive scan of (L, m, K) Jacobian points over chunk * K virtual
    chains (``bucket_scan``'s layout). Returns the per-position scan values,
    three (L, m, K) tensors. Kernel B7 on a CUDA tensor, the plain version on
    a CPU tensor."""
    _check_layout("jadd_scan", xs, lanes, chunk)
    if xs.device.type == "cpu":
        return jadd_scan_plain(xs, ys, zs, chunk)
    return jadd_scan_kernel(*_contig(xs, ys, zs), chunk)
