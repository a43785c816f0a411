"""The MSM's scan kernels, the port of ``snarkos_tpu/ops/msm_pallas.py``:
B4 the serial-chain bucket scan, B5 the wide-chain bucket scan, B6 its fast
variant with the incomplete add and an exception flag, B7 the weighted
bucket total of a window (the Jacobian scans of the TPU design and their
glue in one kernel).

Wide-chain layout (B5, B6): a (L, m, K) tensor holds KV = chunk * K
independent virtual chains of mv = m / chunk elements; chain l = r * K + k
(r < chunk) owns the contiguous sorted run [l * mv, (l + 1) * mv), and its
element i sits at row j = i * chunk + r, column k. Each plain version walks
the mv steps with one group operation over all KV lanes at once.

A CUDA tensor launches the kernel in ``csrc/``; a CPU tensor runs the plain
version.
"""

from __future__ import annotations

import torch

from snarkos_tpu_torch.ops import _build, g1, g1_kernels
from snarkos_tpu_torch.ops import modarith as fa
from snarkos_tpu_torch.ops.fieldspec import FQ

_L = FQ.nlimbs

# Largest MSM (points x batch) that runs on the serial-chain engine; above
# it the wide-chain scans take over.
SERIAL_MAX_N = 1 << 15
# threads that scan one serial chain together (B4's team; PERF.md has the
# sweep on the card)
SERIAL_TEAM = 64
# threads that scan one wide chain together in B6 (PERF.md has the sweep)
FAST_TEAM = 8
# threads that scan one wide chain together in B5 (PERF.md has the sweep)
SCAN_TEAM = 16
LANES = 512
CHUNK = 8
# B7's threads a block and buckets a thread (PERF.md has the sweep)
BUCKET_THREADS = 128
BUCKET_PER_THREAD = 1


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


def team_size(team: int, steps: int) -> int:
    """A scan team (B4-B6) cut to the power of two at or above a chain's
    ``steps`` elements: a thread with no elements only lengthens the carry
    scan."""
    return min(team, 1 << max(steps - 1, 0).bit_length())


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
    """One block of ``team`` threads per chain (``csrc/bucket_scan_serial.cu``),
    the team cut by ``team_size``."""
    L, m, K = xs.shape
    _build.check(xs, (_L, m, K), "bucket_scan_serial xs")
    _build.check(ys, (_L, m, K), "bucket_scan_serial ys")
    _build.check(flags, (1, m, K), "bucket_scan_serial flags")
    out = [torch.empty_like(xs) for _ in range(3)]
    if m and K:
        fn = _build.entry("bucket_scan_serial", "bucket_scan_serial", 6, 3)
        _build.launch(fn, (xs, ys, flags, *out), (m, K, team_size(team, m)), xs.device)
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


def bucket_scan_kernel(xs: torch.Tensor, ys: torch.Tensor, flags: torch.Tensor, chunk: int,
                       team: int = SCAN_TEAM):
    """A team of ``team`` threads per chain (``csrc/bucket_scan.cu``, B6's
    team body with the complete add, ``team_size``). Its values are other
    Jacobian representatives of the plain serial walk's points."""
    L, m, K = xs.shape
    _build.check(xs, (_L, m, K), "bucket_scan xs")
    _build.check(ys, (_L, m, K), "bucket_scan ys")
    _build.check(flags, (1, m, K), "bucket_scan flags")
    out = [torch.empty_like(xs) for _ in range(3)]
    if m and K:
        fn = _build.entry("bucket_scan", "bucket_scan", 6, 4)
        _build.launch(fn, (xs, ys, flags, *out), (m, K, chunk, team_size(team, m // chunk)),
                      xs.device)
        bucket_scan_kernel.launches += 1
    return tuple(out)


bucket_scan_kernel.launches = 0


def bucket_scan(xs: torch.Tensor, ys: torch.Tensor, flags: torch.Tensor,
                lanes: int = LANES, chunk: int = CHUNK):
    """Segmented inclusive scan of sorted affine points over chunk * K
    virtual chains (module docstring). xs, ys: (L, m, K) Montgomery limbs;
    flags: (1, m, K) int32 segment heads; m % chunk == 0. Returns (sx, sy,
    sz), (L, m, K) Jacobian scan values. Kernel B5 on a CUDA tensor, the
    plain version on a CPU tensor; B5 associates the additions otherwise
    than the plain serial walk, so its values are other representatives of
    the same points, at every position."""
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
                            nonzero: torch.Tensor, chunk: int, team: int = FAST_TEAM):
    """A team of ``team`` threads per chain (``csrc/bucket_scan_fast.cu``,
    ``team_size``). Its values are other Jacobian representatives than the
    plain serial walk's; exc is the same bit for bit."""
    L, m, K = xs.shape
    _build.check(xs, (_L, m, K), "bucket_scan_fast xs")
    _build.check(ys, (_L, m, K), "bucket_scan_fast ys")
    _build.check(flags, (1, m, K), "bucket_scan_fast flags")
    _build.check(nonzero, (1, m, K), "bucket_scan_fast nonzero")
    out = [torch.empty_like(xs) for _ in range(3)]
    exc = torch.zeros((1, chunk, K), dtype=torch.int32, device=xs.device)
    if m and K:
        fn = _build.entry("bucket_scan_fast", "bucket_scan_fast", 8, 4)
        _build.launch(fn, (xs, ys, flags, nonzero, *out, exc),
                      (m, K, chunk, team_size(team, m // chunk)), xs.device)
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
    version on a CPU tensor; B6 associates the additions otherwise than the
    plain serial walk, so at the positions of live buckets in unflagged
    chains its values are other representatives of the same points, and
    elsewhere they are don't-care. exc is the same."""
    _check_layout("bucket_scan_fast", xs, lanes, chunk)
    if xs.device.type == "cpu":
        return bucket_scan_fast_plain(xs, ys, flags, nonzero, chunk)
    return bucket_scan_fast_kernel(*_contig(xs, ys, flags, nonzero), chunk)


# -- B7: the weighted bucket total of a window ---------------------------------------

def tree_sum(vals, add, identity):
    """The sum over the trailing axis of a tuple of (.., w) tensors: the
    identity pads w to a power of two, then ceil(log2 w) rounds of ``add``
    halve it (``add`` and ``identity(n)`` a group's, on such tuples)."""
    w = vals[0].shape[-1]
    width = 1 << max(w - 1, 0).bit_length()
    cur = tuple(torch.cat([t, p], dim=-1) for t, p in zip(vals, identity(width - w)))
    while width > 1:
        width //= 2
        cur = add(tuple(t[..., :width] for t in cur), tuple(t[..., width:] for t in cur))
    return tuple(cur)


def _g1_add(a, b):
    out = g1.add(g1.JacobianPoints(*a), g1.JacobianPoints(*b))
    return (out.x, out.y, out.z)


def bucket_total_plain(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor):
    """Plain PyTorch version of B7 over (L, B) bucket sums S_0..S_{B-1}:
    the live buckets B-1..1 reversed, their inclusive Hillis-Steele scan at
    full width (``seg_prefix_plain`` with no heads) gives the suffixes
    suffix_b = sum_{i>=b} S_i, and a tree sum of those gives T_w =
    sum_{b>=1} b S_b. Returns (T_w, three (L, 1); suffixes, three (L, B),
    the identity at position 0)."""
    L, B = x.shape
    rev = tuple(t[:, 1:].flip(-1) for t in (x, y, z))
    flags = torch.zeros((1, B - 1), dtype=torch.int32, device=x.device)
    scan = g1_kernels.seg_prefix_plain((flags,) + rev)[1:]
    suffix = tuple(torch.cat([torch.zeros((L, 1), dtype=t.dtype, device=t.device), t.flip(-1)],
                             dim=-1) for t in scan)
    return tree_sum(suffix, _g1_add, lambda n: tuple(
        torch.zeros((L, n), dtype=torch.int32, device=x.device) for _ in range(3))), suffix


def bucket_total_kernel(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                        threads: int = BUCKET_THREADS, per_thread: int = BUCKET_PER_THREAD,
                        scan_out: bool = False):
    """One cooperative launch of ``csrc/jadd_scan.cu`` (blocks of
    ``threads``, ``per_thread`` buckets a thread, more where the co-resident
    blocks need it). Returns T_w, three (L, 1); with ``scan_out`` also the
    suffixes, three (L, B), as ``bucket_total_plain``. Its values are other
    Jacobian representatives of the plain version's points."""
    B = x.shape[-1]
    for t, what in zip((x, y, z), "xyz"):
        _build.check(t, (_L, B), f"bucket_total {what}")
    out = tuple(torch.empty((_L, 1), dtype=torch.int32, device=x.device) for _ in range(3))
    suffix = tuple(torch.empty_like(x) for _ in range(3)) if scan_out else (None,) * 3
    blocks = -(-(B - 1) // (threads * per_thread))
    scratch = torch.empty(2 * 36 * blocks, dtype=torch.int32, device=x.device)
    fn = _build.entry("jadd_scan", "jadd_bucket_total", 10, 3)
    _build.launch(fn, (x, y, z, *out, *suffix, scratch), (B, threads, per_thread), x.device)
    bucket_total_kernel.launches += 1
    return (out, suffix) if scan_out else out


bucket_total_kernel.launches = 0


def bucket_total(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor):
    """T_w = sum_{b>=1} b S_b of a window's bucket sums x, y, z ((L, B)
    Jacobian Montgomery limbs; identities anywhere). Returns three (L, 1)
    tensors: kernel B7 on a CUDA tensor, the plain version on a CPU tensor
    (other Jacobian representatives of the same point)."""
    if x.dim() != 2 or not x.shape == y.shape == z.shape:
        raise ValueError(f"bucket_total: shapes {tuple(x.shape)}, {tuple(y.shape)}, "
                         f"{tuple(z.shape)}; want three (L, B)")
    if x.device.type == "cpu":
        return bucket_total_plain(x, y, z)[0]
    return bucket_total_kernel(*_contig(x, y, z))
