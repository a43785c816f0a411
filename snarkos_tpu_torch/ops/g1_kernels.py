"""Kernels B2 (complete G1 add) and B3 (segmented prefix scan), the port of
``snarkos_tpu/ops/g1_pallas.py``.

A CUDA tensor launches ``csrc/g1_add.cu`` / ``csrc/seg_prefix.cu``; a CPU
tensor runs the plain version: ``g1.add`` for B2, ``seg_prefix_plain`` for
B3. Coordinates are (24, N) int32 Montgomery limb tensors, flags (1, N) int32.

B2 has two more entry points, the compositions of the add that the MSM's
window loop runs: ``horner`` (acc = 2^c acc + t) and ``bucket_fixup`` (the
window's bucket sums from the scan outputs and the chain carries), each one
launch giving the limbs of its plain version (``horner_plain``,
``bucket_fixup_plain``), which composes ``g1.add`` calls.

The TPU kernel B3 is the one-round operator ``seg_combine``, launched once
per Hillis-Steele round by the MSM's prefix scans. Here B3 runs the whole
prefix in one launch (``seg_prefix``), round for round the same function;
``seg_combine_plain`` stays as the plain round operator.
"""

from __future__ import annotations

import torch

from snarkos_tpu_torch.ops import _build, g1
from snarkos_tpu_torch.ops.fieldspec import FQ

_L = FQ.nlimbs


def seg_combine_plain(a, b):
    """The segmented-scan operator: a, b are (flag (1, N), x, y, z) tuples;
    the result is b where b is a segment head, else a + b; flag fa | fb."""
    fa_, ax, ay, az = a
    fb_, bx, by, bz = b
    pb = g1.JacobianPoints(bx, by, bz)
    s = g1.add(g1.JacobianPoints(ax, ay, az), pb)
    out = g1.select_points(fb_[0] != 0, pb, s)
    return (fa_ | fb_, out.x, out.y, out.z)


def prefix_steps(width: int) -> int:
    """Hillis-Steele rounds of a width-``width`` prefix: ceil(log2(width)),
    at least 1."""
    return max(width - 1, 1).bit_length()


def seg_prefix_plain(state):
    """Plain PyTorch version of B3: the inclusive segmented prefix of a
    (flag (1, N), x, y, z) tuple over N lanes by Hillis-Steele. In round i,
    at distance d = 2^i, lane e >= d becomes ``seg_combine_plain(lane e - d,
    lane e)`` of the previous round; lanes e < d keep their value."""
    cur = tuple(state)
    width = cur[1].shape[-1]
    for i in range(prefix_steps(width)):
        d = 1 << i
        if d >= width:
            continue
        comb = seg_combine_plain(tuple(t[..., :width - d] for t in cur),
                                 tuple(t[..., d:] for t in cur))
        cur = tuple(torch.cat([t[..., :d], c], dim=-1) for t, c in zip(cur, comb))
    return cur


def add_kernel(pa: g1.JacobianPoints, pb: g1.JacobianPoints) -> g1.JacobianPoints:
    n = pa.x.shape[-1]
    for t, what in zip((pa.x, pa.y, pa.z, pb.x, pb.y, pb.z), ("ax", "ay", "az", "bx", "by", "bz")):
        _build.check(t, (_L, n), f"g1 add {what}")
    out = [torch.empty_like(pa.x) for _ in range(3)]
    if n:
        fn = _build.entry("g1_add", "g1_add", 9, 1)
        _build.launch(fn, (pa.x, pa.y, pa.z, pb.x, pb.y, pb.z, *out), (n,), pa.x.device)
        add_kernel.launches += 1
    return g1.JacobianPoints(*out)


add_kernel.launches = 0


def horner_plain(acc: g1.JacobianPoints, t: g1.JacobianPoints, c: int) -> g1.JacobianPoints:
    """Plain version of ``horner``: c times ``g1.add(acc, acc)``, then
    ``g1.add(acc, t)``. The self-add doubles a finite lane and keeps an
    identity lane's limbs, so only the doubling is computed."""
    for _ in range(c):
        acc = g1.select_points(g1.is_infinity(acc), acc, g1.double(acc))
    return g1.add(acc, t)


def horner_kernel(acc: g1.JacobianPoints, t: g1.JacobianPoints, c: int) -> g1.JacobianPoints:
    n = acc.x.shape[-1]
    for v, what in zip((acc.x, acc.y, acc.z, t.x, t.y, t.z),
                       ("acc x", "acc y", "acc z", "t x", "t y", "t z")):
        _build.check(v, (_L, n), f"g1 horner {what}")
    out = [torch.empty_like(acc.x) for _ in range(3)]
    if n:
        fn = _build.entry("g1_add", "g1_horner", 9, 2)
        _build.launch(fn, (acc.x, acc.y, acc.z, t.x, t.y, t.z, *out), (n, c), acc.x.device)
        horner_kernel.launches += 1
    return g1.JacobianPoints(*out)


horner_kernel.launches = 0


def bucket_fixup_plain(scan, flat, carry, chain_of, needs_carry, live) -> g1.JacobianPoints:
    """Plain version of ``bucket_fixup``: the gathers, add and selects of the
    window's bucket sums, as g1 functions."""
    tails = g1.JacobianPoints(*(t.reshape(t.shape[0], -1)[:, flat] for t in scan))
    carry_at = g1.JacobianPoints(*(t[:, chain_of] for t in carry))
    sums = g1.select_points(needs_carry, g1.add(tails, carry_at), tails)
    return g1.select_points(live, sums, g1.infinity(flat.shape, device=flat.device))


def bucket_fixup_kernel(scan, flat, carry, chain_of, needs_carry, live) -> g1.JacobianPoints:
    ns = scan[0].numel() // _L
    nc = carry[0].shape[-1]
    nb = flat.shape[0]
    for v, what in zip(scan, "xyz"):
        _build.check(v, (_L,) + tuple(v.shape[1:]), f"bucket_fixup scan {what}")
    for v, what in zip(carry, "xyz"):
        _build.check(v, (_L, nc), f"bucket_fixup carry {what}")
    _build.check(flat, (nb,), "bucket_fixup flat", torch.int64)
    _build.check(chain_of, (nb,), "bucket_fixup chain_of", torch.int64)
    _build.check(needs_carry, (nb,), "bucket_fixup needs_carry", torch.bool)
    _build.check(live, (nb,), "bucket_fixup live", torch.bool)
    out = [torch.empty((_L, nb), dtype=torch.int32, device=flat.device) for _ in range(3)]
    if nb:
        fn = _build.entry("g1_add", "g1_bucket_fixup", 13, 3)
        _build.launch(fn, (*scan, *carry, flat, chain_of, needs_carry, live, *out),
                      (ns, nc, nb), flat.device)
        bucket_fixup_kernel.launches += 1
    return g1.JacobianPoints(*out)


bucket_fixup_kernel.launches = 0


def seg_prefix_kernel(flags, x, y, z):
    """One cooperative launch of ``csrc/seg_prefix.cu`` over (1, n) flags and
    (24, n) coordinates; the rounds ping-pong between the outputs and a
    scratch copy of the same size."""
    n = x.shape[-1]
    for t, what in zip((flags, x, y, z), ("flags", "x", "y", "z")):
        _build.check(t, (1 if what == "flags" else _L, n), f"seg_prefix {what}")
    out = [torch.empty_like(flags)] + [torch.empty_like(x) for _ in range(3)]
    if n:
        scratch = [torch.empty_like(flags)] + [torch.empty_like(x) for _ in range(3)]
        fn = _build.entry("seg_prefix", "seg_prefix", 12, 2)
        _build.launch(fn, (flags, x, y, z, *out, *scratch), (n, prefix_steps(n)), x.device)
        seg_prefix_kernel.launches += 1
    return tuple(out)


seg_prefix_kernel.launches = 0


def _contig(*ts):
    return tuple(t.to(torch.int32).contiguous() for t in ts)


def _contig_points(p: g1.JacobianPoints) -> g1.JacobianPoints:
    return g1.JacobianPoints(*_contig(p.x, p.y, p.z))


def add(pa: g1.JacobianPoints, pb: g1.JacobianPoints) -> g1.JacobianPoints:
    """Complete Jacobian add over (L, N) coordinate batches: kernel B2 on a
    CUDA tensor, the plain version on a CPU tensor."""
    if pa.x.device.type == "cpu":
        return g1.add(pa, pb)
    return add_kernel(_contig_points(pa), _contig_points(pb))


def horner(acc: g1.JacobianPoints, t: g1.JacobianPoints, c: int) -> g1.JacobianPoints:
    """acc = 2^c acc + t over (L, N) batches, the Horner step of the MSM's
    window loop: B2's ``g1_horner`` on a CUDA tensor (one launch for the
    c + 1 adds), the plain version on a CPU tensor."""
    if acc.x.device.type == "cpu":
        return horner_plain(acc, t, c)
    return horner_kernel(_contig_points(acc), _contig_points(t), c)


def bucket_fixup(scan, flat, carry, chain_of, needs_carry, live) -> g1.JacobianPoints:
    """A window's bucket sums (width nb): the scan value at ``flat`` (scan:
    (x, y, z) outputs of a bucket scan, (L, ...) with flat positions over the
    trailing axes), plus ``carry`` (x, y, z), (L, KV), at ``chain_of`` where
    ``needs_carry``, and the identity where not ``live``. flat, chain_of:
    (nb,) int64; needs_carry, live: (nb,) bool. B2's ``g1_bucket_fixup`` on a
    CUDA tensor, the plain version on a CPU tensor."""
    if flat.device.type == "cpu":
        return bucket_fixup_plain(scan, flat, carry, chain_of, needs_carry, live)
    return bucket_fixup_kernel(_contig(*scan), flat.long().contiguous(), _contig(*carry),
                               chain_of.long().contiguous(), needs_carry.bool().contiguous(),
                               live.bool().contiguous())


def seg_prefix(state):
    """Inclusive segmented prefix scan of a (flag (1, N), x, y, z) tuple of
    head flags and Jacobian points: kernel B3 on a CUDA tensor, the plain
    version on a CPU tensor."""
    flags, x, y, z = state
    if x.device.type == "cpu":
        return seg_prefix_plain(state)
    return seg_prefix_kernel(*_contig(flags.expand(1, x.shape[-1]), x, y, z))
