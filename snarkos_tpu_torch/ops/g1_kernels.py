"""Kernels B2 (complete G1 add) and B3 (segmented-scan combine), the port
of ``snarkos_tpu/ops/g1_pallas.py``.

A CUDA tensor launches ``csrc/g1_add.cu`` / ``csrc/seg_combine.cu``; a CPU
tensor runs the plain version: ``g1.add`` for B2, ``seg_combine_plain`` for
B3. Coordinates are (24, N) int32 Montgomery limb tensors, flags (1, N) int32.
"""

from __future__ import annotations

import torch

from snarkos_tpu_torch.ops import _build, g1
from snarkos_tpu_torch.ops.fieldspec import FQ

_L = FQ.nlimbs


def seg_combine_plain(a, b):
    """Plain PyTorch version of B3: a, b are (flag (1, N), x, y, z) tuples;
    the result is b where b is a segment head, else a + b; flag fa | fb."""
    fa_, ax, ay, az = a
    fb_, bx, by, bz = b
    pb = g1.JacobianPoints(bx, by, bz)
    s = g1.add(g1.JacobianPoints(ax, ay, az), pb)
    out = g1.select_points(fb_[0] != 0, pb, s)
    return (fa_ | fb_, out.x, out.y, out.z)


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


def seg_combine_kernel(a, b):
    n = a[1].shape[-1]
    for t, what in zip(a + b, ("fa", "ax", "ay", "az", "fb", "bx", "by", "bz")):
        _build.check(t, (1 if what[0] == "f" else _L, n), f"seg_combine {what}")
    out = [torch.empty_like(a[0])] + [torch.empty_like(a[1]) for _ in range(3)]
    if n:
        fn = _build.entry("seg_combine", "seg_combine", 12, 1)
        _build.launch(fn, (*a, *b, *out), (n,), a[1].device)
        seg_combine_kernel.launches += 1
    return tuple(out)


seg_combine_kernel.launches = 0


def _contig(*ts):
    return tuple(t.to(torch.int32).contiguous() for t in ts)


def add(pa: g1.JacobianPoints, pb: g1.JacobianPoints) -> g1.JacobianPoints:
    """Complete Jacobian add over (L, N) coordinate batches: kernel B2 on a
    CUDA tensor, the plain version on a CPU tensor."""
    if pa.x.device.type == "cpu":
        return g1.add(pa, pb)
    return add_kernel(g1.JacobianPoints(*_contig(pa.x, pa.y, pa.z)),
                      g1.JacobianPoints(*_contig(pb.x, pb.y, pb.z)))


def seg_combine(a, b):
    """Segmented-sum combine of (flag, x, y, z) tuples: kernel B3 on a CUDA
    tensor, the plain version on a CPU tensor."""
    if a[1].device.type == "cpu":
        return seg_combine_plain(a, b)
    n = a[1].shape[-1]
    fa_, fb_ = (f.expand(1, n) for f in (a[0], b[0]))
    return seg_combine_kernel(_contig(fa_, *a[1:]), _contig(fb_, *b[1:]))
