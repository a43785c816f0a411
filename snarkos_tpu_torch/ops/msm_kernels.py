"""Kernel B4, the serial-chain bucket scan of the MSM (the port of the
``bucket_scan_serial`` part of ``snarkos_tpu/ops/msm_pallas.py``).

The wide-chain scans B5 (``bucket_scan``), B6 (``bucket_scan_fast``) and B7
(``jadd_scan``) are not ported yet (ROADMAP.md, queue B).
"""

from __future__ import annotations

import torch

from snarkos_tpu_torch.ops import _build, g1
from snarkos_tpu_torch.ops import modarith as fa
from snarkos_tpu_torch.ops.fieldspec import FQ

_L = FQ.nlimbs

# Largest MSM (points x batch) that runs on the serial-chain engine; above
# it the JAX package switches to the wide-chain scan B5.
SERIAL_MAX_N = 1 << 15
LANES = 512


def bucket_scan_serial_plain(xs: torch.Tensor, ys: torch.Tensor, flags: torch.Tensor):
    """Plain PyTorch version of B4: chain k (column k) scans rows j = 0..m-1
    with the complete mixed add, restarting at every head flag."""
    _, m, K = xs.shape
    one = fa.broadcast_const(FQ, 1, (K,), device=xs.device)
    acc = g1.JacobianPoints(*(torch.zeros((_L, K), dtype=torch.int32, device=xs.device)
                              for _ in range(3)))
    rows = []
    for j in range(m):
        qx, qy = xs[:, j, :], ys[:, j, :]
        reset = flags[0, j, :] != 0
        out = g1.madd(acc, qx, qy, one=one)
        acc = g1.select_points(reset, g1.JacobianPoints(qx, qy, one.expand_as(qx)), out)
        rows.append(acc)
    return tuple(torch.stack([getattr(r, c) for r in rows], dim=1) for c in "xyz")


def bucket_scan_serial_kernel(xs: torch.Tensor, ys: torch.Tensor, flags: torch.Tensor):
    L, m, K = xs.shape
    _build.check(xs, (_L, m, K), "bucket_scan_serial xs")
    _build.check(ys, (_L, m, K), "bucket_scan_serial ys")
    _build.check(flags, (1, m, K), "bucket_scan_serial flags")
    out = [torch.empty_like(xs) for _ in range(3)]
    if m and K:
        fn = _build.entry("bucket_scan_serial", "bucket_scan_serial", 6, 2)
        _build.launch(fn, (xs, ys, flags, *out), (m, K), xs.device)
        bucket_scan_serial_kernel.launches += 1
    return tuple(out)


bucket_scan_serial_kernel.launches = 0


def bucket_scan_serial(xs: torch.Tensor, ys: torch.Tensor, flags: torch.Tensor,
                       lanes: int = LANES, chunk: int = 8):
    """Serial-chain segmented inclusive scan (K chains of m steps).

    xs, ys: (L, m, K) sorted affine coordinates (Montgomery limbs); flags:
    (1, m, K) int32 segment-head markers. Returns (sx, sy, sz), (L, m, K)
    Jacobian scan values. Kernel B4 on a CUDA tensor, the plain version on a
    CPU tensor. ``lanes`` and ``chunk`` are the JAX signature's layout
    arguments; this layout checks only K == lanes."""
    if xs.shape[2] != lanes:
        raise ValueError(f"bucket_scan_serial: K = {xs.shape[2]} != lanes = {lanes}")
    if xs.device.type == "cpu":
        return bucket_scan_serial_plain(xs, ys, flags)
    return bucket_scan_serial_kernel(*(t.to(torch.int32).contiguous() for t in (xs, ys, flags)))
