"""Distributed Pippenger MSM: the points sharded across the ranks, the
partial sums all-gathered and tree-reduced (the port of
``snarkos_tpu/parallel/msm_dist.py``, BASELINE config #3).

Each rank runs the generic windowed-bucket engine (``msm.msm_generic``) on
its shard, whatever the bases' z, as the JAX package does; the D width-1
partials are then all-gathered and reduced by the same pairwise tree on
every rank, so every rank returns the same point and the reduction's cost
does not grow with N.
"""

from __future__ import annotations

import torch

from snarkos_tpu_torch.ops import g1, msm
from snarkos_tpu_torch.parallel.mesh import Mesh, all_gather_last


def tree_reduce(group: msm.GroupOps, total: tuple) -> tuple:
    """A (.., D) batch of group elements summed to width 1 by the JAX
    package's tree: each level adds the lower half to the upper half, and
    an odd width's last element is carried, unadded, to the end of the next
    level."""
    width = total[0].shape[-1]
    while width > 1:
        half = width // 2
        summed = group.add(tuple(t[..., :half] for t in total),
                           tuple(t[..., half:2 * half] for t in total))
        if width % 2:
            total = tuple(torch.cat([s, t[..., 2 * half:width]], dim=-1)
                          for s, t in zip(summed, total))
            width = half + 1
        else:
            total = summed
            width = half
    return total


def msm_dist(points_local, scalar_local: torch.Tensor, mesh: Mesh, c: int = 0,
             group: msm.GroupOps | None = None):
    """This rank's (L, N/D) shard of the bases and (16, N/D) shard of the
    canonical Fr scalars -> the width-1 MSM over all N, the same on every
    rank. ``points_local`` is a ``g1.JacobianPoints`` (the result is one
    too) or, with another ``group``, a tuple of tensors (a tuple comes
    back). c = ``msm.default_window_bits(N/D)`` unless given; ``group=None``
    is BLS12-377 G1 on the mesh's device (kernels B2, B3 and B7 on the
    card)."""
    is_g1 = isinstance(points_local, g1.JacobianPoints)
    points = (points_local.x, points_local.y, points_local.z) if is_g1 else tuple(points_local)
    if group is None:
        group = msm.g1_group(mesh.device)
    if c == 0:
        c = msm.default_window_bits(scalar_local.shape[-1])
    partial = msm.msm_generic(group, points, scalar_local, c)
    total = tree_reduce(group, tuple(all_gather_last(mesh, t) for t in partial))
    return g1.JacobianPoints(*total) if is_g1 else total
