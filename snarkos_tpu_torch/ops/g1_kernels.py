"""Kernels B2 (complete G1 add) and B3 (segmented prefix scan), the port of
``snarkos_tpu/ops/g1_pallas.py``.

A CUDA tensor launches ``csrc/g1_add.cu`` / ``csrc/seg_prefix.cu`` /
``csrc/lane_scan.cu``; a CPU tensor runs the plain version: ``g1.add`` for
B2, ``seg_prefix_plain`` for B3. Coordinates are (24, N) int32 Montgomery
limb tensors, flags (1, N) int32.

B2 has two more entry points, the compositions of the add that the MSM's
window loop runs: ``horner`` (acc = 2^c acc + t) and ``bucket_fixup`` (the
window's bucket sums from the scan outputs and the chain carries), each one
launch giving the limbs of its plain version (``horner_plain``,
``bucket_fixup_plain``), which composes ``g1.add`` calls.

The TPU kernel B3 is the one-round operator ``seg_combine``, launched once
per Hillis-Steele round by the MSM's prefix scans. Here B3 runs the whole
prefix in one launch (``seg_prefix``), round for round the same function;
``seg_combine_plain`` stays as the plain round operator.

The generic MSM engine's chunked segmented scan (K lanes of m consecutive
elements) runs B3's operator 2 m times a window in the JAX package. Here it
is two launches of ``csrc/lane_scan.cu`` around one B3 prefix of the lane
aggregates: ``lane_scan`` (every lane's own scan from the identity, its
aggregate and first head; a team of threads a lane) and ``lane_carry`` (the
carry into each lane added where the lane's first run continues one from
earlier lanes). Their plain versions are ``lane_scan_plain`` (the JAX
engine's first pass, keeping every step) and ``lane_carry_plain``.
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


def lane_scan_plain(flags, x, y, z, K: int):
    """Plain version of ``lane_scan``: lane k of the N = K m positions owns
    [k m, (k+1) m); its segmented scan from (flag 0, the identity) with
    ``seg_combine_plain``, m steps at width K as the JAX engine's first pass
    runs them. Returns (x, y, z) (24, N) lane-local values at every position,
    the aggregates (flag (1, K) int32, the OR of the lane's heads; x, y, z
    (24, K), the value at its last position) and first_head (K,) int32, the
    index of the lane's first head, m if it has none."""
    n = x.shape[-1]
    m = n // K
    f3 = flags.reshape(K, m)
    p3 = tuple(t.reshape(_L, K, m) for t in (x, y, z))
    inf = g1.infinity((K,), device=x.device)
    state = (torch.zeros((1, K), dtype=torch.int32, device=x.device), inf.x, inf.y, inf.z)
    steps = []
    for j in range(m):
        state = seg_combine_plain(state, (f3[:, j].unsqueeze(0),) + tuple(p[:, :, j] for p in p3))
        steps.append(state[1:])
    out = tuple(torch.stack([st[i] for st in steps], dim=-1).reshape(_L, n) for i in range(3))
    heads = f3 != 0
    first = torch.where(heads.any(1), heads.int().argmax(1), m).to(torch.int32)
    return (*out, *state, first)


def lane_scan_kernel(flags, x, y, z, K: int, team: int):
    """One launch of ``csrc/lane_scan.cu``'s ``g1_lane_scan``: a team of
    ``team`` threads a lane (a power of two up to 256; members past the
    lane's end hold no elements). Its values are other Jacobian
    representatives of the plain version's points; the aggregate flags and
    first heads are exact."""
    n = x.shape[-1]
    if K < 1 or n % K:
        raise ValueError(f"lane_scan: {n} positions are not a multiple of {K} lanes")
    if team < 1 or team > 256 or team & (team - 1):
        raise ValueError(f"lane_scan: team {team} is not a power of two up to 256")
    _build.check(flags, (1, n), "lane_scan flags")
    for t, what in zip((x, y, z), "xyz"):
        _build.check(t, (_L, n), f"lane_scan {what}")
    out = [torch.empty_like(x) for _ in range(3)]
    agg = [torch.empty((1, K), dtype=torch.int32, device=x.device)] + [
        torch.empty((_L, K), dtype=torch.int32, device=x.device) for _ in range(3)]
    first = torch.empty(K, dtype=torch.int32, device=x.device)
    if n:
        fn = _build.entry("lane_scan", "g1_lane_scan", 12, 3)
        _build.launch(fn, (flags, x, y, z, *out, *agg, first), (n // K, K, team), x.device)
        lane_scan_kernel.launches += 1
    return (*out, *agg, first)


lane_scan_kernel.launches = 0


def lane_carry_plain(ox, oy, oz, sx, sy, sz, first_head, m: int):
    """Plain version of ``lane_carry``: at each position e of lane k = e // m
    >= 1 with e - k m < first_head[k], ``g1.add(carry, local)`` with the
    carry (sx, sy, sz)[k - 1] (the inclusive prefix of the lane aggregates);
    every other position as it is. Returns new tensors."""
    n = ox.shape[-1]
    pos = torch.arange(n, device=ox.device)
    lane = pos // m
    idx = ((lane > 0) & (pos - lane * m < first_head.long()[lane])).nonzero().squeeze(1)
    carry = g1.JacobianPoints(*(s[:, lane[idx] - 1] for s in (sx, sy, sz)))
    summed = g1.add(carry, g1.JacobianPoints(*(o[:, idx] for o in (ox, oy, oz))))
    out = [o.clone() for o in (ox, oy, oz)]
    for o, v in zip(out, (summed.x, summed.y, summed.z)):
        o[:, idx] = v
    return tuple(out)


def lane_carry_kernel(ox, oy, oz, sx, sy, sz, first_head, m: int):
    """One launch of ``csrc/lane_scan.cu``'s ``g1_lane_carry``, updating
    (ox, oy, oz) in place (they are returned); limb for limb the plain
    version."""
    n = ox.shape[-1]
    if m < 1 or n % m:
        raise ValueError(f"lane_carry: {n} positions are not a multiple of lanes of {m}")
    K = n // m
    for t, what in zip((ox, oy, oz), "xyz"):
        _build.check(t, (_L, n), f"lane_carry {what}")
    for t, what in zip((sx, sy, sz), "xyz"):
        _build.check(t, (_L, K), f"lane_carry prefix {what}")
    _build.check(first_head, (K,), "lane_carry first_head")
    if n:
        fn = _build.entry("lane_scan", "g1_lane_carry", 7, 2)
        _build.launch(fn, (ox, oy, oz, sx, sy, sz, first_head), (m, K), ox.device)
        lane_carry_kernel.launches += 1
    return ox, oy, oz


lane_carry_kernel.launches = 0


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


def lane_scan(flags, x, y, z, K: int, team: int):
    """Every lane's own segmented scan (module docstring): flags (1, N), x,
    y, z (24, N), N = K m. Returns (x, y, z) at every position, the lane
    aggregates (flag (1, K), x, y, z (24, K)) and first_head (K,).
    ``g1_lane_scan`` on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return lane_scan_plain(flags, x, y, z, K)
    return lane_scan_kernel(*_contig(flags, x, y, z), K, team)


def lane_carry(ox, oy, oz, sx, sy, sz, first_head, m: int):
    """The carry into each lane (sx, sy, sz: the inclusive prefix of the
    lane aggregates) added to the lane-local values where the lane's first
    run continues one from earlier lanes. ``g1_lane_carry`` on a CUDA tensor
    (in place), the plain version on a CPU tensor."""
    if ox.device.type == "cpu":
        return lane_carry_plain(ox, oy, oz, sx, sy, sz, first_head, m)
    return lane_carry_kernel(*_contig(ox, oy, oz, sx, sy, sz, first_head), m)
