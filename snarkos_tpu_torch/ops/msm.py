"""Pippenger multi-scalar multiplication, the fused signed-window engine on
its serial-chain path (the port of ``snarkos_tpu/ops/msm.py``).

Per c-bit signed window, high to low (Horner):
  1. packed signed digits -> per-element bucket (+ per-batch offset) and sign
  2. stable sort by bucket; gather the points into the chain layout
     (chain k owns the sorted run [k m, (k+1) m), m = n / K)
  3. per-chain serial segmented scan of the sorted affine points (kernel B4)
  4. cross-chain carries: Hillis-Steele segmented prefix over the K chain
     finals (kernel B3)
  5. bucket sums = scan values at each bucket's last position, plus the carry
     where a bucket's run starts in an earlier chain (kernel B2)
  6. T_w = sum_b b S_b as (suffix of suffix)[1], per batch (kernel B3)
  7. acc = 2^c acc + T_w (kernel B2)

The group and the scan are injectable (``group``/``scan_fn``) so the
combinatorics are testable with a cheap mock group on the CPU; the G1 group
runs kernels B2-B4 on the card and their plain versions on the CPU.

Not ported yet (ROADMAP.md, queue B): the wide-chain scan B5 (n >
SERIAL_MAX_N), the large single MSM's fast scan B6 and its bucket-total scan
B7 (``_weighted_bucket_total``), and the generic engine for non-affine bases.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from snarkos_tpu_torch.ops import g1, g1_kernels, msm_kernels
from snarkos_tpu_torch.ops import modarith as fa
from snarkos_tpu_torch.ops.fieldspec import FQ

SCALAR_BITS = 253

_B5 = ("the wide-chain bucket scan B5 (msm_pallas.bucket_scan) is not ported yet; "
       "see ROADMAP.md, queue B")


@dataclass(frozen=True)
class GroupOps:
    """Abelian group elements as tuples of tensors with trailing axis N."""

    identity: Callable[[int], Any]
    add: Callable[[Any, Any], Any]  # complete, branchless
    select: Callable[[torch.Tensor, Any, Any], Any]  # mask (n,) ? a : b
    seg_combine: Callable[[Any, Any], Any] | None = None  # fused (flag,)+elem


def _default_seg_combine(group: GroupOps):
    def combine(a, b):
        fa_, pa = a[0], a[1:]
        fb_, pb = b[0], b[1:]
        s = group.add(pa, pb)
        out = group.select(fb_[0, :] != 0, pb, s)
        return (fa_ | fb_,) + tuple(out)

    return combine


def g1_group(device) -> GroupOps:
    """BLS12-377 G1 in Jacobian coordinates: kernels B2 (add) and B3
    (seg_combine) on the card, their plain versions on the CPU."""

    def identity(n):
        p = g1.infinity((n,), device=device)
        return (p.x, p.y, p.z)

    def add(a, b):
        out = g1_kernels.add(g1.JacobianPoints(*a), g1.JacobianPoints(*b))
        return (out.x, out.y, out.z)

    def select(mask, a, b):
        return tuple(torch.where(mask.unsqueeze(0), x, y) for x, y in zip(a, b))

    return GroupOps(identity=identity, add=add, select=select,
                    seg_combine=g1_kernels.seg_combine)


# --------------------------------------------------------------------------
# scalar digit decomposition
# --------------------------------------------------------------------------


def window_digits(scalar_limbs: torch.Tensor, c: int, num_windows: int | None = None):
    """(16, N) canonical Fr limbs -> (W, N) c-bit window digits (LSB window
    first)."""
    limbs = scalar_limbs.long()
    nlimbs = limbs.shape[0]
    if num_windows is None:
        num_windows = -(-SCALAR_BITS // c)
    rows = []
    mask = (1 << c) - 1
    for w in range(num_windows):
        off = w * c
        k, sh = off // 16, off % 16
        d = limbs[k] >> sh
        bits_have = 16 - sh
        while bits_have < c and k + 1 < nlimbs:
            k += 1
            d = d | (limbs[k] << bits_have)
            bits_have += 16
        rows.append(d & mask)
    return torch.stack(rows).to(torch.int32)


def signed_window_digits(scalar_limbs: torch.Tensor, c: int) -> torch.Tensor:
    """(16, N) canonical Fr limbs -> (W, N) PACKED signed window digits:
    ``bucket | (sign << 16)`` with bucket in [0, 2^(c-1)], the digit
    (-1)^sign * bucket, and sum_w digit_w 2^(c w) the scalar. W =
    ceil(254 / c), so the final borrow is absorbed by the top window."""
    half = 1 << (c - 1)
    full = 1 << c
    num_windows = -(-(SCALAR_BITS + 1) // c)
    raw = window_digits(scalar_limbs, c, num_windows)
    carry = torch.zeros_like(raw[0])
    packed = []
    for d in raw:
        t = d + carry
        wrap = t > half
        bucket = torch.where(wrap, full - t, t)
        carry = wrap.to(torch.int32)
        packed.append(bucket | (carry << 16))
    return torch.stack(packed)


def fused_window_bits(n: int) -> int:
    """Window size for the signed fused engine: scan work scales with
    W = ceil(254/c) while the bucket phase scales with 2^(c-1)."""
    return max(4, min(16, n.bit_length() - 7))


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------


def _hillis_steele_prefix(seg, group: GroupOps, state, width: int, nelems: int):
    """Inclusive segmented PREFIX scan over the trailing axis via
    Hillis-Steele: ceil(log2(width)) rounds of ``seg`` at full width.

    state: (flags, *pts) tuple; nelems = len(pts)."""
    device = state[0].device
    lane_ids = torch.arange(width, device=device).unsqueeze(0)
    steps = max(width - 1, 1).bit_length()
    pad_pts1 = group.identity(1)
    cur = tuple(state)
    for i in range(steps):
        d = 1 << i
        pad_lane = lane_ids < d
        shifted_flag = torch.where(pad_lane, 1, torch.roll(cur[0], d, dims=-1)).to(cur[0].dtype)
        shifted_pts = tuple(
            torch.where(pad_lane, pad_pts1[k], torch.roll(cur[1 + k], d, dims=-1))
            for k in range(nelems))
        combined = seg((shifted_flag,) + shifted_pts, cur)
        cur = tuple(torch.where(pad_lane, old, new) for old, new in zip(cur, combined))
    return cur


def chain_layout(x, ycat, packed, lanes: int, batch_off=None):
    """One window's sort and relayout. packed: (N,) packed signed digits;
    batch_off: (N,) per-element bucket offsets of a multi-MSM, or None.
    Returns (keys (N,) sorted buckets, xs and ys (L, m, K) chain-major
    sorted affine coordinates with the digit signs applied, heads (m, K)
    segment-head flags), where position (j, k) holds sorted element k m + j."""
    L, n = x.shape
    K = lanes
    m = n // K
    device = x.device
    packed = packed.long()
    bucket = packed & 0xFFFF
    if batch_off is not None:
        bucket = bucket + batch_off
    sign = packed >> 16
    keys, order = torch.sort(bucket, stable=True)
    src_flat = (torch.arange(K, device=device).unsqueeze(0) * m
                + torch.arange(m, device=device).unsqueeze(1)).reshape(-1)
    perm2 = order[src_flat]
    xs = x[:, perm2].reshape(L, m, K)
    ys = ycat[:, perm2 + sign[perm2] * n].reshape(L, m, K)
    head = torch.cat([torch.ones(1, dtype=torch.int32, device=device),
                      (keys[1:] != keys[:-1]).to(torch.int32)])
    return keys, xs, ys, head[src_flat].reshape(m, K)


def _fused_msm_body(x, ycat, packed_digits, c: int, lanes: int, chunk: int,
                    group: GroupOps | None = None, scan_fn=None, serial: bool = True,
                    nbatch: int = 1):
    """Window loop of the fused engine. x: (L, N) affine x; ycat: (L, 2N)
    [y | -y]; packed_digits: (W, N). Returns the width-nbatch (x, y, z)
    accumulator tuple.

    Chains are the K = ``lanes`` columns (``serial=True``, the only layout
    ported): chain k owns the sorted run [k m, (k+1) m), m = N / K.
    ``nbatch > 1`` runs a MULTI-MSM: the input holds nbatch consecutive
    segments of N / nbatch elements (same base, different scalars); digits
    are offset into per-batch bucket ranges [i B, (i+1) B) so one sort and
    one scan accumulate every batch, and the bucket-total suffix scans run
    segmented per batch."""
    if not serial:
        raise NotImplementedError(_B5)
    L, n = x.shape
    device = x.device
    K = lanes
    m = n // K
    B = (1 << (c - 1)) + 1
    B_total = nbatch * B
    nper = n // nbatch
    batch_off = (torch.arange(n, device=device) // nper) * B if nbatch > 1 else None
    seg_flags = ((torch.arange(B_total, device=device) % B == 0)
                 .to(torch.int32).unsqueeze(0) if nbatch > 1 else None)
    if group is None:
        group = g1_group(device)
        if B >= (1 << 11) and nbatch == 1:
            raise NotImplementedError(
                "the chunked bucket total (B7, msm_pallas.jadd_scan) is not ported yet; "
                "see ROADMAP.md, queue B")
    if scan_fn is None:
        scan_fn = msm_kernels.bucket_scan_serial
    seg = group.seg_combine or _default_seg_combine(group)
    bucket_ids = torch.arange(B_total, device=device)

    def plain_add_scan_reverse(vals):
        rev = tuple(t.flip(-1) for t in vals)
        flags = (seg_flags if nbatch > 1
                 else torch.zeros((1, B_total), dtype=torch.int32, device=device))
        cur = _hillis_steele_prefix(seg, group, (flags,) + rev, B_total, len(vals))
        return tuple(t.flip(-1) for t in cur[1:])

    acc = group.identity(nbatch)
    for w in range(packed_digits.shape[0] - 1, -1, -1):
        keys, xs, ys, heads_lane = chain_layout(x, ycat, packed_digits[w], K, batch_off)
        sx, sy, sz = scan_fn(xs, ys, heads_lane.unsqueeze(0), K, chunk)

        # cross-chain carries: inclusive segmented scan of the chain finals
        chain_flag = heads_lane.max(0).values.unsqueeze(0)
        finals = (sx[:, -1, :], sy[:, -1, :], sz[:, -1, :])
        summ = _hillis_steele_prefix(seg, group, (chain_flag,) + finals, K, 3)
        ident1 = group.identity(1)
        carry_in = tuple(torch.cat([ident1[i], summ[1 + i][..., :-1]], dim=-1)
                         for i in range(3))  # carry INTO chain k

        # bucket sums = scan values at each bucket's last occurrence, plus
        # the chain carry when the bucket's run extends past a chain start
        pos = torch.searchsorted(keys, bucket_ids, right=True) - 1
        posc = pos.clamp(min=0)
        nonempty = (pos >= 0) & (keys[posc] == bucket_ids)
        chain_of = posc // m
        i_of = posc % m
        flat = i_of * K + chain_of
        cum_heads = heads_lane.cumsum(0).reshape(-1)
        tails = tuple(t.reshape(L, m * K)[:, flat] for t in (sx, sy, sz))
        needs_carry = cum_heads[flat] == 0
        carry_at = tuple(t[:, chain_of] for t in carry_in)
        added = group.add(tails, carry_at)
        sums = group.select(needs_carry, added, tails)
        live = nonempty & ((bucket_ids % B > 0) if nbatch > 1 else (bucket_ids > 0))
        sums = group.select(live, sums, group.identity(B_total))

        # T_w = sum_{b>=1} b S_b = per-batch (suffix of suffix)[1]
        suffix = plain_add_scan_reverse(sums)
        suffix2 = plain_add_scan_reverse(suffix)
        if nbatch > 1:
            slots = torch.arange(nbatch, device=device) * B + 1
            t_w = tuple(t[..., slots] for t in suffix2)
        else:
            t_w = tuple(t[..., 1:2] for t in suffix2)

        for _ in range(c):
            acc = group.add(acc, acc)
        acc = group.add(acc, t_w)
    return acc


def _default_lanes(n: int) -> int:
    return min(msm_kernels.LANES, max(128, 1 << (n.bit_length() // 2)))


def msm_affine(x: torch.Tensor, y: torch.Tensor, scalar_limbs: torch.Tensor, c: int = 0,
               lanes: int = 0, chunk: int = 8) -> g1.JacobianPoints:
    """Fused signed-window MSM over AFFINE points (no identities; zero
    scalars are fine). x, y: (L, N) affine Montgomery coordinates;
    scalar_limbs: (16, N) canonical Fr limbs. Inputs are padded to a
    multiple of lanes*chunk by repeating point 0 with scalar 0. Returns a
    width-1 JacobianPoints."""
    n = scalar_limbs.shape[-1]
    if c == 0:
        c = fused_window_bits(n)
    if lanes == 0:
        lanes = _default_lanes(n)
    tile = lanes * chunk
    n_pad = -(-n // tile) * tile
    if n_pad > msm_kernels.SERIAL_MAX_N:
        raise NotImplementedError(_B5)
    if n_pad != n:
        reps = n_pad - n
        x = torch.cat([x, x[:, :1].expand(-1, reps)], dim=-1)
        y = torch.cat([y, y[:, :1].expand(-1, reps)], dim=-1)
        scalar_limbs = torch.cat([scalar_limbs, scalar_limbs.new_zeros(
            (scalar_limbs.shape[0], reps))], dim=-1)
    ycat = torch.cat([y, fa.neg(FQ, y)], dim=-1)
    packed = signed_window_digits(scalar_limbs, c)
    out = _fused_msm_body(x, ycat, packed, c, lanes, chunk, serial=True)
    return g1.JacobianPoints(*(t[..., :1] for t in out))


def msm_affine_multi(x: torch.Tensor, y: torch.Tensor, scalar_limbs: torch.Tensor,
                     c: int = 0, lanes: int = 0, chunk: int = 8) -> g1.JacobianPoints:
    """Multi-MSM over a SHARED affine base (the puzzle prover's shape: B
    nonces' commit/witness MSMs over the same SRS prefix). One sort/scan/
    bucket pipeline accumulates every batch through per-batch bucket ranges.

    x, y: (L, N) affine Montgomery base; scalar_limbs: (16, B, N) canonical
    Fr limbs. Returns a width-B JacobianPoints (result i = MSM(scalars[:, i],
    base))."""
    _, nb, npts = scalar_limbs.shape
    if c == 0:
        # the per-batch size drives the scan/bucket trade-off
        c = fused_window_bits(npts)
    if lanes == 0:
        lanes = _default_lanes(nb * npts)
    tile = lanes * chunk
    # per-batch padding keeps every batch segment a copy of the padded base
    nper = npts if (nb * npts) % tile == 0 else -(-npts // tile) * tile
    n = nb * nper
    if n > msm_kernels.SERIAL_MAX_N:
        raise NotImplementedError(_B5)
    reps = nper - npts
    if reps:
        x = torch.cat([x, x[:, :1].expand(-1, reps)], dim=-1)
        y = torch.cat([y, y[:, :1].expand(-1, reps)], dim=-1)
        scalar_limbs = torch.cat([scalar_limbs, scalar_limbs.new_zeros(
            (scalar_limbs.shape[0], nb, reps))], dim=-1)
    x = x.repeat(1, nb)
    ycat = torch.cat([y.repeat(1, nb), fa.neg(FQ, y).repeat(1, nb)], dim=-1)
    packed = signed_window_digits(scalar_limbs.reshape(scalar_limbs.shape[0], n), c)
    out = _fused_msm_body(x, ycat, packed, c, lanes, chunk, serial=True, nbatch=nb)
    return g1.JacobianPoints(*out)


def msm_multi(points: g1.JacobianPoints, scalar_limbs: torch.Tensor, c: int = 0):
    """Multi-MSM over a shared JacobianPoints base that is affine (z == 1,
    as SRS powers are). scalar_limbs: (16, B, N)."""
    return msm_affine_multi(points.x, points.y, scalar_limbs, c=c)


def msm(points: g1.JacobianPoints, scalar_limbs: torch.Tensor) -> g1.JacobianPoints:
    """MSM over BLS12-377 G1 for affine bases (z == Montgomery one): points
    (L, N), scalar_limbs (16, N) canonical Fr limbs; returns a batch of 1."""
    one = fa.broadcast_const(FQ, 1, tuple(points.z.shape[1:]), device=points.z.device)
    if not bool((points.z == one).all()):
        raise NotImplementedError("non-affine bases need the generic engine "
                                  "(msm_generic), which is not ported")
    return msm_affine(points.x, points.y, scalar_limbs)
