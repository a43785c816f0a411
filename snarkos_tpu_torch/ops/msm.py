"""Pippenger multi-scalar multiplication, the fused signed-window engine (the
port of ``snarkos_tpu/ops/msm.py``).

Per c-bit signed window, high to low (Horner):
  1. packed signed digits -> per-element bucket (+ per-batch offset) and sign
  2. stable sort by bucket; gather the points into the chain layout
     (``chain_src``: serial chains for N <= SERIAL_MAX_N, else chunk * K
     wide virtual chains)
  3. per-chain segmented scan of the sorted affine points: kernel B4 on
     serial chains, B5 on wide chains, or B6 (incomplete add and an
     exception flag) in the single MSM's fast engine
  4. cross-chain carries: Hillis-Steele segmented prefix over the chain
     finals (kernel B3, the whole prefix in one launch)
  5. bucket sums = scan values at each bucket's last position, plus the carry
     where a bucket's run starts in an earlier chain (kernel B2's
     ``bucket_fixup``, one launch from the sorted keys, the head flags and
     B3's prefix: it finds each bucket's indices itself)
  6. T_w = sum_b b S_b: (suffix of suffix)[1] per batch (kernel B3), or, for
     a single MSM with B >= 2^11 buckets, kernel B7 (``_weighted_bucket_total``:
     the suffix scan and its total in one launch)
After the loop, acc = sum_w 2^(c w) T_w by Horner from the top window down
(kernel B2's ``horner_chain``, one launch a MSM over the windows' T_w).

``msm_affine`` runs the fast engine above SERIAL_MAX_N and reruns the
complete one when its exception flag is set. The group and the scans are
injectable (``group``/``scan_fn``) so the combinatorics are
testable with a cheap mock group on the CPU; the G1 group runs the kernels on
the card and their plain versions on the CPU.

``msm`` sends bases with z != 1 anywhere (identities included) to the generic
engine, ``msm_generic``: unsigned c-bit windows over 2^c buckets, and per
window a sort and the bucket sums at the runs' tails of the sorted Jacobian
points seen as K lanes of m steps (for G1 on the card: ``g1_lane_buckets``,
each lane walked once by a few threads, one B3 prefix of the lane
aggregates and ``g1_lane_bucket_carry``; for other groups two m-step passes
of the segmented combine around the prefix and a gather of the tails),
then T_w by kernel B7; after the loop the Horner chain by B2.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable

import torch

from snarkos_tpu_torch.ops import g1, g1_kernels, msm_kernels
from snarkos_tpu_torch.ops import modarith as fa
from snarkos_tpu_torch.ops.fieldspec import FQ

SCALAR_BITS = 253


@dataclass(frozen=True)
class GroupOps:
    """Abelian group elements as tuples of tensors with trailing axis N."""

    identity: Callable[[int], Any]
    add: Callable[[Any, Any], Any]  # complete, branchless
    select: Callable[[torch.Tensor, Any, Any], Any]  # mask (n,) ? a : b
    # the whole inclusive segmented prefix of a (flags, *elems) state in one
    # call; groups without it run the Hillis-Steele round loop
    seg_prefix: Callable[[Any], Any] | None = None
    # (ts, c) -> the Horner chain over the windows' totals ts[w] in one call
    # (``_horner_chain``); groups without it run c + 1 adds a window
    horner_chain: Callable[[list, int], Any] | None = None
    # (scan, keys, heads, summ, K, rows, nbatch, B) -> a window's bucket sums
    # in one call (``_bucket_sums``); groups without it run the index glue,
    # gather, add and select
    bucket_fixup: Callable[..., Any] | None = None
    # a window's bucket sums -> T_w = sum_{b>=1} b S_b, width 1, in one call
    # (``_weighted_bucket_total``); groups without it scan and sum
    bucket_total: Callable[[Any], Any] | None = None
    # (keys, pts, K, B) -> a window of the generic engine: its B bucket sums
    # from the sorted keys and points in one call (``_window_bucket_sums``);
    # groups without it fold the lanes step by step and gather the tails
    window_bucket_sums: Callable[..., Any] | None = None


def _default_seg_combine(group: GroupOps):
    def combine(a, b):
        fa_, pa = a[0], a[1:]
        fb_, pb = b[0], b[1:]
        s = group.add(pa, pb)
        out = group.select(fb_[0, :] != 0, pb, s)
        return (fa_ | fb_,) + tuple(out)

    return combine


def g1_group(device) -> GroupOps:
    """BLS12-377 G1 in Jacobian coordinates: kernels B2 (add, horner_chain,
    bucket_fixup), B3 (seg_prefix), B7 (bucket_total) and the generic
    engine's window (``g1_lane_buckets``, ``g1_lane_bucket_carry``) on the
    card, their plain versions on the CPU."""

    def coords(p):
        return (p.x, p.y, p.z)

    def identity(n):
        return coords(g1.infinity((n,), device=device))

    def add(a, b):
        return coords(g1_kernels.add(g1.JacobianPoints(*a), g1.JacobianPoints(*b)))

    def select(mask, a, b):
        return tuple(torch.where(mask.unsqueeze(0), x, y) for x, y in zip(a, b))

    def horner_chain(ts, c):
        return coords(g1_kernels.horner_chain(
            tuple(torch.stack([t[i] for t in ts]) for i in range(3)), c))

    def bucket_fixup(*args):
        return coords(g1_kernels.bucket_fixup(*args))

    def bucket_total(sums):
        return msm_kernels.bucket_total(*sums)

    group = GroupOps(identity=identity, add=add, select=select,
                     seg_prefix=g1_kernels.seg_prefix, horner_chain=horner_chain,
                     bucket_fixup=bucket_fixup,
                     bucket_total=bucket_total)
    seg = _default_seg_combine(group)

    def window_bucket_sums(keys, pts, K, B):
        """A window's bucket sums: on a CPU tensor its plain version, the
        JAX engine's order (the lane fold and the tails' gather); on a CUDA
        tensor ``g1_lane_buckets``, one B3 prefix of the lane aggregates and
        ``g1_lane_bucket_carry``."""
        if keys.device.type == "cpu":
            return _window_bucket_sums(seg, group, keys, pts, K, B)
        plan = msm_kernels.lane_plan(keys.shape[-1] // K)
        bx, by, bz, *agg, _, carry_key = g1_kernels.lane_buckets(keys, *pts, K, B, plan)
        summ = g1_kernels.seg_prefix(tuple(agg))
        return g1_kernels.lane_bucket_carry(bx, by, bz, *summ[1:], carry_key)

    return replace(group, window_bucket_sums=window_bucket_sums)


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
    Hillis-Steele: ceil(log2(width)) rounds of ``seg`` at full width, or one
    call of ``group.seg_prefix`` (the same function) where the group has it.

    state: (flags, *pts) tuple; nelems = len(pts)."""
    if group.seg_prefix is not None:
        return group.seg_prefix(state)
    device = state[0].device
    lane_ids = torch.arange(width, device=device).unsqueeze(0)
    steps = g1_kernels.prefix_steps(width)
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


def _horner_chain(group: GroupOps, ts, c: int):
    """sum_w 2^(c w) ts[w] by Horner: from the identity and the top window
    down, acc = 2^c acc + ts[w]. One ``group.horner_chain`` call, or for each
    window c doublings as ``group.add(acc, acc)`` and one add."""
    if group.horner_chain is not None:
        return group.horner_chain(ts, c)
    acc = group.identity(ts[0][0].shape[-1])
    for t in reversed(ts):
        for _ in range(c):
            acc = group.add(acc, acc)
        acc = group.add(acc, t)
    return acc


def _bucket_sums(group: GroupOps, scan, keys, heads, summ, K: int, rows: int, nbatch: int,
                 B: int):
    """A window's bucket sums (``g1_kernels.bucket_fixup``): the scan values
    at the buckets' last positions (scan: the (x, y, z) scan outputs), plus
    the carry into the bucket's chain (``summ``, the inclusive prefix of the
    chain finals, at the chain before) where its run started in an earlier
    chain, the identity where the bucket is empty or bucket 0 of its batch.
    One ``group.bucket_fixup`` call, or ``g1_kernels.bucket_indices``,
    gathers, an add and selects."""
    if group.bucket_fixup is not None:
        return group.bucket_fixup(scan, keys, heads, summ, K, rows, nbatch, B)
    flat, chain_of, needs_carry, live = g1_kernels.bucket_indices(keys, heads, K, rows,
                                                                  nbatch, B)
    carry_in = tuple(torch.cat([i, s[..., :-1]], dim=-1)
                     for i, s in zip(group.identity(1), summ))  # carry INTO chain l
    tails = tuple(t.reshape(t.shape[0], -1)[:, flat] for t in scan)
    carry_at = tuple(t[:, chain_of] for t in carry_in)
    sums = group.select(needs_carry, group.add(tails, carry_at), tails)
    return group.select(live, sums, group.identity(flat.shape[0]))


def chain_src(n: int, lanes: int, chunk: int, serial: bool, device=None) -> torch.Tensor:
    """The chain layout as an index: (m, K) sorted position held at each
    layout position (j, k), m = n / K. Wide chains (B5, B6): chain
    l = r K + k owns the sorted run [l mv, (l+1) mv), mv = n / (chunk K), and
    its element i sits at row j = i chunk + r. Serial chains (B4) are the
    same layout with chunk 1: chain k owns [k m, (k+1) m) down column k."""
    rows = 1 if serial else chunk
    K = lanes
    m = n // K
    mv = m // rows
    j = torch.arange(m, device=device).unsqueeze(1)
    k = torch.arange(K, device=device).unsqueeze(0)
    return ((j % rows) * K + k) * mv + j // rows


def chain_layout(x, ycat, packed, src, batch_off=None):
    """One window's sort and relayout. packed: (N,) packed signed digits;
    src: (m, K) layout index from ``chain_src``, on x's device; batch_off:
    (N,) per-element bucket offsets of a multi-MSM, or None. Returns (keys
    (N,) sorted buckets, xs and ys (L, m, K) sorted affine coordinates in the
    chain layout with the digit signs applied, heads (m, K) segment-head
    flags)."""
    L, n = x.shape
    m, K = src.shape
    device = x.device
    packed = packed.long()
    bucket = packed & 0xFFFF
    if batch_off is not None:
        bucket = bucket + batch_off
    sign = packed >> 16
    keys, order = torch.sort(bucket, stable=True)
    src_flat = src.reshape(-1)
    perm2 = order[src_flat]
    xs = x[:, perm2].reshape(L, m, K)
    ys = ycat[:, perm2 + sign[perm2] * n].reshape(L, m, K)
    head = torch.cat([torch.ones(1, dtype=torch.int32, device=device),
                      (keys[1:] != keys[:-1]).to(torch.int32)])
    return keys, xs, ys, head[src_flat].reshape(m, K)


def _weighted_bucket_total(sums, group: GroupOps, seg, B: int):
    """T_w = sum_{b>=1} b S_b over a window's bucket sums (3 x (L, B)) as the
    total of the suffixes suffix_b = sum_{i>=b} S_i, b >= 1: one
    ``group.bucket_total`` call (G1: kernel B7, one launch), or, for groups
    without it, the same steps as B7's plain version: the inclusive
    Hillis-Steele scan of the live buckets B-1..1 reversed (``seg``, no
    heads), then a tree sum of the suffixes."""
    if group.bucket_total is not None:
        return group.bucket_total(sums)
    rev = tuple(t[..., 1:B].flip(-1) for t in sums)
    flags = torch.zeros((1, B - 1), dtype=torch.int32, device=sums[0].device)
    suffix = _hillis_steele_prefix(seg, group, (flags,) + rev, B - 1, len(sums))[1:]
    return msm_kernels.tree_sum(suffix, group.add, group.identity)


def _fused_msm_body(x, ycat, packed_digits, c: int, lanes: int, chunk: int,
                    group: GroupOps | None = None, scan_fn=None, fast: bool = False,
                    serial: bool = True, nbatch: int = 1):
    """Window loop of the fused engine. x: (L, N) affine x; ycat: (L, 2N)
    [y | -y]; packed_digits: (W, N). Returns the width-nbatch (x, y, z)
    accumulator tuple, or (acc, exc) with ``fast=True``: exc is a 0-d int32
    tensor, nonzero when a bucket-scan chain of some window hit P == +-Q in a
    live bucket (the result is then garbage and the caller reruns with
    ``fast=False``).

    The scan runs over KV = lanes * chunk virtual chains (``chain_src``; B5,
    or B6 with ``fast``), or over the K = lanes columns with
    ``serial=True`` (B4), an 8x narrower cross-chain pass for small N.
    ``nbatch > 1`` runs a MULTI-MSM: the input holds nbatch consecutive
    segments of N / nbatch elements (same base, different scalars); digits
    are offset into per-batch bucket ranges [i B, (i+1) B) so one sort and
    one scan accumulate every batch, and the bucket-total suffix scans run
    segmented per batch. The single G1 MSM with B >= 2^11 buckets totals
    them through ``_weighted_bucket_total`` (B7).

    ``group`` and ``scan_fn`` are injectable so the combinatorics can be
    tested with a cheap mock group on the CPU."""
    L, n = x.shape
    device = x.device
    rows = 1 if serial else chunk
    K = lanes
    m = n // K
    KV = K * rows
    mv = n // KV
    B = (1 << (c - 1)) + 1
    B_total = nbatch * B
    nper = n // nbatch
    batch_off = (torch.arange(n, device=device) // nper) * B if nbatch > 1 else None
    seg_flags = ((torch.arange(B_total, device=device) % B == 0)
                 .to(torch.int32).unsqueeze(0) if nbatch > 1 else None)
    weighted_total = group is None and B >= (1 << 11) and nbatch == 1
    if group is None:
        group = g1_group(device)
    if scan_fn is None:
        if serial:
            scan_fn = msm_kernels.bucket_scan_serial
        else:
            scan_fn = msm_kernels.bucket_scan_fast if fast else msm_kernels.bucket_scan
    seg = _default_seg_combine(group)
    src = chain_src(n, K, chunk, serial, device)

    def plain_add_scan_reverse(vals):
        rev = tuple(t.flip(-1) for t in vals)
        flags = (seg_flags if nbatch > 1
                 else torch.zeros((1, B_total), dtype=torch.int32, device=device))
        cur = _hillis_steele_prefix(seg, group, (flags,) + rev, B_total, len(vals))
        return tuple(t.flip(-1) for t in cur[1:])

    W = packed_digits.shape[0]
    t_ws = [None] * W  # window w's T_w, for the Horner chain after the loop
    exc_acc = torch.zeros((), dtype=torch.int32, device=device)
    for w in range(W - 1, -1, -1):
        keys, xs, ys, heads_lane = chain_layout(x, ycat, packed_digits[w], src, batch_off)
        if fast:
            nz_lane = (keys > 0).to(torch.int32)[src.reshape(-1)].reshape(m, K)
            sx, sy, sz, exc = scan_fn(xs, ys, heads_lane.unsqueeze(0), nz_lane.unsqueeze(0),
                                      K, chunk)
            exc_acc = exc_acc | exc.max()
        else:
            sx, sy, sz = scan_fn(xs, ys, heads_lane.unsqueeze(0), K, chunk)

        # cross-chain carries: inclusive segmented scan of the chain finals,
        # which lie in the last `rows` rows (chain l = r K + k at row r)
        chain_flag = heads_lane.reshape(mv, rows, K).max(0).values.reshape(1, KV)
        finals = tuple(t[:, -rows:, :].reshape(L, KV) for t in (sx, sy, sz))
        summ = _hillis_steele_prefix(seg, group, (chain_flag,) + finals, KV, 3)

        # bucket sums = scan values at each bucket's last occurrence, plus
        # the chain carry when the bucket's run extends past a chain start
        sums = _bucket_sums(group, (sx, sy, sz), keys, heads_lane, summ[1:], K, rows, nbatch, B)

        # T_w = sum_{b>=1} b S_b: B7 in one launch (~2B adds) for the single
        # MSM's wide windows, the double Hillis-Steele (2 B log B adds, per
        # batch) below B = 2^11 and for multi-MSMs.
        if weighted_total:
            t_w = _weighted_bucket_total(sums, group, seg, B)
        else:
            # per-batch (suffix of suffix)[1]
            suffix = plain_add_scan_reverse(sums)
            suffix2 = plain_add_scan_reverse(suffix)
            if nbatch > 1:
                slots = torch.arange(nbatch, device=device) * B + 1
                t_w = tuple(t[..., slots] for t in suffix2)
            else:
                t_w = tuple(t[..., 1:2] for t in suffix2)

        t_ws[w] = t_w
    acc = _horner_chain(group, t_ws, c)
    if fast:
        return acc, exc_acc
    return acc


# --------------------------------------------------------------------------
# the generic engine (any Jacobian bases)
# --------------------------------------------------------------------------


def default_window_bits(n: int) -> int:
    """Window size of the generic engine: c ~ log2(n) - 4, clamped to [4, 13]."""
    return max(4, min(13, n.bit_length() - 4))


def _seg_scan_chunked(seg, group: GroupOps, flags: torch.Tensor, pts, K: int):
    """Segmented inclusive scan of (flags (1, N), pts) along the trailing
    axis, N % K == 0: lane k holds elements [k m, (k+1) m), m = N / K. As
    the JAX engine runs it: pass 1 folds each lane with ``seg`` in m steps
    at width K, one prefix over the K lane aggregates
    (``_hillis_steele_prefix``) gives the carries, and pass 2 folds again
    from the carries, keeping every step."""
    n = flags.shape[-1]
    m = n // K
    device = flags.device
    # step j of every lane as one contiguous (.., K) slice
    f3 = flags.reshape(1, K, m).permute(2, 0, 1).contiguous()
    p3 = tuple(p.reshape(p.shape[0], K, m).permute(2, 0, 1).contiguous() for p in pts)

    def fold(state, keep):
        steps = []
        for j in range(m):
            state = seg(state, (f3[j],) + tuple(p[j] for p in p3))
            if keep:
                steps.append(state[1:])
        return state, steps

    # pass 1 starts from flag 0: a lane aggregate's flag must be the OR of
    # the lane's own heads (it decides whether a carry stops there); the
    # identity makes the first combine give element 0 whatever its flag
    init = (torch.zeros((1, K), dtype=torch.int32, device=device),) + tuple(group.identity(K))
    lane_agg, _ = fold(init, False)
    summaries = _hillis_steele_prefix(seg, group, lane_agg, K, len(pts))
    # the carry into lane k is the inclusive prefix of lane k - 1; lane 0's
    # carry is the identity with flag 1
    ident1 = group.identity(1)
    carry = (torch.cat([torch.ones((1, 1), dtype=torch.int32, device=device),
                        summaries[0][..., :-1]], dim=-1),) + tuple(
        torch.cat([ident1[i], summaries[1 + i][..., :-1]], dim=-1) for i in range(len(pts)))
    _, steps = fold(carry, True)
    return tuple(torch.stack([s[i] for s in steps], dim=-1).reshape(pts[i].shape)
                 for i in range(len(pts)))


def _window_bucket_sums(seg, group: GroupOps, keys: torch.Tensor, pts, K: int,
                        num_buckets: int):
    """A window's bucket sums from its sorted keys (N,) and the points in
    that order: one ``group.window_bucket_sums`` call where the group has
    it, else the JAX engine's order: the chunked segmented scan
    (``_seg_scan_chunked``) and each bucket's value at the last occurrence
    of its key, the identity where the bucket is 0 or empty."""
    if group.window_bucket_sums is not None:
        return group.window_bucket_sums(keys, pts, K, num_buckets)
    device = keys.device
    head = torch.cat([torch.ones(1, dtype=torch.int32, device=device),
                      (keys[1:] != keys[:-1]).to(torch.int32)]).unsqueeze(0)
    scanned = _seg_scan_chunked(seg, group, head, pts, K)
    bucket_ids = torch.arange(num_buckets, device=device)
    pos = torch.searchsorted(keys, bucket_ids, right=True) - 1
    posc = pos.clamp(min=0)
    live = (pos >= 0) & (keys[posc] == bucket_ids) & (bucket_ids > 0)
    return group.select(live, tuple(t[..., posc] for t in scanned),
                        group.identity(num_buckets))


def msm_generic(group: GroupOps, points, scalar_limbs: torch.Tensor, c: int,
                chunk_lanes: int = 4096):
    """Windowed-bucket MSM over any group elements. points: tuple of (.., N)
    tensors; scalar_limbs: (16, N) canonical Fr limbs; N a multiple of
    K = min(chunk_lanes, N). Per unsigned c-bit window, high to low: a
    stable sort by digit, the bucket sums at each run's tail of the sorted
    points (``_window_bucket_sums``; bucket 0 weighted 0) and T_w = sum_b b
    S_b (``_weighted_bucket_total``, B = 2^c); then the Horner chain
    acc = 2^c acc + T_w over the windows (``_horner_chain``). Returns a
    width-1 element."""
    n = scalar_limbs.shape[-1]
    K = min(chunk_lanes, n)
    if n % K:
        raise ValueError(f"msm_generic: {n} points are not a multiple of {K} lanes")
    num_buckets = 1 << c
    digits = window_digits(scalar_limbs, c)
    seg = _default_seg_combine(group)
    t_ws = [None] * digits.shape[0]  # window w's T_w, for the Horner chain after the loop
    for w in range(digits.shape[0] - 1, -1, -1):
        keys, order = torch.sort(digits[w].long(), stable=True)
        pts = tuple(t[..., order] for t in points)
        sums = _window_bucket_sums(seg, group, keys, pts, K, num_buckets)
        # this window's (.., N) copies go before the next window makes its own
        del pts
        t_ws[w] = _weighted_bucket_total(sums, group, seg, num_buckets)
    return _horner_chain(group, t_ws, c)


def _msm_jacobian(points: g1.JacobianPoints, scalar_limbs: torch.Tensor, c: int = 0,
                  chunk_lanes: int = 4096) -> g1.JacobianPoints:
    """The generic engine over BLS12-377 G1 Jacobian bases (identities and
    any z): c = ``default_window_bits(N)`` unless given."""
    if c == 0:
        c = default_window_bits(scalar_limbs.shape[-1])
    out = msm_generic(g1_group(points.x.device), (points.x, points.y, points.z), scalar_limbs,
                      c, chunk_lanes)
    return g1.JacobianPoints(*out)


def _default_lanes(n: int) -> int:
    return min(msm_kernels.LANES, max(128, 1 << (n.bit_length() // 2)))


def _msm_affine(x: torch.Tensor, y: torch.Tensor, scalar_limbs: torch.Tensor, c: int = 0,
                lanes: int = 0, chunk: int = 8, serial: bool | None = None,
                fast: bool = False):
    """The fused signed-window engine, once. Returns (width-1 JacobianPoints,
    exc): exc is a 0-d int32 tensor, always 0 unless ``fast``, where nonzero
    means the incomplete add hit P == +-Q and the point is garbage.

    ``serial`` picks the serial-chain engine (B4); it defaults to
    n <= SERIAL_MAX_N. The wide engines are the complete B5 and, with
    ``fast``, the incomplete B6 (``fast`` is ignored on serial chains)."""
    n = scalar_limbs.shape[-1]
    if serial is None:
        serial = n <= msm_kernels.SERIAL_MAX_N
    fast = fast and not serial
    if c == 0:
        c = fused_window_bits(n)
    if lanes == 0:
        lanes = _default_lanes(n)
    tile = lanes * chunk
    n_pad = -(-n // tile) * tile
    if n_pad != n:
        reps = n_pad - n
        x = torch.cat([x, x[:, :1].expand(-1, reps)], dim=-1)
        y = torch.cat([y, y[:, :1].expand(-1, reps)], dim=-1)
        scalar_limbs = torch.cat([scalar_limbs, scalar_limbs.new_zeros(
            (scalar_limbs.shape[0], reps))], dim=-1)
    ycat = torch.cat([y, fa.neg(FQ, y)], dim=-1)
    packed = signed_window_digits(scalar_limbs, c)
    out = _fused_msm_body(x, ycat, packed, c, lanes, chunk, fast=fast, serial=serial)
    if fast:
        out, exc = out
    else:
        exc = torch.zeros((), dtype=torch.int32, device=x.device)
    return g1.JacobianPoints(*(t[..., :1] for t in out)), exc


def msm_affine(x: torch.Tensor, y: torch.Tensor, scalar_limbs: torch.Tensor, c: int = 0,
               lanes: int = 0, chunk: int = 8) -> g1.JacobianPoints:
    """Fused signed-window MSM over AFFINE points (no identities; zero
    scalars are fine). x, y: (L, N) affine Montgomery coordinates;
    scalar_limbs: (16, N) canonical Fr limbs. Inputs are padded to a
    multiple of lanes*chunk by repeating point 0 with scalar 0. Returns a
    width-1 JacobianPoints.

    Above SERIAL_MAX_N the incomplete-add engine (B6) runs first; its
    exception flag is read on the host once, and on a hit (P == +-Q inside a
    live bucket, which random bases such as SRS powers never give) the
    complete engine (B5) reruns."""
    out, exc = _msm_affine(x, y, scalar_limbs, c, lanes, chunk, fast=True)
    if int(exc) != 0:
        out, _ = _msm_affine(x, y, scalar_limbs, c, lanes, chunk, fast=False)
    return out


def msm_affine_multi(x: torch.Tensor, y: torch.Tensor, scalar_limbs: torch.Tensor,
                     c: int = 0, lanes: int = 0, chunk: int = 8) -> g1.JacobianPoints:
    """Multi-MSM over a SHARED affine base (the puzzle prover's shape: B
    nonces' commit/witness MSMs over the same SRS prefix). One sort/scan/
    bucket pipeline accumulates every batch through per-batch bucket ranges;
    up to SERIAL_MAX_N points in all it runs on serial chains (B4), above
    on wide chains (B5).

    x, y: (L, N) affine Montgomery base; scalar_limbs: (16, B, N) canonical
    Fr limbs. Returns a width-B JacobianPoints (result i = MSM(scalars[:, i],
    base)). Serial chains need only K | B N: below ``_default_lanes`` points
    in all, K = B N chains of one point each, nothing padded."""
    _, nb, npts = scalar_limbs.shape
    serial = nb * npts <= msm_kernels.SERIAL_MAX_N
    if c == 0:
        # the per-batch size drives the scan/bucket trade-off
        c = fused_window_bits(npts)
    if lanes == 0:
        lanes = _default_lanes(nb * npts)
        if serial:
            lanes = min(lanes, nb * npts)
    tile = lanes if serial else lanes * chunk
    # per-batch padding keeps every batch segment a copy of the padded base
    nper = npts if (nb * npts) % tile == 0 else -(-npts // tile) * tile
    n = nb * nper
    reps = nper - npts
    if reps:
        x = torch.cat([x, x[:, :1].expand(-1, reps)], dim=-1)
        y = torch.cat([y, y[:, :1].expand(-1, reps)], dim=-1)
        scalar_limbs = torch.cat([scalar_limbs, scalar_limbs.new_zeros(
            (scalar_limbs.shape[0], nb, reps))], dim=-1)
    x = x.repeat(1, nb)
    ycat = torch.cat([y.repeat(1, nb), fa.neg(FQ, y).repeat(1, nb)], dim=-1)
    packed = signed_window_digits(scalar_limbs.reshape(scalar_limbs.shape[0], n), c)
    out = _fused_msm_body(x, ycat, packed, c, lanes, chunk, serial=serial, nbatch=nb)
    return g1.JacobianPoints(*out)


def msm_multi(points: g1.JacobianPoints, scalar_limbs: torch.Tensor, c: int = 0):
    """Multi-MSM over a shared JacobianPoints base that is affine (z == 1,
    as SRS powers are). scalar_limbs: (16, B, N)."""
    return msm_affine_multi(points.x, points.y, scalar_limbs, c=c)


def msm(points: g1.JacobianPoints, scalar_limbs: torch.Tensor) -> g1.JacobianPoints:
    """MSM over BLS12-377 G1: points (L, N) Jacobian Montgomery coordinates,
    scalar_limbs (16, N) canonical Fr limbs; returns a batch of 1. Affine
    bases (z == Montgomery one everywhere, one host read) take the fused
    engine ``msm_affine``; any other (identities, z != 1) the generic engine
    ``_msm_jacobian``."""
    one = fa.broadcast_const(FQ, 1, tuple(points.z.shape[1:]), device=points.z.device)
    if bool((points.z == one).all()):
        return msm_affine(points.x, points.y, scalar_limbs)
    return _msm_jacobian(points, scalar_limbs)
