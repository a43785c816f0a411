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
     ``bucket_fixup``, one launch)
  6. T_w = sum_b b S_b: (suffix of suffix)[1] per batch (kernel B3), or, for
     a single MSM with B >= 2^11 buckets, two chunked Jacobian scans
     (kernel B7, ``_weighted_bucket_total``, and two B2 adds)
  7. acc = 2^c acc + T_w (kernel B2's ``horner``, one launch)

``msm_affine`` runs the fast engine above SERIAL_MAX_N and reruns the
complete one when its exception flag is set. The group and the scans are
injectable (``group``/``scan_fn``/``jadd_scan``) so the combinatorics are
testable with a cheap mock group on the CPU; the G1 group runs the kernels on
the card and their plain versions on the CPU.

Not ported (ROADMAP.md): the generic engine for non-affine bases.
"""

from __future__ import annotations

from dataclasses import dataclass
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
    # (acc, t, c) -> 2^c acc + t in one call; groups without it run c + 1 adds
    horner: Callable[[Any, Any, int], Any] | None = None
    # (scan, flat, carry_in, chain_of, needs_carry, live) -> a window's bucket
    # sums in one call (``_bucket_sums``); groups without it gather, add and
    # select
    bucket_fixup: Callable[..., Any] | None = None


def _default_seg_combine(group: GroupOps):
    def combine(a, b):
        fa_, pa = a[0], a[1:]
        fb_, pb = b[0], b[1:]
        s = group.add(pa, pb)
        out = group.select(fb_[0, :] != 0, pb, s)
        return (fa_ | fb_,) + tuple(out)

    return combine


def g1_group(device) -> GroupOps:
    """BLS12-377 G1 in Jacobian coordinates: kernels B2 (add, horner,
    bucket_fixup) and B3 (seg_prefix) on the card, their plain versions on
    the CPU."""

    def coords(p):
        return (p.x, p.y, p.z)

    def identity(n):
        return coords(g1.infinity((n,), device=device))

    def add(a, b):
        return coords(g1_kernels.add(g1.JacobianPoints(*a), g1.JacobianPoints(*b)))

    def select(mask, a, b):
        return tuple(torch.where(mask.unsqueeze(0), x, y) for x, y in zip(a, b))

    def horner(acc, t, c):
        return coords(g1_kernels.horner(g1.JacobianPoints(*acc), g1.JacobianPoints(*t), c))

    def bucket_fixup(*args):
        return coords(g1_kernels.bucket_fixup(*args))

    return GroupOps(identity=identity, add=add, select=select,
                    seg_prefix=g1_kernels.seg_prefix, horner=horner, bucket_fixup=bucket_fixup)


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


def _horner(group: GroupOps, acc, t, c: int):
    """acc = 2^c acc + t: one ``group.horner`` call, or c doublings as
    ``group.add(acc, acc)`` and one add."""
    if group.horner is not None:
        return group.horner(acc, t, c)
    for _ in range(c):
        acc = group.add(acc, acc)
    return group.add(acc, t)


def _bucket_sums(group: GroupOps, scan, flat, carry_in, chain_of, needs_carry, live):
    """A window's bucket sums: the scan values at the buckets' last
    positions ``flat`` (scan: the (x, y, z) scan outputs), plus the carry
    into chain ``chain_of`` where ``needs_carry``, the identity where not
    ``live``. One ``group.bucket_fixup`` call, or gathers, an add and
    selects."""
    if group.bucket_fixup is not None:
        return group.bucket_fixup(scan, flat, carry_in, chain_of, needs_carry, live)
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


def _weighted_bucket_total(sums, group: GroupOps, seg, B: int, jadd_scan=None):
    """T_w = sum_{b>=1} b S_b over Jacobian bucket sums (3 x (L, B)) by two
    chunked inclusive scans (kernel B7) and a masked total: ~2B group adds
    instead of the 2 B log B of the double Hillis-Steele suffix scans.

    T_w = sum_{b>=1} suffix_b with suffix_b = sum_{i>=b} S_i. Scan 1 gives
    every suffix_b (a scan of the reversed sums); scan 2 totals suffix_1 ..
    suffix_{B-1} (bucket 0 and the padding masked to the identity). The
    positions are laid out as B7's virtual chains (chain l owns [l mv,
    (l+1) mv)); the cross-chain carries come from a Hillis-Steele pass over
    the KV chain finals and are folded in with one full-width add.
    ``jadd_scan`` replaces B7 (the tests pass a mock)."""
    if jadd_scan is None:
        jadd_scan = msm_kernels.jadd_scan
    Kb, Cb = msm_kernels.JADD_LANES, msm_kernels.JADD_CHUNK
    KV = Kb * Cb
    mv = -(-B // KV)
    Bp = KV * mv
    m = mv * Cb
    device = sums[0].device
    identB = group.identity(Bp)
    pad = tuple(torch.cat([t.flip(-1), identB[i][..., :Bp - B]], dim=-1)
                for i, t in enumerate(sums))  # reversed, identity padding

    pos = torch.arange(Bp, device=device)
    # flat (j, k) with j = i Cb + r holds chain (r, k)'s element i
    j_grid, k_grid = pos // Kb, pos % Kb
    src = ((j_grid % Cb) * Kb + k_grid) * mv + j_grid // Cb
    inv = torch.empty_like(src)
    inv[src] = pos
    chain_idx = (j_grid % Cb) * Kb + k_grid  # position (j, k) lies in chain (j % Cb) Kb + k
    zero_flag = torch.zeros((1, KV), dtype=torch.int32, device=device)
    ident1 = group.identity(1)

    def chunked_scan_total(vals):
        """-> (inclusive scan values (.., Bp) in the original position
        order, grand total (.., 1))."""
        s = jadd_scan(*(t[:, src].reshape(t.shape[0], m, Kb) for t in vals), Kb, Cb)
        finals = tuple(t[:, -Cb:, :].reshape(t.shape[0], KV) for t in s)
        summ = _hillis_steele_prefix(seg, group, (zero_flag,) + finals, KV, 3)
        carry = tuple(torch.cat([ident1[i], summ[1 + i][..., :-1]], dim=-1)
                      for i in range(3))  # carry INTO chain l
        flat = tuple(t.reshape(t.shape[0], m * Kb) for t in s)
        fixed = group.add(flat, tuple(t[:, chain_idx] for t in carry))
        total = tuple(t[..., -1:] for t in summ[1:])
        return tuple(t[:, inv] for t in fixed), total

    suffix_rev, _ = chunked_scan_total(pad)
    # suffix_rev[p] = suffix_{B-1-p} for p < B: mask p >= B-1 (bucket 0 and
    # the padding) to the identity, then total the rest
    live = pos < (B - 1)
    _, total = chunked_scan_total(group.select(live, suffix_rev, identB))
    return total


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
    bucket_ids = torch.arange(B_total, device=device)
    src = chain_src(n, K, chunk, serial, device)

    def plain_add_scan_reverse(vals):
        rev = tuple(t.flip(-1) for t in vals)
        flags = (seg_flags if nbatch > 1
                 else torch.zeros((1, B_total), dtype=torch.int32, device=device))
        cur = _hillis_steele_prefix(seg, group, (flags,) + rev, B_total, len(vals))
        return tuple(t.flip(-1) for t in cur[1:])

    acc = group.identity(nbatch)
    exc_acc = torch.zeros((), dtype=torch.int32, device=device)
    for w in range(packed_digits.shape[0] - 1, -1, -1):
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
        heads_chain = heads_lane.reshape(mv, rows, K)
        chain_flag = heads_chain.max(0).values.reshape(1, KV)
        finals = tuple(t[:, -rows:, :].reshape(L, KV) for t in (sx, sy, sz))
        summ = _hillis_steele_prefix(seg, group, (chain_flag,) + finals, KV, 3)
        ident1 = group.identity(1)
        carry_in = tuple(torch.cat([ident1[i], summ[1 + i][..., :-1]], dim=-1)
                         for i in range(3))  # carry INTO chain l

        # bucket sums = scan values at each bucket's last occurrence, plus
        # the chain carry when the bucket's run extends past a chain start
        pos = torch.searchsorted(keys, bucket_ids, right=True) - 1
        posc = pos.clamp(min=0)
        nonempty = (pos >= 0) & (keys[posc] == bucket_ids)
        chain_of = posc // mv
        i_of = posc % mv
        flat = (i_of * rows + chain_of // K) * K + chain_of % K
        cum_heads = heads_chain.cumsum(0).reshape(-1)  # heads so far within the chain
        needs_carry = cum_heads[flat] == 0
        live = nonempty & ((bucket_ids % B > 0) if nbatch > 1 else (bucket_ids > 0))
        sums = _bucket_sums(group, (sx, sy, sz), flat, carry_in, chain_of, needs_carry, live)

        # T_w = sum_{b>=1} b S_b. The chunked scans (B7) do ~2B adds against
        # the double Hillis-Steele's 2 B log B, but carry a fixed cross-chain
        # cost of ~2 log(KV) KV adds: a loss below B ~ 2^11.
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

        acc = _horner(group, acc, t_w, c)
    if fast:
        return acc, exc_acc
    return acc


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
    reps = nper - npts
    if reps:
        x = torch.cat([x, x[:, :1].expand(-1, reps)], dim=-1)
        y = torch.cat([y, y[:, :1].expand(-1, reps)], dim=-1)
        scalar_limbs = torch.cat([scalar_limbs, scalar_limbs.new_zeros(
            (scalar_limbs.shape[0], nb, reps))], dim=-1)
    x = x.repeat(1, nb)
    ycat = torch.cat([y.repeat(1, nb), fa.neg(FQ, y).repeat(1, nb)], dim=-1)
    packed = signed_window_digits(scalar_limbs.reshape(scalar_limbs.shape[0], n), c)
    out = _fused_msm_body(x, ycat, packed, c, lanes, chunk,
                          serial=n <= msm_kernels.SERIAL_MAX_N, nbatch=nb)
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
