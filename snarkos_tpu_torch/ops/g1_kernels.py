"""Kernels B2 (complete G1 add) and B3 (segmented prefix scan), the port of
``snarkos_tpu/ops/g1_pallas.py``.

A CUDA tensor launches ``csrc/g1_add.cu`` / ``csrc/window_tail.cu`` /
``csrc/seg_prefix.cu`` / ``csrc/lane_scan.cu``; a CPU tensor runs the plain
version: ``g1.add`` for B2, ``seg_prefix_plain`` for B3. Coordinates are
(24, N) int32 Montgomery limb tensors, flags (1, N) int32.

B2 has two more entry points in ``csrc/window_tail.cu``, the compositions
of the add that end the MSM's window loop: ``horner_chain`` (the whole
Horner chain of a MSM, acc = 2^c acc + T_w from the identity and the top
window down, over a (W, 24, N) stack of the windows' totals) and
``bucket_fixup`` (a window's bucket sums from its raw inputs: sorted keys,
head flags, B3's prefix of the chain finals and the scan outputs). Each is
one launch giving the limbs of its plain version (``horner_chain_plain``,
``bucket_fixup_plain``), which composes ``g1.add`` / ``g1.double`` calls;
``bucket_indices`` is the torch index glue of the latter, which the kernel
derives per bucket itself.

The TPU kernel B3 is the one-round operator ``seg_combine``, launched once
per Hillis-Steele round by the MSM's prefix scans. Here B3 runs the whole
prefix in one launch (``seg_prefix``), round for round the same function;
``seg_combine_plain`` stays as the plain round operator.

The generic MSM engine's window (its chunked segmented scan over K lanes of
m consecutive sorted elements and the bucket sums at the runs' tails) runs
B3's operator 2 m times a window in the JAX package. Here it is two
launches of ``csrc/lane_scan.cu`` around one B3 prefix of the lane
aggregates: ``lane_buckets`` (each lane walked once; only the bucket tails
are written, with each lane's aggregate, first head and the key of its
first tail where that run began in an earlier lane) and
``lane_bucket_carry`` (the carry into such a lane added to that bucket).
Their plain versions are ``lane_buckets_plain`` (the JAX engine's first
pass keeping every step, then the tails' gather) and
``lane_bucket_carry_plain``.
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


@_build.counted
def add_kernel(pa: g1.JacobianPoints, pb: g1.JacobianPoints) -> g1.JacobianPoints:
    n = pa.x.shape[-1]
    for t, what in zip((pa.x, pa.y, pa.z, pb.x, pb.y, pb.z), ("ax", "ay", "az", "bx", "by", "bz")):
        _build.check(t, (_L, n), f"g1 add {what}")
    out = [torch.empty_like(pa.x) for _ in range(3)]
    if n:
        fn = _build.entry("g1_add", "g1_add", 9, 1)
        _build.launch(fn, (pa.x, pa.y, pa.z, pb.x, pb.y, pb.z, *out), (n,), pa.x.device)
        _build.count(add_kernel)
    return g1.JacobianPoints(*out)


def horner_plain(acc: g1.JacobianPoints, t: g1.JacobianPoints, c: int) -> g1.JacobianPoints:
    """One step of ``horner_chain_plain``, acc = 2^c acc + t: c times
    ``g1.add(acc, acc)``, then ``g1.add(acc, t)``. The self-add doubles a
    finite lane and keeps an identity lane's limbs, so only the doubling is
    computed."""
    for _ in range(c):
        acc = g1.select_points(g1.is_infinity(acc), acc, g1.double(acc))
    return g1.add(acc, t)


def horner_chain_plain(ts, c: int) -> g1.JacobianPoints:
    """Plain version of ``horner_chain``: ts = (x, y, z), each (W, 24, N),
    window w's total at index w; from the identity and the top window down,
    acc = ``horner_plain(acc, T_w, c)``."""
    acc = g1.infinity((ts[0].shape[-1],), device=ts[0].device)
    for w in range(ts[0].shape[0] - 1, -1, -1):
        acc = horner_plain(acc, g1.JacobianPoints(*(t[w] for t in ts)), c)
    return acc


@_build.counted
def horner_chain_kernel(ts, c: int) -> g1.JacobianPoints:
    """One launch of ``csrc/window_tail.cu``'s ``g1_horner_chain`` over the
    (W, 24, N) stacks ts = (x, y, z); limb for limb the plain version."""
    W, _, n = ts[0].shape
    for v, what in zip(ts, "xyz"):
        _build.check(v, (W, _L, n), f"g1 horner_chain {what}")
    if W < 1:
        raise ValueError("horner_chain: no windows")
    out = [torch.empty((_L, n), dtype=torch.int32, device=ts[0].device) for _ in range(3)]
    if n:
        fn = _build.entry("window_tail", "g1_horner_chain", 6, 3)
        _build.launch(fn, (*ts, *out), (W, n, c), ts[0].device)
        _build.count(horner_chain_kernel)
    return g1.JacobianPoints(*out)


def bucket_indices(keys, heads, K: int, rows: int, nbatch: int, B: int):
    """The index glue of a window's bucket sums, for buckets b < nbatch B:
    keys (n,) the sorted buckets; heads (m, K) the head flags in the chain
    layout (chain l = r K + k owns the sorted run [l mv, (l+1) mv), mv = n /
    (K rows), its element i at layout position (i rows + r) K + k). Returns
    (flat, chain_of, needs_carry, live): the layout position of the bucket's
    last sorted position, its chain, whether no head precedes it in that
    chain (its run started in an earlier chain), and whether the bucket is
    non-empty and not bucket 0 of its batch."""
    n = keys.shape[0]
    mv = n // (K * rows)
    bucket_ids = torch.arange(nbatch * B, device=keys.device)
    pos = torch.searchsorted(keys, bucket_ids, right=True) - 1
    posc = pos.clamp(min=0)
    nonempty = (pos >= 0) & (keys[posc] == bucket_ids)
    chain_of = posc // mv
    i_of = posc % mv
    flat = (i_of * rows + chain_of // K) * K + chain_of % K
    cum_heads = heads.reshape(mv, rows, K).cumsum(0).reshape(-1)  # heads so far within the chain
    needs_carry = cum_heads[flat] == 0
    live = nonempty & ((bucket_ids % B > 0) if nbatch > 1 else (bucket_ids > 0))
    return flat, chain_of, needs_carry, live


def bucket_fixup_plain(scan, keys, heads, summ, K: int, rows: int, nbatch: int,
                       B: int) -> g1.JacobianPoints:
    """Plain version of ``bucket_fixup``: ``bucket_indices``, the carry into
    chain l (``summ`` at l - 1, the identity for l = 0), and the gathers,
    add and selects of the window's bucket sums, as g1 functions."""
    flat, chain_of, needs_carry, live = bucket_indices(keys, heads, K, rows, nbatch, B)
    inf1 = g1.infinity((1,), device=keys.device)
    carry = [torch.cat([i, s[:, :-1]], dim=-1) for i, s in zip((inf1.x, inf1.y, inf1.z), summ)]
    tails = g1.JacobianPoints(*(t.reshape(t.shape[0], -1)[:, flat] for t in scan))
    carry_at = g1.JacobianPoints(*(t[:, chain_of] for t in carry))
    sums = g1.select_points(needs_carry, g1.add(tails, carry_at), tails)
    return g1.select_points(live, sums, g1.infinity(flat.shape, device=flat.device))


@_build.counted
def bucket_fixup_kernel(scan, keys, heads, summ, K: int, rows: int, nbatch: int,
                        B: int) -> g1.JacobianPoints:
    """One launch of ``csrc/window_tail.cu``'s ``g1_bucket_fixup``: a team of
    threads a bucket; limb for limb the plain version."""
    n = keys.shape[0]
    KV = K * rows
    if KV < 1 or n % KV:
        raise ValueError(f"bucket_fixup: {n} positions are not a multiple of {KV} chains")
    nb = nbatch * B
    for v, what in zip(scan, "xyz"):
        _build.check(v, (_L,) + tuple(v.shape[1:]), f"bucket_fixup scan {what}")
        if v.numel() != _L * n:
            raise ValueError(f"bucket_fixup scan {what}: {v.numel() // _L} positions, not {n}")
    _build.check(keys, (n,), "bucket_fixup keys", torch.int64)
    _build.check(heads, tuple(heads.shape), "bucket_fixup heads")
    if heads.numel() != n:
        raise ValueError(f"bucket_fixup heads: {heads.numel()} positions, not {n}")
    for v, what in zip(summ, "xyz"):
        _build.check(v, (_L, KV), f"bucket_fixup summ {what}")
    out = [torch.empty((_L, nb), dtype=torch.int32, device=keys.device) for _ in range(3)]
    if nb:
        fn = _build.entry("window_tail", "g1_bucket_fixup", 11, 5)
        _build.launch(fn, (*scan, keys, heads, *summ, *out), (n, K, rows, nbatch, B),
                      keys.device)
        _build.count(bucket_fixup_kernel)
    return g1.JacobianPoints(*out)


@_build.counted
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
        _build.count(seg_prefix_kernel)
    return tuple(out)


def lane_buckets_plain(keys, x, y, z, K: int, B: int):
    """Plain version of ``lane_buckets``: the sorted window (keys (n,), x, y,
    z (24, n)) as K lanes of m = n / K positions; each lane's segmented scan
    from (flag 0, the identity) with ``seg_combine_plain``, m steps at width
    K as the JAX engine's first pass runs them; then bucket b < B is the
    lane-local value at the last position of key b (the identity where b is
    0 or absent). Returns the buckets x, y, z (24, B), the lane aggregates
    (flag (1, K), the OR of the lane's heads; x, y, z (24, K), the value at
    its last position), first_head (K,) (the lane's first head, m if none)
    and carry_key (K,) (the key of the lane's first tail where that run
    began in an earlier lane, -1 if none), both int32."""
    n = x.shape[-1]
    m = n // K
    keys = keys.long()
    step = keys[1:] != keys[:-1]
    one = torch.ones(1, dtype=torch.bool, device=keys.device)
    heads = torch.cat([one, step]).reshape(K, m)
    tails = torch.cat([step, one]).reshape(K, m)
    p3 = tuple(t.reshape(_L, K, m) for t in (x, y, z))
    inf = g1.infinity((K,), device=x.device)
    state = (torch.zeros((1, K), dtype=torch.int32, device=x.device), inf.x, inf.y, inf.z)
    steps = []
    for j in range(m):
        state = seg_combine_plain(state, (heads[:, j].to(torch.int32).unsqueeze(0),)
                                  + tuple(p[:, :, j] for p in p3))
        steps.append(state[1:])
    local = tuple(torch.stack([st[i] for st in steps], dim=-1).reshape(_L, n) for i in range(3))
    bucket_ids = torch.arange(B, device=keys.device)
    pos = torch.searchsorted(keys, bucket_ids, right=True) - 1
    posc = pos.clamp(min=0)
    live = (pos >= 0) & (keys[posc] == bucket_ids) & (bucket_ids > 0)
    sums = g1.select_points(live, g1.JacobianPoints(*(t[:, posc] for t in local)),
                            g1.infinity((B,), device=x.device))
    first = torch.where(heads.any(1), heads.int().argmax(1), m).to(torch.int32)
    first_tail = tails.int().argmax(1)
    from_before = ~heads[:, 0] & tails.any(1)
    carry_key = torch.where(from_before, keys.reshape(K, m)[torch.arange(K, device=keys.device), first_tail],
                            -1).to(torch.int32)
    return (sums.x, sums.y, sums.z, *state, first, carry_key)


@_build.counted
def lane_buckets_kernel(keys, x, y, z, K: int, B: int, plan):
    """One launch of ``csrc/lane_scan.cu``'s ``g1_lane_buckets``. plan = (M
    members a lane, a power of two; MB members a block, one thread each, a
    multiple of M, at most 256, the kernel's launch bounds), as
    ``msm_kernels.lane_plan`` gives it. Its buckets and aggregates are other Jacobian representatives
    of the plain version's points; the flags, first heads and carry keys
    are exact."""
    n = x.shape[-1]
    M, MB = plan
    if K < 1 or n % K:
        raise ValueError(f"lane_buckets: {n} positions are not a multiple of {K} lanes")
    if M < 1 or M & (M - 1) or MB % M or MB > 256:
        raise ValueError(f"lane_buckets: plan {plan} is not M a power of two and MB a multiple "
                         "of M, at most 256")
    _build.check(keys, (n,), "lane_buckets keys", torch.int64)
    for t, what in zip((x, y, z), "xyz"):
        _build.check(t, (_L, n), f"lane_buckets {what}")
    dev = x.device
    out = [torch.empty((_L, B), dtype=torch.int32, device=dev) for _ in range(3)]
    agg = [torch.empty((1, K), dtype=torch.int32, device=dev)] + [
        torch.empty((_L, K), dtype=torch.int32, device=dev) for _ in range(3)]
    first = torch.empty(K, dtype=torch.int32, device=dev)
    carry_key = torch.empty(K, dtype=torch.int32, device=dev)
    if n:
        fn = _build.entry("lane_scan", "g1_lane_buckets", 13, 5)
        _build.launch(fn, (keys, x, y, z, *out, *agg, first, carry_key), (n, K, B, M, MB), dev)
        _build.count(lane_buckets_kernel)
    return (*out, *agg, first, carry_key)


def lane_bucket_carry_plain(bx, by, bz, sx, sy, sz, carry_key):
    """Plain version of ``lane_bucket_carry``: for each lane k >= 1 with
    carry_key[k] = b > 0, bucket b becomes ``g1.add(carry, bucket b)`` with
    the carry (sx, sy, sz)[k - 1] (the inclusive prefix of the lane
    aggregates); every other bucket as it is. Returns new tensors."""
    lanes = torch.arange(carry_key.shape[0], device=bx.device)
    idx = ((lanes > 0) & (carry_key > 0)).nonzero().squeeze(1)
    b = carry_key[idx].long()
    carry = g1.JacobianPoints(*(s[:, idx - 1] for s in (sx, sy, sz)))
    summed = g1.add(carry, g1.JacobianPoints(*(o[:, b] for o in (bx, by, bz))))
    out = [o.clone() for o in (bx, by, bz)]
    for o, v in zip(out, (summed.x, summed.y, summed.z)):
        o[:, b] = v
    return tuple(out)


@_build.counted
def lane_bucket_carry_kernel(bx, by, bz, sx, sy, sz, carry_key):
    """One launch of ``csrc/lane_scan.cu``'s ``g1_lane_bucket_carry``,
    updating (bx, by, bz) in place (they are returned); limb for limb the
    plain version."""
    B = bx.shape[-1]
    K = carry_key.shape[0]
    for t, what in zip((bx, by, bz), "xyz"):
        _build.check(t, (_L, B), f"lane_bucket_carry {what}")
    for t, what in zip((sx, sy, sz), "xyz"):
        _build.check(t, (_L, K), f"lane_bucket_carry prefix {what}")
    _build.check(carry_key, (K,), "lane_bucket_carry carry_key")
    if K:
        fn = _build.entry("lane_scan", "g1_lane_bucket_carry", 7, 2)
        _build.launch(fn, (bx, by, bz, sx, sy, sz, carry_key), (K, B), bx.device)
        _build.count(lane_bucket_carry_kernel)
    return bx, by, bz


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


def horner_chain(ts, c: int) -> g1.JacobianPoints:
    """The Horner chain of a MSM's windows: ts = (x, y, z), each (W, 24, N)
    with window w's total T_w at index w; from the identity and the top
    window down, acc = 2^c acc + T_w. B2's ``g1_horner_chain`` on a CUDA
    tensor (one launch for the W (c + 1) adds), the plain version on a CPU
    tensor."""
    if ts[0].device.type == "cpu":
        return horner_chain_plain(ts, c)
    return horner_chain_kernel(_contig(*ts), c)


def bucket_fixup(scan, keys, heads, summ, K: int, rows: int, nbatch: int,
                 B: int) -> g1.JacobianPoints:
    """A window's bucket sums, width nbatch B: the scan value at each
    bucket's last sorted position, plus the carry into its chain (``summ``,
    B3's inclusive prefix of the chain finals, at the chain before) where
    the bucket's run started in an earlier chain, the identity where the
    bucket is empty or bucket 0 of its batch. scan: the (x, y, z) outputs of
    a bucket scan, (L, m, K) in the chain layout; keys (n,) the sorted
    buckets; heads (m, K) the head flags in that layout; summ (x, y, z),
    (L, K rows). B2's ``g1_bucket_fixup`` on a CUDA tensor, the plain
    version on a CPU tensor."""
    if keys.device.type == "cpu":
        return bucket_fixup_plain(scan, keys, heads, summ, K, rows, nbatch, B)
    return bucket_fixup_kernel(_contig(*scan), keys.long().contiguous(), *_contig(heads),
                               _contig(*summ), K, rows, nbatch, B)


def seg_prefix(state):
    """Inclusive segmented prefix scan of a (flag (1, N), x, y, z) tuple of
    head flags and Jacobian points: kernel B3 on a CUDA tensor, the plain
    version on a CPU tensor."""
    flags, x, y, z = state
    if x.device.type == "cpu":
        return seg_prefix_plain(state)
    return seg_prefix_kernel(*_contig(flags.expand(1, x.shape[-1]), x, y, z))


def lane_buckets(keys, x, y, z, K: int, B: int, plan):
    """A window's lane-local bucket sums and lane outputs (module
    docstring): keys (n,) sorted, x, y, z (24, n), n = K m. Returns (x, y, z)
    (24, B), the lane aggregates (flag (1, K), x, y, z (24, K)), first_head
    and carry_key (K,). ``g1_lane_buckets`` on a CUDA tensor (``plan`` as
    ``lane_buckets_kernel`` takes it), the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return lane_buckets_plain(keys, x, y, z, K, B)
    return lane_buckets_kernel(keys.long().contiguous(), *_contig(x, y, z), K, B, plan)


def lane_bucket_carry(bx, by, bz, sx, sy, sz, carry_key):
    """The carry into each lane (sx, sy, sz: the inclusive prefix of the
    lane aggregates) added to the bucket of the lane's first tail where
    that run began in an earlier lane. ``g1_lane_bucket_carry`` on a CUDA
    tensor (in place), the plain version on a CPU tensor."""
    if bx.device.type == "cpu":
        return lane_bucket_carry_plain(bx, by, bz, sx, sy, sz, carry_key)
    return lane_bucket_carry_kernel(*_contig(bx, by, bz, sx, sy, sz, carry_key))
