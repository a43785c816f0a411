"""The port's counterpart of ``__graft_entry__.entry()``: one forward step
of the flagship pipeline over Fr limbs, counter-mode Poseidon coefficient
generation, then the radix-2 NTT, then a pointwise square.

    forward, (seed, ctr) = entry(log_n=22)
    out = forward(seed, ctr)

On the card a call is one ``fr_poseidon_permute``, ``len(ntt._pass_plan(log_n))``
``fr_ntt_pass`` (three at 2^22) and one ``mont_mul`` launch (kernel B1), once
the NTT's twiddle tables for the size are cached.

``dryrun_multichip(n)`` is the counterpart of
``__graft_entry__.dryrun_multichip``: one step of the distributed pipeline
over n ranks, on the card unless the caller asks for the CPU, each checked
against the host.
"""

from __future__ import annotations

import functools
import random

import numpy as np
import torch

from snarkos_tpu_torch.crypto.ref import g1 as ref_g1, ntt as ref_ntt
from snarkos_tpu_torch.ops import _build, g1, msm, ntt, poseidon
from snarkos_tpu_torch.ops import modarith as fa
from snarkos_tpu_torch.ops.fieldspec import FR
from snarkos_tpu_torch.parallel import mesh as mesh_mod
from snarkos_tpu_torch.parallel.msm_dist import msm_dist
from snarkos_tpu_torch.parallel.ntt_dist import intt_dist, ntt_dist

DOMAIN = "graft.entry"
MOCK_MOD = 1_000_003


def forward(seed: torch.Tensor, ctr: torch.Tensor) -> torch.Tensor:
    """(L, n) Montgomery seed and counter lanes -> (L, n) squared
    evaluations of the Poseidon coefficient vector."""
    coeffs = poseidon.hash_fixed(torch.stack([seed, ctr]), rate=2, domain=DOMAIN)[0]
    evals = ntt.ntt(coeffs)
    return fa.mont_mul(FR, evals, evals)


def entry(log_n: int = 10, device=None):
    """``(forward, (seed, ctr))`` at n = 2^log_n on ``device`` (None: the
    card), built as the JAX package's entry builds them: seed uniform Fr
    limbs from ``np.random.default_rng(0)``, ctr limb 0 = i & 0xFFFF and the
    other limbs 0."""
    device = _build.resolve_device(device)
    n = 1 << log_n
    seed = FR.random(n, np.random.default_rng(0))
    ctr = np.zeros((FR.nlimbs, n), dtype=np.int32)
    ctr[0] = np.arange(n) & 0xFFFF
    return forward, tuple(torch.from_numpy(a).to(device) for a in (seed, ctr))


def mock_group(device) -> msm.GroupOps:
    """Integers mod MOCK_MOD, one (1, N) int32 component on ``device``: the
    dry run's cheap group for the sharded MSM's skeleton."""
    device = torch.device(device)

    def identity(k):
        return (torch.zeros((1, k), dtype=torch.int32, device=device),)

    def add(a, b):
        return (((a[0].long() + b[0].long()) % MOCK_MOD).to(torch.int32),)

    def select(mask, a, b):
        return (torch.where(mask.unsqueeze(0), a[0], b[0]),)

    return msm.GroupOps(identity=identity, add=add, select=select)


def _dryrun_rank(mesh: mesh_mod.Mesh) -> None:
    """One rank of ``dryrun_multichip``: the reference's four checks, with
    its inputs (the same seeds, drawn in the same order)."""
    d = mesh.world
    n = max(64, d * d)  # n1 = n2 = sqrt(n) >= d
    rng = np.random.default_rng(1)

    # 1. data-parallel field ops: a b + a on each shard
    a_host = FR.random(n, rng)
    b_host = FR.random(n, rng)
    a = mesh_mod.shard_last(mesh, torch.from_numpy(a_host))
    b = mesh_mod.shard_last(mesh, torch.from_numpy(b_host))
    coeffs = fa.add(FR, fa.mont_mul(FR, a, b), a)
    got = FR.decode_fast(mesh_mod.all_gather_last(mesh, coeffs).cpu().numpy(), mont=True)
    av, bv = FR.decode_fast(a_host, mont=True), FR.decode_fast(b_host, mont=True)
    field = [(x * y + x) % FR.p for x, y in zip(av, bv)]
    if got != field:
        raise AssertionError("dryrun: field step mismatch")

    # 2. the four-step NTT and its three all_to_all exchanges
    evals = ntt_dist(coeffs, mesh)
    if not torch.equal(intt_dist(evals, mesh), coeffs):
        raise AssertionError("dryrun: intt_dist(ntt_dist(a)) != a")
    got = FR.decode_fast(mesh_mod.all_gather_last(mesh, evals).cpu().numpy(), mont=True)
    if got != ref_ntt.ntt(field):
        raise AssertionError("dryrun: ntt_dist != the host ntt")

    # 3. the sharded MSM's skeleton on the mock group
    scalars = FR.encode_fast([int(v) for v in rng.integers(1, 1 << 30, n)])
    points = rng.integers(0, MOCK_MOD, (1, n)).astype(np.int32)
    out = msm_dist((mesh_mod.shard_last(mesh, torch.from_numpy(points)),),
                   mesh_mod.shard_last(mesh, torch.from_numpy(scalars)), mesh, c=4,
                   group=mock_group(mesh.device))
    want = sum(s * int(p) for s, p in zip(FR.decode_fast(scalars), points[0])) % MOCK_MOD
    if int(out[0][0, 0]) != want:
        raise AssertionError(f"dryrun: sharded mock msm {int(out[0][0, 0])} != {want}")

    # 4. the real-G1 sharded MSM at 2 points a rank
    prng = random.Random(42)
    ng = 2 * d
    g_scalars = [prng.randrange(FR.p) for _ in range(ng)]
    g_pts = [ref_g1.scalar_mul(prng.randrange(1, 1 << 48), ref_g1.GENERATOR) for _ in range(ng)]
    enc = g1.encode_points(g_pts)
    pts = g1.JacobianPoints(*(mesh_mod.shard_last(mesh, t) for t in (enc.x, enc.y, enc.z)))
    ks = mesh_mod.shard_last(mesh, torch.from_numpy(FR.encode(g_scalars, mont=False)))
    out = msm_dist(pts, ks, mesh, c=4)
    want = functools.reduce(ref_g1.add,
                            (ref_g1.scalar_mul(k, p) for k, p in zip(g_scalars, g_pts)))
    if ref_g1.affine(g1.decode_points(out)[0]) != ref_g1.affine(want):
        raise AssertionError("dryrun: real-G1 msm_dist mismatch")


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One step of the distributed pipeline over ``n_devices`` spawned
    ranks: the data-parallel field step a b + a, ``ntt_dist`` / ``intt_dist``
    at n = max(64, D^2), the sharded MSM on a mock group (c = 4), and
    ``msm_dist`` over 2 D real G1 points (c = 4), each against the host.
    Raises if any rank fails.

    ``device=None`` (or ``"cuda"``) is the card: rank r on card r over NCCL
    when the host has ``n_devices`` cards, else every rank on ``cuda:0``
    over gloo (NCCL takes one rank a card); a card named by index is shared
    the same way. It raises without a card. ``"cpu"`` runs gloo CPU
    processes, as the JAX reference's virtual CPU mesh does."""
    dev = _build.resolve_device(device)
    if dev.type == "cpu":
        mesh_mod.spawn(_dryrun_rank, n_devices, "gloo", "cpu")
        return
    _build.build()  # once, here, and not by every rank
    if dev.index is None and torch.cuda.device_count() >= n_devices:
        mesh_mod.spawn(_dryrun_rank, n_devices, "nccl", "cuda")
    else:
        mesh_mod.spawn(_dryrun_rank, n_devices, "gloo", f"cuda:{dev.index or 0}")
