"""Carry state across from the JAX package, given as numpy arrays or bytes.

The JAX package's ``PuzzleSRS.points`` coordinates, its ``EpochProgram``
tensors and its Fr arrays (the NTT's inputs and outputs) are already in the
port's layout (int32 16-bit limbs, Montgomery form with the same R), so
conversion is a checked copy onto the device.
The node's objects (``Block``, ``Transaction``, ``Solution``, ``Committee``,
a ``VarunaProof``, a BFT event, a ``BatchCertificate``, a ``Subdag``) cross
through their wire bytes, which both packages encode alike; ``ledger``
replays a chain's blocks into a port ``Ledger``.
Nothing here imports the JAX package: callers pass ``np.asarray(...)`` of
its arrays, host values (``srs_ref.tau_h``) as Python ints, and an object's
``to_bytes()`` / ``serialize()``.
"""

from __future__ import annotations

import numpy as np
import torch

from snarkos_tpu_torch.crypto.ref import kzg as ref_kzg, pairing, varuna
from snarkos_tpu_torch.node import codec, events, ledger as ledger_mod, types
from snarkos_tpu_torch.ops import _build, g1
from snarkos_tpu_torch.ops.fieldspec import FQ, FR
from snarkos_tpu_torch.ops.puzzle import DEV_TAU, EPOCH_STEPS, EpochProgram, PuzzleSRS


def _limbs(arr, nlimbs: int, what: str, ndim: int = 2) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.dtype != np.int32:
        raise ValueError(f"{what}: expected int32, got {arr.dtype}")
    if arr.ndim != ndim or arr.shape[-2 if ndim == 2 else 1] != nlimbs:
        raise ValueError(f"{what}: expected {nlimbs} limbs, got shape {arr.shape}")
    if arr.size and (arr.min() < 0 or arr.max() > 0xFFFF):
        raise ValueError(f"{what}: limbs outside [0, 2^16)")
    return arr


def fr(arr, device=None) -> torch.Tensor:
    """(16, n) or (16, B, n) int32 Montgomery Fr limbs -> the same tensor
    on device."""
    device = _build.resolve_device(device)
    arr = np.asarray(arr)
    if arr.ndim not in (2, 3) or arr.shape[0] != FR.nlimbs:
        raise ValueError(f"fr: expected ({FR.nlimbs}, n) or ({FR.nlimbs}, B, n), "
                         f"got shape {arr.shape}")
    _limbs(arr.reshape(FR.nlimbs, -1), FR.nlimbs, "fr")
    return torch.from_numpy(np.array(arr)).to(device)


def points(x, y, z, device=None) -> g1.JacobianPoints:
    """(24, n) int32 Montgomery coordinates -> JacobianPoints on device."""
    device = _build.resolve_device(device)
    arrs = [_limbs(a, FQ.nlimbs, what) for a, what in ((x, "x"), (y, "y"), (z, "z"))]
    if not arrs[0].shape == arrs[1].shape == arrs[2].shape:
        raise ValueError(f"coordinate shapes differ: {[a.shape for a in arrs]}")
    return g1.JacobianPoints(*(torch.from_numpy(np.array(a)).to(device)
                               for a in arrs))


def puzzle_srs(x, y, z, tau_h=None, is_dev: bool = True, device=None) -> PuzzleSRS:
    """The JAX package's ``PuzzleSRS`` -> PuzzleSRS: its ``points`` (x, y, z),
    its ``srs_ref.tau_h`` (a pair of Fq2 int pairs; None: the dev SRS's,
    DEV_TAU H) and ``is_dev``. The host powers are decoded from the points;
    H is the G2 generator."""
    pts = points(x, y, z, device)
    if tau_h is None:
        tau_h = pairing.g2_scalar_mul(DEV_TAU, pairing.G2_GENERATOR)
    tau_h = tuple(tuple(int(v) for v in c) for c in tau_h)
    if len(tau_h) != 2 or any(len(c) != 2 for c in tau_h) or not pairing.g2_on_curve(tau_h):
        raise ValueError("tau_h: expected an affine G2 point ((x0, x1), (y0, y1))")
    coords = [FQ.decode_fast(np.asarray(a), mont=True) for a in (x, y, z)]
    powers = [(px, py, pz) for px, py, pz in zip(*coords)]
    srs_ref = ref_kzg.SRS(powers_g1=powers, h=pairing.G2_GENERATOR, tau_h=tau_h)
    return PuzzleSRS(degree=pts.x.shape[1] - 1, points=pts, srs_ref=srs_ref, is_dev=is_dev)


def epoch_program(epoch_hash: bytes, perms, sels, consts, device=None) -> EpochProgram:
    """The JAX package's ``EpochProgram`` (perms, sels, consts) ->
    EpochProgram."""
    device = _build.resolve_device(device)
    perms, sels, consts = np.asarray(perms), np.asarray(sels), np.asarray(consts)
    if perms.dtype != np.int32 or perms.ndim != 2 or perms.shape[0] != EPOCH_STEPS:
        raise ValueError(f"perms: expected int32 ({EPOCH_STEPS}, K), got "
                         f"{perms.dtype} {perms.shape}")
    k = perms.shape[1]
    if not (np.sort(perms, axis=1) == np.arange(k)).all():
        raise ValueError("perms: every row must be a permutation of range(K)")
    if sels.dtype != np.int32 or sels.shape != (EPOCH_STEPS, 1, k):
        raise ValueError(f"sels: expected int32 {(EPOCH_STEPS, 1, k)}, got "
                         f"{sels.dtype} {sels.shape}")
    if sels.size and (sels.min() < 0 or sels.max() > 3):
        raise ValueError("sels: selectors outside [0, 4)")
    consts = _limbs(consts, FR.nlimbs, "consts", ndim=3)
    if consts.shape != (EPOCH_STEPS, FR.nlimbs, k):
        raise ValueError(f"consts: expected {(EPOCH_STEPS, FR.nlimbs, k)}, got {consts.shape}")
    return EpochProgram.from_tensors(
        epoch_hash, *(torch.from_numpy(np.array(a)) for a in (perms, sels, consts)), device=device)


def _decode(cls, data: bytes):
    r = codec.Reader(bytes(data))
    out = cls.from_reader(r)
    r.expect_done()
    return out


def block(data: bytes) -> types.Block:
    """A block's bytes (the JAX ``Block.to_bytes()``) -> Block."""
    return types.Block.from_bytes(bytes(data))


def transaction(data: bytes) -> types.Transaction:
    """A transaction's bytes -> Transaction."""
    return _decode(types.Transaction, data)


def solution(data: bytes) -> types.Solution:
    """A solution's bytes -> Solution."""
    return _decode(types.Solution, data)


def committee(data: bytes) -> types.Committee:
    """A committee's bytes -> Committee."""
    return _decode(types.Committee, data)


def event(data: bytes):
    """A BFT event's bytes (the JAX ``events.serialize(event)``) -> the
    port's event of the same type."""
    return events.deserialize(bytes(data))


def certificate(data: bytes) -> types.BatchCertificate:
    """A batch certificate's bytes -> BatchCertificate."""
    return types.BatchCertificate.from_bytes(bytes(data))


def subdag(data: bytes) -> types.Subdag:
    """A committed subdag's bytes -> Subdag."""
    return _decode(types.Subdag, data)


def varuna_proof(data: bytes) -> varuna.VarunaProof:
    """A proof's bytes (the JAX ``VarunaProof.serialize()``) -> VarunaProof."""
    return varuna.VarunaProof.deserialize(bytes(data))


def ledger(committee_bytes: bytes, blocks, device=None) -> ledger_mod.Ledger:
    """A chain -> a port ``Ledger`` on ``device``: the committee's bytes and
    every block's bytes from the genesis on. The genesis seeds
    ``ledger._GENESIS_CACHE`` (so nothing is proved), and the later blocks
    are indexed as a stored chain is on load (``advance_to_next_block``,
    no checks)."""
    device = _build.resolve_device(device)
    comm = committee(committee_bytes)
    chain = [block(b) for b in blocks]
    if not chain or chain[0].height != 0:
        raise ValueError("the chain must start at the genesis block")
    cached = ledger_mod._GENESIS_CACHE.setdefault(comm.id, chain[0])
    if cached.to_bytes() != chain[0].to_bytes():
        raise ValueError("another genesis block is cached for this committee")
    out = ledger_mod.Ledger(comm, device=device)
    for blk in chain[1:]:
        out.advance_to_next_block(blk)
    return out
