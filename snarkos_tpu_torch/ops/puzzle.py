"""The puzzle prover and verifier (the port of ``snarkos_tpu/ops/puzzle.py``).

  prove_batch(epoch_hash, address, nonces):
    1. seed_i  = sha256(epoch_hash || address || nonce_i) mod r
    2. leaves  = Poseidon(seed_i, j) for j < K        counter-mode sponge (B1's
                                                       fr_poseidon_permute, 1 launch)
    3. coeffs  = EpochProgram(epoch_hash)(leaves)     the per-epoch relation (B1's
                                                       fr_epoch_program or
                                                       fr_epoch_program_global
                                                       by epoch_plan(B, K);
                                                       1 launch)
    4. C_i     = KZG commit = multi-MSM over the SRS  (B2, B3, and B4 up to
                                                       8 nonces at 2^12, B5 above)
    5. z_i     = Poseidon(C_i.x)                      host Fiat-Shamir challenge
    6. y_i, q_i = p_i(z_i), (p_i - y_i)/(X - z_i)     closed-form eval/quotient (B1)
    7. W_i     = multi-MSM of the quotients           (as step 4)
    8. solution_id = sha64(C_i || y_i)

All B nonces go through one device path (one Poseidon batch, one epoch
program pass, one commit multi-MSM, one witness multi-MSM), B = 1 included.

  verify(solution): decode C and W, check y < r and the target
    (check_structural), re-derive the coefficients on the device through the
    epoch program and check y == p(z) (check_binding), then the pairing
    equation e(C - y G, H) == e(W, tau H - z H) on the host.
  verify_batch(items): the same checks per item, then one random linear
    combination of the openings (kzg.batch_verify: two device MSMs, two
    host pairings).

The SRS is the deterministic dev setup from the known tau, built on the
device, or the ceremony artifact that SNARKOS_TPU_SRS_PATH names
(``PuzzleSRS.from_artifact``, ``crypto/srs_artifact.py``).
"""

from __future__ import annotations

import hashlib
import os
import threading
from dataclasses import dataclass

import numpy as np
import torch

from snarkos_tpu_torch.crypto import params, srs_artifact
from snarkos_tpu_torch.crypto.ref import g1 as ref_g1, kzg as ref_kzg, pairing
from snarkos_tpu_torch.crypto.ref import poseidon as ref_poseidon
from snarkos_tpu_torch.ops import _build, g1, kzg, msm as msm_mod, poseidon
from snarkos_tpu_torch.ops import modarith as fa
from snarkos_tpu_torch.ops.fieldspec import FQ, FR
from snarkos_tpu_torch.utils import tracing

R = params.FR_MODULUS
COEFF_DOMAIN = "snarkos_tpu.puzzle.coeff"
CHALLENGE_DOMAIN = "snarkos_tpu.puzzle.challenge"

DEFAULT_LOG_DEGREE = 12
EPOCH_STEPS = 12
# blocks a nonce in the one-launch epoch program, at most: a cluster of 16 (a
# non-portable size, which the H100 takes) puts 256 of the 4096 lanes on
# each SM, so that prove_batch(8)'s 8 nonces use 128 SMs (a cluster of 8:
# 64); scripts/sweep_fr_passes.py times both sizes
EPOCH_CLUSTER = 16
# the shared memory a block of the cluster variant may hold: its lanes' two
# buffers, 64 bytes a lane
EPOCH_SMEM_MAX = 227 * 1024
# the B x K lanes from which the global variant runs the program faster than
# the cluster variant (chip_smoke.py phase 2 times both at every shape a
# path launches; PERF.md, the epoch rule)
EPOCH_GLOBAL_MIN_LANES = 1 << 15
# the dev SRS's secret, known by construction (as in the JAX package)
DEV_TAU = pow(params.FR_GENERATOR, 0xDEADBEEF, R)


def _g1_to_bytes(p) -> bytes:
    """Reference Jacobian tuple -> 97-byte affine encoding."""
    a = ref_g1.affine(p)
    if a is None:
        return b"\x00" * 96 + b"\x01"
    return a[0].to_bytes(48, "little") + a[1].to_bytes(48, "little") + b"\x00"


def _g1_from_bytes(b: bytes):
    """97-byte affine encoding -> reference Jacobian tuple; raises ValueError
    on a bad length, a non-canonical coordinate or a point off the curve."""
    if len(b) != 97:
        raise ValueError("bad G1 encoding length")
    if b[96] == 1:
        return ref_g1.INFINITY
    x = int.from_bytes(b[:48], "little")
    y = int.from_bytes(b[48:96], "little")
    q = params.FQ_MODULUS
    if x >= q or y >= q:
        raise ValueError("non-canonical G1 coordinate")
    p = (x, y, 1)
    if not ref_g1.on_curve(p):
        raise ValueError("point not on curve")
    return p


def sha64(*parts: bytes) -> int:
    h = hashlib.sha256(hashlib.sha256(b"".join(parts)).digest()).digest()
    return int.from_bytes(h[:8], "little")


@dataclass
class PuzzleSRS:
    """Device-resident SRS powers [G, tau G, ..., tau^degree G], affine with
    z = Montgomery one, (L, degree + 1) per coordinate, and ``srs_ref``, the
    host copy the verifier reads (its powers as reference tuples, H and
    tau H). ``is_dev`` is True when tau is the known DEV_TAU, False for a
    ceremony artifact."""

    degree: int
    points: g1.JacobianPoints
    srs_ref: ref_kzg.SRS
    is_dev: bool = True

    @classmethod
    def from_artifact(cls, path: str, digest: str | None = None,
                      log_degree: int = DEFAULT_LOG_DEGREE, device=None) -> "PuzzleSRS":
        """Load a ceremony powers-of-tau artifact (``crypto/srs_artifact.py``:
        digest pin, on-curve and pairing consistency checks, the check's MSMs
        on ``device``). The device gets the first 2^log_degree + 1 powers; the
        whole artifact stays on ``srs_ref``."""
        device = _build.resolve_device(device)
        srs_ref = srs_artifact.load_srs(path, digest, device=device)
        degree = 1 << log_degree
        if len(srs_ref.powers_g1) < degree + 1:
            raise srs_artifact.SRSArtifactError(
                f"SRS artifact holds {len(srs_ref.powers_g1)} powers; the "
                f"puzzle needs {degree + 1}")
        pts = g1.encode_points(srs_ref.powers_g1[:degree + 1], device=device)
        return cls(degree=degree, points=pts, srs_ref=srs_ref, is_dev=False)

    @classmethod
    def dev(cls, log_degree: int = DEFAULT_LOG_DEGREE, device=None) -> "PuzzleSRS":
        """The dev SRS of degree 2^log_degree (``dev_powers``)."""
        return cls.dev_powers(1 << log_degree, device)

    @classmethod
    def dev_powers(cls, degree: int, device=None) -> "PuzzleSRS":
        """The dev SRS [G, ..., DEV_TAU^degree G] of any degree, built on the
        device: one per-lane double-and-add of the generator by tau^i (kernel
        B2 on the card), then a batched conversion to affine (Fermat
        inversion, B1). The host copy holds the decoded powers, H = the G2
        generator and tau H. The ledger's execution SRSs above the puzzle's
        degree are built here."""
        device = _build.resolve_device(device)
        taus, acc = [], 1
        for _ in range(degree + 1):
            taus.append(acc)
            acc = acc * DEV_TAU % R
        scalars = torch.from_numpy(FR.encode_fast(taus)).to(device).contiguous()
        gen = g1.encode_points([ref_g1.GENERATOR], device=device)
        gen = g1.JacobianPoints(*(t.expand(-1, degree + 1).contiguous()
                                  for t in (gen.x, gen.y, gen.z)))
        x, y, _ = g1.to_affine(g1.scalar_mul(gen, scalars))
        one = fa.broadcast_const(FQ, 1, (degree + 1,), device=device).contiguous()
        xs = FQ.decode_fast(x.cpu().numpy(), mont=True)
        ys = FQ.decode_fast(y.cpu().numpy(), mont=True)
        h = pairing.G2_GENERATOR
        srs_ref = ref_kzg.SRS(powers_g1=[(px, py, 1) for px, py in zip(xs, ys)], h=h,
                              tau_h=pairing.g2_scalar_mul(DEV_TAU, h))
        return cls(degree=degree, points=g1.JacobianPoints(x, y, one), srs_ref=srs_ref)

    def trim(self, degree: int) -> "PuzzleSRS":
        """The first degree + 1 powers, on the device and the host, with the
        same H and tau H (an artifact's host copy may hold more powers than
        its device points: those are encoded onto the device)."""
        p, n, ref = self.points, degree + 1, self.srs_ref
        if len(ref.powers_g1) < n:
            raise ValueError(f"SRS of degree {len(ref.powers_g1) - 1} < {degree}")
        if degree > self.degree:  # an artifact's host powers beyond the device's
            pts = g1.encode_points(ref.powers_g1[:n], device=p.x.device)
        else:
            pts = g1.JacobianPoints(p.x[:, :n], p.y[:, :n], p.z[:, :n])
        return PuzzleSRS(degree=degree, points=pts,
                         srs_ref=ref_kzg.SRS(powers_g1=ref.powers_g1[:n], h=ref.h,
                                             tau_h=ref.tau_h),
                         is_dev=self.is_dev)


def epoch_step_plain(v: torch.Tensor, perm: torch.Tensor, sel: torch.Tensor,
                     const: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of one epoch-program step, on any device: v
    (L, B, K) Montgomery, perm and sel (K,) int32, const (L, K) Montgomery.
    Lane (b, k) pairs v with u = v[:, b, perm[k]] and takes, by sel[k], v u
    + c, v^2 + u, v c - u or v^2 - u^2 + c."""
    u = v[..., perm.long()]
    cb = const.unsqueeze(1)  # broadcast over the nonce batch
    sb = sel.reshape(1, 1, -1)
    prod_vu = fa.mont_mul_plain(FR, v, u)
    v2 = fa.mont_mul_plain(FR, v, v)
    u2 = fa.mont_mul_plain(FR, u, u)
    prod_vc = fa.mont_mul_plain(FR, v, cb)
    cand0 = fa.add(FR, prod_vu, cb)
    cand1 = fa.add(FR, v2, u)
    cand2 = fa.sub(FR, prod_vc, u)
    cand3 = fa.add(FR, fa.sub(FR, v2, u2), cb)
    return torch.where(sb == 0, cand0, torch.where(
        sb == 1, cand1, torch.where(sb == 2, cand2, cand3)))


def epoch_plan(b: int, k: int) -> tuple:
    """The epoch program's kernel for B nonces of K lanes: ``("cluster", C,
    kb)``, a cluster of C = min(EPOCH_CLUSTER, the largest power of two <=
    K) blocks a nonce, block rank q holding lanes [q kb, min(K, (q + 1)
    kb)), kb = ceil(K / C), when B K < EPOCH_GLOBAL_MIN_LANES (so K is far
    below the cluster's limit, ``epoch_cluster``); else ``("global", None,
    None)``, the lanes in global memory."""
    if b < 1 or k < 1:
        raise ValueError(f"epoch program: B = {b} nonces, K = {k} lanes")
    if b * k < EPOCH_GLOBAL_MIN_LANES:
        return ("cluster", *epoch_cluster(k))
    return ("global", None, None)


def epoch_cluster(k: int):
    """The cluster variant's (C, kb) at K >= 1 lanes a nonce, as
    ``epoch_plan`` describes it; None when a block's two buffers would pass
    EPOCH_SMEM_MAX (K > 58,112), the most ``fr_epoch_program`` takes."""
    c = min(EPOCH_CLUSTER, 1 << (k.bit_length() - 1))
    kb = -(-k // c)
    return (c, kb) if 64 * kb <= EPOCH_SMEM_MAX else None


def side_tables(perms: torch.Tensor, sels: torch.Tensor, consts: torch.Tensor,
                device=None) -> tuple:
    """The epoch program as both kernels read it, built with torch ops on
    ``device`` (default: where ``consts`` lies) a step at a time: ``ps`` (S,
    K) int32, perm | sel << 30 (K < 2^30), and ``cw`` (S, K, 8) int32, each
    constant's 16 limbs as 8 Montgomery words (word w = limb 2w | limb 2w +
    1 << 16), 32 contiguous bytes a lane."""
    S, K = perms.shape
    if K >= 1 << 30:
        raise ValueError(f"epoch program: K = {K} lanes does not fit the wiring word")
    device = consts.device if device is None else device

    def to_int32(w):  # the low 32 bits, as int32
        return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)

    ps = to_int32(perms.to(device).long() | (sels.reshape(S, K).to(device).long() << 30))
    cw = torch.empty((S, K, FR.nlimbs // 2), dtype=torch.int32, device=device)
    for s in range(S):  # int64 temporaries of one step
        limbs = consts[s].to(device).long()
        cw[s] = to_int32(limbs[0::2] | (limbs[1::2] << 16)).T
    return ps.contiguous(), cw


def _check_program(leaves, ps, cw):
    L, B, K = leaves.shape if leaves.dim() == 3 else (None, None, None)
    S = ps.shape[0] if ps.dim() == 2 else None
    _build.check(leaves, (FR.nlimbs, B, K), "epoch program leaves")
    _build.check(ps, (S, K), "epoch program wiring words")
    _build.check(cw, (S, K, FR.nlimbs // 2), "epoch program constant words")
    return B, K, S


@_build.counted
def program_kernel_cluster(leaves: torch.Tensor, ps: torch.Tensor, cw: torch.Tensor,
                           cluster: int) -> torch.Tensor:
    """Launch ``fr_epoch_program`` (``csrc/fr_passes.cu``, kernel B1's Fr
    pass) on int32 CUDA tensors: every step of the program in one launch,
    leaves (L, B, K) and the program's ``side_tables`` ps (S, K) and cw (S,
    K, 8); writes a new (L, B, K) tensor. A nonce is one cluster of
    ``cluster`` blocks, each holding its ceil(K / cluster) lanes' two
    buffers in shared memory."""
    B, K, S = _check_program(leaves, ps, cw)
    out = torch.empty_like(leaves)
    if B and K:
        fn = _build.entry("fr_passes", "fr_epoch_program", 4, 4)
        _build.launch(fn, (leaves, ps, cw, out), (B, K, S, cluster), leaves.device)
        _build.count(program_kernel_cluster)
    return out


@_build.counted
def program_kernel_global(leaves: torch.Tensor, ps: torch.Tensor,
                          cw: torch.Tensor) -> torch.Tensor:
    """Launch ``fr_epoch_program_global`` on int32 CUDA tensors: leaves (L,
    B, K) and the program's ``side_tables`` ps (S, K) and cw (S, K, 8); one
    cooperative launch, the lanes in two global buffers (a scratch tensor
    the size of the output) with a lane's B nonces side by side, a grid
    barrier a step; writes a new (L, B, K) tensor."""
    B, K, S = _check_program(leaves, ps, cw)
    out = torch.empty_like(leaves)
    if B and K:
        scratch = torch.empty_like(leaves)
        fn = _build.entry("fr_passes", "fr_epoch_program_global", 5, 3)
        _build.launch(fn, (leaves, ps, cw, out, scratch), (B, K, S), leaves.device)
        _build.count(program_kernel_global)
    return out


def program_kernel(leaves: torch.Tensor, prog: "EpochProgram") -> torch.Tensor:
    """The epoch program ``prog`` on (L, B, K) int32 CUDA leaves: one launch
    of the kernel that ``epoch_plan(B, K)`` names, on the program's side
    tables."""
    kind, cluster, _ = epoch_plan(*leaves.shape[1:]) if leaves.dim() == 3 else (None,) * 3
    if kind == "cluster":
        return program_kernel_cluster(leaves, *prog.side_tables(), cluster)
    return program_kernel_global(leaves, *prog.side_tables())


class EpochProgram:
    """Per-epoch tensors derived from the epoch hash: wiring permutations
    (EPOCH_STEPS, K), op selectors (EPOCH_STEPS, 1, K) and Montgomery
    constants (EPOCH_STEPS, L, K), all int32 on the host, from the same
    numpy stream as the JAX package (the plain and host versions read
    them); and the kernels' ``side_tables``, built on ``device`` on first
    use."""

    def __init__(self, epoch_hash: bytes, k: int, device=None):
        seed = hashlib.sha256(b"snarkos_tpu.epoch.prog" + epoch_hash).digest()
        rng = np.random.default_rng(np.frombuffer(seed, dtype=np.uint32))
        perms = np.stack([rng.permutation(k) for _ in range(EPOCH_STEPS)]).astype(np.int32)
        sels = rng.integers(0, 4, size=(EPOCH_STEPS, 1, k), dtype=np.int32)
        consts = FR.random(EPOCH_STEPS * k, rng)  # uniform limbs = uniform
        consts = np.ascontiguousarray(consts.reshape(FR.nlimbs, EPOCH_STEPS, k).transpose(1, 0, 2))
        self._set(epoch_hash, *(torch.from_numpy(a) for a in (perms, sels, consts)),
                  torch.device("cpu") if device is None else torch.device(device))

    @classmethod
    def from_tensors(cls, epoch_hash: bytes, perms, sels, consts, device=None) -> "EpochProgram":
        """The program of the given tensors, its side tables built on
        ``device`` (default: where ``perms`` lies)."""
        prog = cls.__new__(cls)
        prog._set(epoch_hash, perms, sels, consts,
                  perms.device if device is None else torch.device(device))
        return prog

    def _set(self, epoch_hash, perms, sels, consts, device):
        self.epoch_hash, self.device = epoch_hash, device
        self.perms, self.sels, self.consts = (t.cpu() for t in (perms, sels, consts))
        self._tables = None

    def side_tables(self) -> tuple:
        """(ps, cw) of ``side_tables`` on the program's device, built once."""
        if self._tables is None:
            self._tables = side_tables(self.perms, self.sels, self.consts, self.device)
        return self._tables

    def apply(self, leaves: torch.Tensor) -> torch.Tensor:
        """(L, B, K) Montgomery leaves -> (L, B, K) coefficients: per step a
        partner vector by the wiring permutation and one of four forms per
        lane (v u + c, v^2 + u, v c - u, v^2 - u^2 + c). One launch of
        ``program_kernel`` on a CUDA tensor, ``apply_plain`` on a CPU
        tensor."""
        if leaves.device.type == "cpu":
            return self.apply_plain(leaves)
        return program_kernel(leaves.to(torch.int32).contiguous(), self)

    def apply_plain(self, leaves: torch.Tensor) -> torch.Tensor:
        """Plain PyTorch version of ``apply``: ``epoch_step_plain`` once a
        step, on any device."""
        v = leaves
        for s in range(EPOCH_STEPS):
            v = epoch_step_plain(v, *(t[s].to(v.device) for t in (
                self.perms, self.sels.reshape(self.perms.shape), self.consts)))
        return v

    def apply_host(self, leaves: list[int]) -> list[int]:
        """Host reference of ``apply`` over canonical ints (Montgomery form
        is transparent to the +/-/* mix)."""
        perms = self.perms.numpy()
        sels = self.sels.numpy()[:, 0, :]
        consts_c = [FR.decode_fast(self.consts[s].numpy(), mont=True)
                    for s in range(EPOCH_STEPS)]
        v = list(leaves)
        k = len(v)
        for s in range(EPOCH_STEPS):
            perm, sel, c = perms[s], sels[s], consts_c[s]
            u = [v[perm[i]] for i in range(k)]
            nv = [0] * k
            for i in range(k):
                if sel[i] == 0:
                    nv[i] = (v[i] * u[i] + c[i]) % R
                elif sel[i] == 1:
                    nv[i] = (v[i] * v[i] + u[i]) % R
                elif sel[i] == 2:
                    nv[i] = (v[i] * c[i] - u[i]) % R
                else:
                    nv[i] = (v[i] * v[i] - u[i] * u[i] + c[i]) % R
            v = nv
        return v


@dataclass(frozen=True)
class PuzzleSolutionData:
    """prove() output, before serialization."""

    commitment: bytes  # 97
    eval_y: int
    witness: bytes  # 97
    solution_id: int  # sha64(C || y)


class Puzzle:
    """The puzzle prover and verifier; one instance per process (holds the
    SRS).

    ``device=None`` runs on the card and raises without one; tests pass
    ``device="cpu"`` to run the plain versions of the kernels. Without
    ``srs`` the SRS comes from the environment, as in the JAX package: the
    ceremony artifact at SNARKOS_TPU_SRS_PATH, pinned to
    SNARKOS_TPU_SRS_DIGEST when that is set and not empty
    (``PuzzleSRS.from_artifact``), else the dev SRS. ``srs`` given wins
    (``convert.puzzle_srs`` hands over the JAX package's)."""

    def __init__(self, log_degree: int = DEFAULT_LOG_DEGREE, device=None,
                 srs: PuzzleSRS | None = None):
        self.device = _build.resolve_device(device)
        self.log_degree = log_degree
        self.k = 1 << log_degree
        if srs is None:
            srs_path = os.environ.get("SNARKOS_TPU_SRS_PATH")
            if srs_path:
                srs = PuzzleSRS.from_artifact(
                    srs_path, os.environ.get("SNARKOS_TPU_SRS_DIGEST") or None,
                    log_degree, device=self.device)
            else:
                srs = PuzzleSRS.dev(log_degree, self.device)
        self.srs = srs
        if self.srs.degree < self.k:
            raise ValueError(f"SRS of degree {self.srs.degree} < {self.k}")
        self._programs: dict[bytes, EpochProgram] = {}
        self._programs_lock = threading.Lock()

    def epoch_program(self, epoch_hash: bytes) -> EpochProgram:
        """The per-epoch relation (small cache: current + adjacent epochs),
        built once: threads that ask for it together wait for one build."""
        with self._programs_lock:
            prog = self._programs.get(epoch_hash)
            if prog is None:
                tracing.count("epoch_program.build")
                prog = EpochProgram(epoch_hash, self.k, self.device)
                if len(self._programs) > 4:
                    self._programs.clear()
                self._programs[epoch_hash] = prog
            return prog

    def _leaves_device(self, seed_fields: list[int]) -> torch.Tensor:
        """(L, B, K) Montgomery Fr leaves via counter-mode Poseidon, one
        batched sponge for all B nonces."""
        k, b = self.k, len(seed_fields)
        seed = torch.cat([fa.broadcast_const(FR, s, (k,), device=self.device)
                          for s in seed_fields], dim=-1)
        idx = torch.arange(k, dtype=torch.int32, device=self.device).repeat(b)
        ctr = torch.zeros((FR.nlimbs, b * k), dtype=torch.int32, device=self.device)
        ctr[0] = idx & 0xFFFF
        ctr[1] = idx >> 16
        inputs = torch.stack([seed, fa.to_mont(FR, ctr)])  # (2, L, B*K)
        leaves = poseidon.hash_fixed(inputs, rate=2, domain=COEFF_DOMAIN)[0]
        return leaves.reshape(FR.nlimbs, b, k)

    def _seed_field(self, epoch_hash: bytes, address: str, nonce: int) -> int:
        h = hashlib.sha256(epoch_hash + address.encode() + nonce.to_bytes(8, "little")).digest()
        return int.from_bytes(h, "little") % R

    def coefficients(self, epoch_hash: bytes, address: str, nonces) -> torch.Tensor:
        """(L, B, K) Montgomery coefficients of the nonces' polynomials."""
        with tracing.span("prove.coefficients", "Puzzle.coefficients"):
            seeds = [self._seed_field(epoch_hash, address, n) for n in nonces]
            return self.epoch_program(epoch_hash).apply(self._leaves_device(seeds))

    def _base(self) -> g1.JacobianPoints:
        p = self.srs.points
        return g1.JacobianPoints(p.x[:, :self.k], p.y[:, :self.k], p.z[:, :self.k])

    # -- proving -------------------------------------------------------------
    def prove(self, epoch_hash: bytes, address: str, nonce: int,
              proof_target: int | None = None) -> PuzzleSolutionData | None:
        """One puzzle iteration; None if the target is missed."""
        out = self.prove_batch(epoch_hash, address, [nonce], proof_target)
        return out[0] if out else None

    def prove_batch(self, epoch_hash: bytes, address: str, nonces,
                    proof_target: int | None = None) -> list:
        """Prove B nonces in one device pass; returns the PuzzleSolutionData
        of the nonces that pass the target, in order."""
        nonces = list(nonces)
        if not nonces:
            return []
        with tracing.span("prove.batch", "Puzzle.prove_batch"):
            all_coeffs = self.coefficients(epoch_hash, address, nonces)
            pts = self._base()
            commit_jacs = g1.decode_points(msm_mod.msm_multi(pts, fa.from_mont(FR, all_coeffs)))
            with tracing.span("host.decode", "Puzzle.prove_batch"):
                c_bytes = [_g1_to_bytes(j) for j in commit_jacs]
            with tracing.span("host.challenge", "Puzzle.prove_batch"):
                zs = [self._challenge(cb) for cb in c_bytes]
            ys, qs = kzg.eval_and_quotient_multi(all_coeffs, zs)
            wit_jacs = g1.decode_points(msm_mod.msm_multi(pts, fa.from_mont(FR, qs)))
            with tracing.span("host.decode", "Puzzle.prove_batch"):
                w_bytes = [_g1_to_bytes(wj) for wj in wit_jacs]
            with tracing.span("host.ids", "Puzzle.prove_batch"):
                out = []
                for y, wb, cb in zip(ys, w_bytes, c_bytes):
                    solution_id = sha64(cb, y.to_bytes(32, "little"))
                    if proof_target is not None and not self.passes_target(solution_id,
                                                                           proof_target):
                        continue
                    out.append(PuzzleSolutionData(commitment=cb, eval_y=y, witness=wb,
                                                  solution_id=solution_id))
                return out

    def _challenge(self, c_bytes: bytes) -> int:
        cx = int.from_bytes(c_bytes[:48], "little") % R
        return ref_poseidon.hash1([cx], rate=2, domain=CHALLENGE_DOMAIN)

    @staticmethod
    def passes_target(solution_id: int, proof_target: int) -> bool:
        return solution_id <= (1 << 64) // max(proof_target, 1)

    # -- verification --------------------------------------------------------
    def check_binding(self, epoch_hash: bytes, address: str, nonce: int,
                      commitment: bytes, eval_y: int) -> bool:
        """The epoch-relation binding: re-derive the coefficients of
        (epoch_hash, address, nonce) on the device (B1's Poseidon sponge
        and epoch program) and check eval_y == p(z) at the Fiat-Shamir
        challenge z(C). With the pairing check, which proves the committed
        polynomial opens to eval_y at z, this forces the committed polynomial
        to be the epoch-derived one whp."""
        coeffs_mont = self.coefficients(epoch_hash, address, [nonce])[:, 0]
        z = self._challenge(commitment)
        return kzg.poly_eval(coeffs_mont, z) == eval_y % R

    def verify(self, epoch_hash: bytes, address: str, nonce: int,
               commitment: bytes, eval_y: int, witness: bytes,
               proof_target: int) -> bool:
        """One solution: structure and target, the epoch binding, then the
        pairing equation on the host."""
        opening = self.check_structural(commitment, eval_y, witness, proof_target)
        if opening is None:
            return False
        if not self.check_binding(epoch_hash, address, nonce, commitment, eval_y):
            return False
        c_pt, z, y, w_pt = opening
        return ref_kzg.verify(self.srs.srs_ref, c_pt, z, y, w_pt)

    def check_structural(self, commitment: bytes, eval_y: int, witness: bytes,
                         proof_target: int):
        """Everything but the pairing equation and the binding: decoding,
        canonical coordinates, y < r, the target. Returns the (C, z, y, W)
        opening, or None if the solution is structurally invalid."""
        try:
            c_pt = _g1_from_bytes(commitment)
            w_pt = _g1_from_bytes(witness)
        except ValueError:
            return None
        if not (0 <= eval_y < R):
            return None
        solution_id = sha64(commitment, eval_y.to_bytes(32, "little"))
        if not self.passes_target(solution_id, proof_target):
            return None
        z = self._challenge(commitment)
        return (c_pt, z, eval_y, w_pt)

    def verify_batch(self, items) -> bool:
        """All-or-nothing check of many solutions with two pairings in all.
        items: (epoch_hash, address, nonce, commitment, eval_y, witness,
        proof_target) tuples. The structural and binding checks run per item,
        in order, and the first failure returns False; the openings then go
        through one ``kzg.batch_verify`` (one opening: the host ``verify``).
        Callers fall back to ``verify`` to find an offender."""
        openings = []
        for epoch_hash, address, nonce, commitment, eval_y, witness, proof_target in items:
            opening = self.check_structural(commitment, eval_y, witness, proof_target)
            if opening is None:
                return False
            if not self.check_binding(epoch_hash, address, nonce, commitment, eval_y):
                return False
            openings.append(opening)
        if not openings:
            return True
        if len(openings) == 1:
            c_pt, z, y, w_pt = openings[0]
            return ref_kzg.verify(self.srs.srs_ref, c_pt, z, y, w_pt)
        return kzg.batch_verify(self.srs.srs_ref, openings, device=self.device)


_PUZZLE: Puzzle | None = None
_PUZZLE_LOCK = threading.Lock()


def global_puzzle(log_degree: int | None = None, device=None) -> Puzzle:
    """Process-wide puzzle instance (SRS built once), kept for one (log
    degree, device) at a time: a call for another log degree or another
    device builds a new one. ``log_degree`` None takes the cached one's, else
    SNARKOS_TPU_PUZZLE_LOG_DEGREE; ``device`` None means the card. The SRS
    environment (``Puzzle``) is read when an instance is built and is not
    part of the key, as in the JAX package: after changing it, set
    ``_PUZZLE`` to None."""
    global _PUZZLE
    dev = _build.resolve_device(device)
    with _PUZZLE_LOCK:  # one build when threads ask together
        want = log_degree if log_degree is not None else (
            _PUZZLE.log_degree if _PUZZLE else int(os.environ.get(
                "SNARKOS_TPU_PUZZLE_LOG_DEGREE", DEFAULT_LOG_DEGREE)))
        if _PUZZLE is None or (_PUZZLE.log_degree, _PUZZLE.device) != (want, dev):
            _PUZZLE = Puzzle(want, dev)
        return _PUZZLE
