"""The puzzle prover (the port of the proving half of
``snarkos_tpu/ops/puzzle.py``).

  prove_batch(epoch_hash, address, nonces):
    1. seed_i  = sha256(epoch_hash || address || nonce_i) mod r
    2. leaves  = Poseidon(seed_i, j) for j < K        counter-mode sponge (B1's
                                                       fr_poseidon_permute)
    3. coeffs  = EpochProgram(epoch_hash)(leaves)     the per-epoch relation (B1's
                                                       fr_epoch_step, 12 launches)
    4. C_i     = KZG commit = multi-MSM over the SRS  (B2, B3, and B4 up to
                                                       8 nonces at 2^12, B5 above)
    5. z_i     = Poseidon(C_i.x)                      host Fiat-Shamir challenge
    6. y_i, q_i = p_i(z_i), (p_i - y_i)/(X - z_i)     closed-form eval/quotient (B1)
    7. W_i     = multi-MSM of the quotients           (as step 4)
    8. solution_id = sha64(C_i || y_i)

All B nonces go through one device path (one Poseidon batch, one epoch
program pass, one commit multi-MSM, one witness multi-MSM), B = 1 included.
The SRS is the deterministic dev setup from the known tau (not a ceremony);
verification and the production SRS wait for a later slice.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

import numpy as np
import torch

from snarkos_tpu_torch.crypto import params
from snarkos_tpu_torch.crypto.ref import g1 as ref_g1, poseidon as ref_poseidon
from snarkos_tpu_torch.ops import _build, g1, kzg, msm as msm_mod, poseidon
from snarkos_tpu_torch.ops import modarith as fa
from snarkos_tpu_torch.ops.fieldspec import FQ, FR

R = params.FR_MODULUS
COEFF_DOMAIN = "snarkos_tpu.puzzle.coeff"
CHALLENGE_DOMAIN = "snarkos_tpu.puzzle.challenge"

DEFAULT_LOG_DEGREE = 12
EPOCH_STEPS = 12
# the dev SRS's secret, known by construction (as in the JAX package)
DEV_TAU = pow(params.FR_GENERATOR, 0xDEADBEEF, R)


def _g1_to_bytes(p) -> bytes:
    """Reference Jacobian tuple -> 97-byte affine encoding."""
    a = ref_g1.affine(p)
    if a is None:
        return b"\x00" * 96 + b"\x01"
    return a[0].to_bytes(48, "little") + a[1].to_bytes(48, "little") + b"\x00"


def sha64(*parts: bytes) -> int:
    h = hashlib.sha256(hashlib.sha256(b"".join(parts)).digest()).digest()
    return int.from_bytes(h[:8], "little")


@dataclass
class PuzzleSRS:
    """Device-resident SRS powers [G, tau G, ..., tau^degree G], affine with
    z = Montgomery one, (L, degree + 1) per coordinate."""

    degree: int
    points: g1.JacobianPoints

    @classmethod
    def dev(cls, log_degree: int = DEFAULT_LOG_DEGREE, device=None) -> "PuzzleSRS":
        """The dev SRS from DEV_TAU, built on the device: one per-lane
        double-and-add of the generator by tau^i (kernel B2 on the card),
        then a batched conversion to affine (Fermat inversion, B1)."""
        device = _build.resolve_device(device)
        degree = 1 << log_degree
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
        return cls(degree=degree, points=g1.JacobianPoints(x, y, one))


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


def epoch_step_kernel(v: torch.Tensor, perm: torch.Tensor, sel: torch.Tensor,
                      const: torch.Tensor) -> torch.Tensor:
    """Launch ``fr_epoch_step`` (``csrc/mont_mul.cu``, kernel B1's Fr pass)
    on int32 CUDA tensors; writes a new (L, B, K) tensor."""
    L, B, K = v.shape if v.dim() == 3 else (None, None, None)
    _build.check(v, (FR.nlimbs, B, K), "epoch_step v")
    _build.check(perm, (K,), "epoch_step perm")
    _build.check(sel, (K,), "epoch_step sel")
    _build.check(const, (FR.nlimbs, K), "epoch_step const")
    out = torch.empty_like(v)
    if B and K:
        fn = _build.entry("mont_mul", "fr_epoch_step", 5, 2)
        _build.launch(fn, (v, perm, sel, const, out), (B, K), v.device)
        epoch_step_kernel.launches += 1
    return out


epoch_step_kernel.launches = 0


def epoch_step(v: torch.Tensor, perm: torch.Tensor, sel: torch.Tensor,
               const: torch.Tensor) -> torch.Tensor:
    """One step of the epoch program (``epoch_step_plain``): the kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    if v.device.type == "cpu":
        return epoch_step_plain(v, perm, sel, const)
    return epoch_step_kernel(*(t.to(torch.int32).contiguous() for t in (v, perm, sel, const)))


class EpochProgram:
    """Per-epoch tensors derived from the epoch hash: wiring permutations
    (EPOCH_STEPS, K), op selectors (EPOCH_STEPS, 1, K) and Montgomery
    constants (EPOCH_STEPS, L, K), all int32, from the same numpy stream as
    the JAX package."""

    def __init__(self, epoch_hash: bytes, k: int, device=None):
        seed = hashlib.sha256(b"snarkos_tpu.epoch.prog" + epoch_hash).digest()
        rng = np.random.default_rng(np.frombuffer(seed, dtype=np.uint32))
        perms = np.stack([rng.permutation(k) for _ in range(EPOCH_STEPS)]).astype(np.int32)
        sels = rng.integers(0, 4, size=(EPOCH_STEPS, 1, k), dtype=np.int32)
        consts = FR.random(EPOCH_STEPS * k, rng)  # uniform limbs = uniform
        consts = np.ascontiguousarray(consts.reshape(FR.nlimbs, EPOCH_STEPS, k).transpose(1, 0, 2))
        self._set(epoch_hash, *(torch.from_numpy(a).to(device) for a in (perms, sels, consts)))

    @classmethod
    def from_tensors(cls, epoch_hash: bytes, perms, sels, consts) -> "EpochProgram":
        prog = cls.__new__(cls)
        prog._set(epoch_hash, perms, sels, consts)
        return prog

    def _set(self, epoch_hash, perms, sels, consts):
        self.epoch_hash = epoch_hash
        self.perms, self.sels, self.consts = perms, sels, consts

    def apply(self, leaves: torch.Tensor) -> torch.Tensor:
        """(L, B, K) Montgomery leaves -> (L, B, K) coefficients: per step a
        partner vector by the wiring permutation and one of four forms per
        lane (v u + c, v^2 + u, v c - u, v^2 - u^2 + c), ``epoch_step``."""
        v = leaves
        for s in range(EPOCH_STEPS):
            v = epoch_step(v, self.perms[s], self.sels[s].reshape(-1), self.consts[s])
        return v

    def apply_host(self, leaves: list[int]) -> list[int]:
        """Host reference of ``apply`` over canonical ints (Montgomery form
        is transparent to the +/-/* mix)."""
        perms = self.perms.cpu().numpy()
        sels = self.sels.cpu().numpy()[:, 0, :]
        consts_c = [FR.decode_fast(self.consts[s].cpu().numpy(), mont=True)
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
    """The puzzle prover; one instance per process (holds the SRS).

    ``device=None`` runs on the card and raises without one; tests pass
    ``device="cpu"`` to run the plain versions of the kernels. ``srs``
    replaces the dev SRS (``convert.puzzle_srs`` hands over the JAX
    package's)."""

    def __init__(self, log_degree: int = DEFAULT_LOG_DEGREE, device=None,
                 srs: PuzzleSRS | None = None):
        self.device = _build.resolve_device(device)
        self.log_degree = log_degree
        self.k = 1 << log_degree
        self.srs = srs if srs is not None else PuzzleSRS.dev(log_degree, self.device)
        if self.srs.degree < self.k:
            raise ValueError(f"SRS of degree {self.srs.degree} < {self.k}")
        self._programs: dict[bytes, EpochProgram] = {}

    def epoch_program(self, epoch_hash: bytes) -> EpochProgram:
        """The per-epoch relation (small cache: current + adjacent epochs)."""
        prog = self._programs.get(epoch_hash)
        if prog is None:
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
        all_coeffs = self.coefficients(epoch_hash, address, nonces)
        pts = self._base()
        commit_jacs = g1.decode_points(msm_mod.msm_multi(pts, fa.from_mont(FR, all_coeffs)))
        c_bytes = [_g1_to_bytes(j) for j in commit_jacs]
        zs = [self._challenge(cb) for cb in c_bytes]
        ys, qs = kzg.eval_and_quotient_multi(all_coeffs, zs)
        wit_jacs = g1.decode_points(msm_mod.msm_multi(pts, fa.from_mont(FR, qs)))
        out = []
        for y, wj, cb in zip(ys, wit_jacs, c_bytes):
            solution_id = sha64(cb, y.to_bytes(32, "little"))
            if proof_target is not None and not self.passes_target(solution_id, proof_target):
                continue
            out.append(PuzzleSolutionData(commitment=cb, eval_y=y, witness=_g1_to_bytes(wj),
                                          solution_id=solution_id))
        return out

    def _challenge(self, c_bytes: bytes) -> int:
        cx = int.from_bytes(c_bytes[:48], "little") % R
        return ref_poseidon.hash1([cx], rate=2, domain=CHALLENGE_DOMAIN)

    @staticmethod
    def passes_target(solution_id: int, proof_target: int) -> bool:
        return solution_id <= (1 << 64) // max(proof_target, 1)


_PUZZLE: Puzzle | None = None


def global_puzzle(log_degree: int | None = None, device=None) -> Puzzle:
    """Process-wide puzzle instance (SRS built once)."""
    global _PUZZLE
    want = log_degree if log_degree is not None else (
        _PUZZLE.log_degree if _PUZZLE else int(os.environ.get(
            "SNARKOS_TPU_PUZZLE_LOG_DEGREE", DEFAULT_LOG_DEGREE)))
    if _PUZZLE is None or _PUZZLE.log_degree != want:
        _PUZZLE = Puzzle(want, device)
    return _PUZZLE
