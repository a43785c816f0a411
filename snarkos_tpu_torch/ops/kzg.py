"""KZG polynomial commitment, prover side (the port of the commit/open part
of ``snarkos_tpu/ops/kzg.py``).

The opening uses the closed form of the synthetic-division quotient:

    t_j = c_j z^j,  S_i = sum_{j >= i} t_j,  p(z) = S_0,  q_i = S_{i+1} z^-(i+1)

so it runs as O(log n) full-width passes and one power table instead of a
serial recurrence. The z = 0 corner (probability ~2^-253 under Fiat-Shamir)
falls back to the trivial shift q_i = c_{i+1}. Commit and open witnesses are
MSMs (ops/msm.py). Verification (pairings) is not ported yet.
"""

from __future__ import annotations

import torch

from snarkos_tpu_torch.crypto import params
from snarkos_tpu_torch.ops import g1, msm as msm_mod
from snarkos_tpu_torch.ops import modarith as fa
from snarkos_tpu_torch.ops.fieldspec import FR
from snarkos_tpu_torch.ops.ntt import geometric_powers

R = params.FR_MODULUS


def _suffix_sums(t: torch.Tensor) -> torch.Tensor:
    """(L, *batch, n) -> suffix sums S_i = sum_{j>=i} t_j via Hillis-Steele:
    ceil(log2 n) full-width shifted adds."""
    n = t.shape[-1]
    idx = torch.arange(n, device=t.device)
    cur = t
    for i in range(max(n - 1, 1).bit_length()):
        d = 1 << i
        shifted = torch.where(idx >= n - d, 0, torch.roll(cur, -d, dims=-1))
        cur = fa.add(FR, cur, shifted)
    return cur


def _eval_quotient_device(coeffs_mont: torch.Tensor, z_mont: torch.Tensor,
                          zinv_mont: torch.Tensor):
    """(L, *batch, n) Montgomery coefficients, (L, *batch, 1) z and z^-1 ->
    (y (L, *batch, 1), q (L, *batch, n)), q zero-padded at the top so its MSM
    has the commit MSM's shape."""
    n = coeffs_mont.shape[-1]
    t = fa.mont_mul(FR, coeffs_mont, geometric_powers(z_mont, n))
    s = _suffix_sums(t)
    y = s[..., :1]
    zinv_pows = geometric_powers(zinv_mont, n)
    s_next = torch.cat([s[..., 1:], torch.zeros_like(s[..., :1])], dim=-1)
    q = fa.mont_mul(FR, s_next, fa.mont_mul(FR, zinv_pows, zinv_mont))
    return y, q


def _encode(vals, device) -> torch.Tensor:
    return torch.from_numpy(FR.encode_fast(vals, mont=True)).to(device).contiguous()


def eval_and_quotient(coeffs_mont: torch.Tensor, z: int):
    """(L, n) Montgomery coefficients, host z -> (y = p(z) host int,
    quotient (L, n) Montgomery, zero-padded top)."""
    ys, q = eval_and_quotient_multi(coeffs_mont.unsqueeze(1), [z])
    return ys[0], q[:, 0]


def eval_and_quotient_multi(coeffs_mont: torch.Tensor, zs: list):
    """(L, B, n) Montgomery coefficients and B host points -> (ys host ints,
    quotients (L, B, n) Montgomery), one device pass for the whole batch."""
    zs = [z % R for z in zs]
    if any(z == 0 for z in zs):  # ~2^-253 corner: per-item shift
        ys, qs = [], []
        for i, z in enumerate(zs):
            c = coeffs_mont[:, i]
            if z == 0:
                ys.append(FR.decode_fast(c[:, :1].cpu().numpy(), mont=True)[0])
                qs.append(torch.cat([c[:, 1:], torch.zeros_like(c[:, :1])], dim=-1))
            else:
                y, q = eval_and_quotient(c, z)
                ys.append(y)
                qs.append(q)
        return ys, torch.stack(qs, dim=1)
    device = coeffs_mont.device
    z_mont = _encode(zs, device).unsqueeze(-1)
    zinv_mont = _encode([pow(z, -1, R) for z in zs], device).unsqueeze(-1)
    y, q = _eval_quotient_device(coeffs_mont, z_mont, zinv_mont)
    return FR.decode_fast(y[..., 0].cpu().numpy(), mont=True), q


def poly_eval(coeffs_mont: torch.Tensor, z: int) -> int:
    """p(z) for host z over device coefficients."""
    y, _ = eval_and_quotient(coeffs_mont, z)
    return y


def commit(points: g1.JacobianPoints, coeffs_mont: torch.Tensor) -> g1.JacobianPoints:
    """KZG commit = MSM(coeffs, SRS powers). points: (L, >= n) affine SRS;
    coeffs: (L, n) Montgomery Fr. Returns a 1-point batch."""
    n = coeffs_mont.shape[-1]
    pts = g1.JacobianPoints(points.x[:, :n], points.y[:, :n], points.z[:, :n])
    return msm_mod.msm(pts, fa.from_mont(FR, coeffs_mont))


def open_at(points: g1.JacobianPoints, coeffs_mont: torch.Tensor, z: int):
    """-> (y = p(z) host int, witness point (1-batch JacobianPoints)),
    witness = commit((p - y) / (X - z))."""
    y, q = eval_and_quotient(coeffs_mont, z)
    return y, commit(points, q)
