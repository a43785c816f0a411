"""KZG polynomial commitment on the device (the port of
``snarkos_tpu/ops/kzg.py``).

The opening uses the closed form of the synthetic-division quotient:

    t_j = c_j z^j,  S_i = sum_{j >= i} t_j,  p(z) = S_0,  q_i = S_{i+1} z^-(i+1)

so it runs as O(log n) full-width passes and one power table instead of a
serial recurrence. The z = 0 corner (probability ~2^-253 under Fiat-Shamir)
falls back to the trivial shift q_i = c_{i+1}. Commit and open witnesses are
MSMs (ops/msm.py). ``batch_verify`` runs the point side of a random linear
combination of openings as two device MSMs and the two pairings on the host
(``crypto/ref/pairing.py``).
"""

from __future__ import annotations

import torch

from snarkos_tpu_torch.crypto import params
from snarkos_tpu_torch.crypto.ref import g1 as ref_g1, kzg as ref_kzg, pairing
from snarkos_tpu_torch.ops import _build, g1, msm as msm_mod
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


def verify(srs_ref: ref_kzg.SRS, commitment, z: int, y: int, witness) -> bool:
    """Single-opening pairing check on the host (2 pairings); commitment and
    witness are reference Jacobian tuples. e(C - yG, H) == e(W, tauH - zH)."""
    return ref_kzg.verify(srs_ref, commitment, z, y, witness)


def batch_verify(srs_ref: ref_kzg.SRS, openings, gamma: int | None = None,
                 device=None) -> bool:
    """Batch-verify [(C_i, z_i, y_i, W_i)] (reference Jacobian tuples) with
    two pairings in all:
        e(sum_i g^i (C_i - y_i G + z_i W_i), H) * e(-sum_i g^i W_i, tau H) == 1
    with g = gamma (default 5^8, ``crypto/ref/kzg.batch_verify``'s). The point
    side is one device MSM over [C_0..C_b, W_0..W_b, G] with scalars [g^i,
    g^i z_i, -sum g^i y_i] and one over the W_i with scalars g^i, each padded
    to a power of two >= 8 with generator lanes of scalar 0. Bases with an
    identity (a W of a constant polynomial) take the generic engine."""
    if not openings:
        return True
    device = _build.resolve_device(device)
    if gamma is None:
        gamma = pow(5, 8, R)
    coeffs, acc = [], 1
    for _ in openings:
        coeffs.append(acc)
        acc = acc * gamma % R
    c_pts = [o[0] for o in openings]
    w_pts = [o[3] for o in openings]
    zs = [o[1] % R for o in openings]
    ys = [o[2] % R for o in openings]
    neg_y_sum = (-sum(c * y for c, y in zip(coeffs, ys))) % R

    def padded_msm(pts, scalars):
        m = 1 << max(3, (len(pts) - 1).bit_length())
        pts = pts + [ref_g1.GENERATOR] * (m - len(pts))
        scalars = scalars + [0] * (m - len(scalars))
        out = msm_mod.msm(g1.encode_points(pts, device=device),
                          torch.from_numpy(FR.encode_fast(scalars)).to(device).contiguous())
        return g1.decode_points(out)[0]

    left = padded_msm(c_pts + w_pts + [ref_g1.GENERATOR],
                      coeffs + [c * z % R for c, z in zip(coeffs, zs)] + [neg_y_sum])
    acc_w = padded_msm(w_pts, list(coeffs))
    return pairing.pairing_check([(ref_g1.affine(left), srs_ref.h),
                                  (ref_g1.affine(ref_g1.neg(acc_w)), srs_ref.tau_h)])
