"""SRS artifacts: powers-of-tau files with digest pinning (the port's own
copy of ``snarkos_tpu/crypto/srs_artifact.py``; the same format, so either
package reads what the other wrote).

Artifact format (little-endian, all field elements 48-byte LE):

    magic   b"SNARKOS_TPU_SRS1"   (16 bytes)
    degree  u64                   (number of powers = degree + 1)
    g1      (degree+1) * 96 B     affine (x, y) per power of tau
    tau_h   192 B                 G2 affine ((x0, x1), (y0, y1))

H is pinned to the canonical G2 generator (as in a standard ceremony),
so the only G2 artifact datum is tau_h. Validation (``load_srs`` with
``check=True``) does NOT require knowing tau:

    1. optional digest pinning: sha256 of the file bytes must equal the
       caller-pinned digest;
    2. powers[0] == G1 generator, every power on-curve;
    3. random-linear-combination pairing consistency:
       e(sum_i r_i P_{i+1}, H) == e(sum_i r_i P_i, tau_H) with fresh
       random r_i — holds iff P_{i+1} = tau * P_i for all i (except with
       probability ~|r|/p), which also authenticates tau_h itself. The two
       sums are MSMs on the device (``ops/msm.py``), the pairings run on the
       host.
"""

from __future__ import annotations

import hashlib
import os
import secrets

import torch

from snarkos_tpu_torch.crypto import params
from snarkos_tpu_torch.crypto.ref import g1, kzg, pairing
from snarkos_tpu_torch.ops import _build, g1 as g1_ops, msm
from snarkos_tpu_torch.ops.fieldspec import FR

R = params.FR_MODULUS
MAGIC = b"SNARKOS_TPU_SRS1"
_FQ_BYTES = 48


class SRSArtifactError(ValueError):
    """Malformed, mismatched-digest, or cryptographically inconsistent
    SRS artifact."""


def _enc_fq(v: int) -> bytes:
    return int(v).to_bytes(_FQ_BYTES, "little")


def _dec_fq(b: bytes) -> int:
    return int.from_bytes(b, "little")


def _enc_g2(q) -> bytes:
    (x0, x1), (y0, y1) = q
    return _enc_fq(x0) + _enc_fq(x1) + _enc_fq(y0) + _enc_fq(y1)


def _dec_g2(b: bytes):
    vals = [_dec_fq(b[i * _FQ_BYTES:(i + 1) * _FQ_BYTES]) for i in range(4)]
    return ((vals[0], vals[1]), (vals[2], vals[3]))


def save_srs(path: str, srs: kzg.SRS) -> str:
    """Serialize ``srs`` to ``path``; returns the artifact's hex digest (pin
    it and pass it to ``load_srs``)."""
    out = [MAGIC, (len(srs.powers_g1) - 1).to_bytes(8, "little")]
    for p in srs.powers_g1:
        ax, ay = g1.affine(p)
        out.append(_enc_fq(ax) + _enc_fq(ay))
    out.append(_enc_g2(srs.tau_h))
    raw = b"".join(out)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(raw)
    os.replace(tmp, path)
    return hashlib.sha256(raw).hexdigest()


def _consistency_check(powers: list, tau_h, device) -> bool:
    """RLC pairing check: e(sum r_i P_{i+1}, H) == e(sum r_i P_i, tau_H); the
    two sums are device MSMs over the affine powers."""
    n = len(powers) - 1
    if n < 1:
        return powers[0] == (params.G1_GENERATOR_X, params.G1_GENERATOR_Y)
    rs = [secrets.randbelow(R - 1) + 1 for _ in range(n)]
    pts = g1_ops.encode_points([g1.from_affine(p) for p in powers], device=device)
    scalars = torch.from_numpy(FR.encode_fast(rs)).to(device).contiguous()

    def sum_at(lo):
        part = g1_ops.JacobianPoints(*(t[:, lo:lo + n] for t in (pts.x, pts.y, pts.z)))
        return g1.affine(g1_ops.decode_points(msm.msm(part, scalars))[0])

    hi, lo = sum_at(1), sum_at(0)
    if hi is None or lo is None:  # RLC hit infinity: resample would fix;
        return False               # treat as failure (prob ~2^-253)
    return pairing.pairing_check([
        (hi, pairing.G2_GENERATOR),
        ((lo[0], params.FQ_MODULUS - lo[1]), tau_h),  # -lo
    ])


def load_srs(path: str, expected_digest: str | None = None,
             check: bool = True, device=None) -> kzg.SRS:
    """Load, digest-pin, and validate an SRS artifact -> ``kzg.SRS``. The
    consistency check's MSMs run on ``device`` (None: the card)."""
    device = _build.resolve_device(device)
    with open(path, "rb") as f:
        raw = f.read()
    if expected_digest is not None:
        got = hashlib.sha256(raw).hexdigest()
        if got != expected_digest.lower():
            raise SRSArtifactError(
                f"SRS digest mismatch: artifact {got}, pinned {expected_digest}")
    if len(raw) < len(MAGIC) + 8 or raw[:len(MAGIC)] != MAGIC:
        raise SRSArtifactError("not an SRS artifact (bad magic)")
    degree = int.from_bytes(raw[16:24], "little")
    need = 24 + (degree + 1) * 96 + 192
    if len(raw) != need:
        raise SRSArtifactError(
            f"truncated SRS artifact: {len(raw)} bytes, expected {need}")
    powers_affine = []
    off = 24
    for _ in range(degree + 1):
        x = _dec_fq(raw[off:off + 48])
        y = _dec_fq(raw[off + 48:off + 96])
        powers_affine.append((x, y))
        off += 96
    tau_h = _dec_g2(raw[off:off + 192])
    if check:
        if powers_affine[0] != (params.G1_GENERATOR_X, params.G1_GENERATOR_Y):
            raise SRSArtifactError("powers[0] is not the G1 generator")
        for i, (x, y) in enumerate(powers_affine):
            if not g1.on_curve((x, y, 1)):
                raise SRSArtifactError(f"power {i} is not on the curve")
        if not _consistency_check(powers_affine, tau_h, device):
            raise SRSArtifactError(
                "pairing consistency check failed: powers do not share one "
                "tau with tau_h")
    return kzg.SRS(
        powers_g1=[g1.from_affine(p) for p in powers_affine],
        h=pairing.G2_GENERATOR,
        tau_h=tau_h,
    )
