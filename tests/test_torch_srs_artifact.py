"""The port's SRS artifacts (crypto/srs_artifact.py) on the CPU: it reads
what the JAX package's save_srs writes and writes the same bytes, pins the
digest, and rejects bad magic, a truncated file, a wrong first power, a
point off the curve and, through the pairing consistency check, a tampered
power. The check's device MSMs take tens of seconds in plain PyTorch on a
CPU: tier 1 replaces them by a host sum, the slow tier runs them, and
PuzzleSRS.from_artifact."""

import dataclasses

import pytest
import torch

from snarkos_tpu.crypto import srs_artifact as jsrs_artifact
from snarkos_tpu.crypto.ref import g1 as jref_g1, kzg as jref_kzg
from snarkos_tpu_torch.crypto import params, srs_artifact
from snarkos_tpu_torch.crypto.ref import g1 as ref_g1, kzg as ref_kzg
from snarkos_tpu_torch.ops import g1
from snarkos_tpu_torch.ops.fieldspec import FR
from snarkos_tpu_torch.ops.puzzle import PuzzleSRS

torch.set_num_threads(1)

R = params.FR_MODULUS
TAU = pow(params.FR_GENERATOR, 987654321, R)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A degree-4 "ceremony" SRS written by the JAX package's save_srs."""
    srs = jref_kzg.SRS.setup(4, tau=TAU)
    path = str(tmp_path_factory.mktemp("srs") / "ceremony.srs")
    return path, jsrs_artifact.save_srs(path, srs), srs


def _host_msm(points, scalar_limbs):
    """A host stand-in for msm.msm: sum k_i P_i over the decoded bases."""
    ks = FR.decode_fast(scalar_limbs.cpu().numpy())
    acc = ref_g1.INFINITY
    for k, p in zip(ks, g1.decode_points(points)):
        acc = ref_g1.add(acc, ref_g1.scalar_mul(k, p))
    return g1.encode_points([acc])


def _write(tmp_path, name, srs):
    path = str(tmp_path / name)
    srs_artifact.save_srs(path, srs)
    return path


def test_reads_and_writes_the_jax_format(artifact, tmp_path):
    path, digest, srs = artifact
    got = srs_artifact.load_srs(path, digest, check=False, device="cpu")
    assert [ref_g1.affine(p) for p in got.powers_g1] == [jref_g1.affine(p) for p in srs.powers_g1]
    assert got.h == srs.h and got.tau_h == srs.tau_h
    port_srs = ref_kzg.SRS.setup(4, tau=TAU)
    assert port_srs.tau_h == srs.tau_h
    assert srs_artifact.save_srs(str(tmp_path / "port.srs"), port_srs) == digest


def test_rejects_before_the_pairing_check(artifact, tmp_path):
    """Digest, magic, length, first power and on-curve checks."""
    path, _, srs = artifact
    with pytest.raises(srs_artifact.SRSArtifactError, match="digest"):
        srs_artifact.load_srs(path, "00" * 32, device="cpu")
    junk = tmp_path / "junk.srs"
    junk.write_bytes(b"NOT_AN_SRS_FILE!" + b"\x00" * 64)
    with pytest.raises(srs_artifact.SRSArtifactError, match="magic"):
        srs_artifact.load_srs(str(junk), device="cpu")
    with open(path, "rb") as fh:
        raw = fh.read()
    short = tmp_path / "short.srs"
    short.write_bytes(raw[:-1])
    with pytest.raises(srs_artifact.SRSArtifactError, match="truncated"):
        srs_artifact.load_srs(str(short), device="cpu")
    swapped = dataclasses.replace(srs, powers_g1=srs.powers_g1[1:2] + srs.powers_g1[1:])
    with pytest.raises(srs_artifact.SRSArtifactError, match="generator"):
        srs_artifact.load_srs(_write(tmp_path, "first.srs", swapped), device="cpu")
    x, y = ref_g1.affine(srs.powers_g1[2])
    bad = dataclasses.replace(srs, powers_g1=list(srs.powers_g1))
    bad.powers_g1[2] = (x, (y + 1) % params.FQ_MODULUS, 1)
    with pytest.raises(srs_artifact.SRSArtifactError, match="curve"):
        srs_artifact.load_srs(_write(tmp_path, "off.srs", bad), device="cpu")


def test_consistency_check_with_host_sums(artifact, tmp_path, monkeypatch):
    """The RLC pairing check, its MSMs replaced by host sums: the JAX
    package's artifact passes, one with power 3 replaced by another curve
    point fails."""
    path, digest, srs = artifact
    monkeypatch.setattr(srs_artifact.msm, "msm", _host_msm)
    got = srs_artifact.load_srs(path, digest, device="cpu")
    assert got.tau_h == srs.tau_h
    evil = dataclasses.replace(srs, powers_g1=list(srs.powers_g1))
    evil.powers_g1[3] = ref_g1.scalar_mul(12345, ref_g1.GENERATOR)
    with pytest.raises(srs_artifact.SRSArtifactError, match="consistency"):
        srs_artifact.load_srs(_write(tmp_path, "evil.srs", evil), device="cpu")


@pytest.mark.slow
def test_from_artifact_on_the_device_msms(artifact, tmp_path):
    """PuzzleSRS.from_artifact with the real MSMs (plain versions): the
    device points are the artifact's first 2^2 + 1 powers, is_dev is False;
    a tampered power raises, an artifact too small for the degree raises."""
    path, digest, srs = artifact
    pz = PuzzleSRS.from_artifact(path, digest, log_degree=2, device="cpu")
    assert not pz.is_dev and pz.degree == 4 and pz.srs_ref.tau_h == srs.tau_h
    want = g1.encode_points([jref_g1.from_affine(jref_g1.affine(p)) for p in srs.powers_g1])
    for a, b in zip((pz.points.x, pz.points.y, pz.points.z), (want.x, want.y, want.z)):
        assert torch.equal(a, b)
    evil = dataclasses.replace(srs, powers_g1=list(srs.powers_g1))
    evil.powers_g1[1] = ref_g1.scalar_mul(777, ref_g1.GENERATOR)
    with pytest.raises(srs_artifact.SRSArtifactError, match="consistency"):
        PuzzleSRS.from_artifact(_write(tmp_path, "evil.srs", evil), log_degree=2, device="cpu")
    with pytest.raises(srs_artifact.SRSArtifactError, match="needs"):
        PuzzleSRS.from_artifact(path, log_degree=3, device="cpu")
