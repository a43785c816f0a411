"""Shared pieces of the port's node tests on the CPU (tests/test_torch_*.py):
the golden chain that scripts/make_torch_ledger_fixture.py writes, and the
dev SRS by its known tau.

The dev SRS's tau is known by construction, so a power tau^i G is one
scalar multiplication and a commitment sum_i c_i tau^i G is p(tau) G:
``TauPowers`` stands in for the 4097 to 32,769 host powers (computed on
access), ``tau_commit`` for the device MSM, so that the node's host logic
(Varuna transcripts and checks, the VM, the state tree, the block check)
runs on the CPU without minutes of plain MSMs. The device MSMs themselves
are held to their plain versions in the kernel tests and on the card
(chip_smoke.py)."""

import functools
import json
import os
from collections.abc import Sequence

import torch

from snarkos_tpu_torch.crypto import params
from snarkos_tpu_torch.crypto.ref import g1 as ref_g1, kzg as ref_kzg, ntt, pairing
from snarkos_tpu_torch.ops import g1
from snarkos_tpu_torch.ops.puzzle import DEV_TAU, PuzzleSRS

# the plain versions run many small tensor ops: intra-op threads only add
# contention when test workers share the CPU
torch.set_num_threads(1)

R = params.FR_MODULUS
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "torch_ledger_dev4.json")


@functools.lru_cache(maxsize=1)
def fixture() -> dict:
    with open(FIXTURE) as fh:
        return json.load(fh)


@functools.lru_cache(maxsize=None)
def tau_power(i: int):
    """tau^i G as an affine reference tuple (x, y, 1)."""
    x, y = ref_g1.affine(ref_g1.scalar_mul(pow(DEV_TAU, i, R), ref_g1.GENERATOR))
    return (x, y, 1)


class TauPowers(Sequence):
    """The dev SRS's first n powers, computed on access (prefix slices
    stay lazy)."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(self.n)
            assert start == 0 and step == 1, "only prefixes of the powers"
            return TauPowers(stop)
        i = i + self.n if i < 0 else i
        if not 0 <= i < self.n:
            raise IndexError(i)
        return tau_power(i)


@functools.lru_cache(maxsize=1)
def tau_h():
    return pairing.g2_scalar_mul(DEV_TAU, pairing.G2_GENERATOR)


def tau_srs(degree: int) -> PuzzleSRS:
    """The dev SRS of ``degree``: lazy host powers, the real H and tau H, and
    device points that hold the generator in every lane (a shape for
    slicing only: commitments go through ``tau_commit``)."""
    gen = g1.encode_points([ref_g1.GENERATOR], device="cpu")
    pts = g1.JacobianPoints(*(t.expand(-1, degree + 1) for t in (gen.x, gen.y, gen.z)))
    ref = ref_kzg.SRS(powers_g1=TauPowers(degree + 1), h=pairing.G2_GENERATOR, tau_h=tau_h())
    return PuzzleSRS(degree=degree, points=pts, srs_ref=ref)


def tau_commit(srs):
    """A stand-in for ``ledger.device_commit(srs)``: p(tau) G."""
    def commit(coeffs):
        assert len(coeffs) <= srs.degree + 1
        return ref_g1.scalar_mul(ntt.poly_eval([c % R for c in coeffs], DEV_TAU),
                                 ref_g1.GENERATOR)
    return commit


def affine_ints(p):
    a = ref_g1.affine(p)
    return None if a is None else [str(a[0]), str(a[1])]


def openings_json(openings) -> list:
    """(C, z, y, W) openings in the fixture's form."""
    return [{"C": affine_ints(c), "z": str(z % R), "y": str(y % R), "W": affine_ints(w)}
            for c, z, y, w in openings]


def host_sum_msm(points, scalars):
    """A host stand-in for ``msm.msm`` on CPU tensors: decode, the host
    Pippenger (``crypto/ref/g1.msm``), encode."""
    from snarkos_tpu_torch.ops.fieldspec import FR

    pts = g1.decode_points(points)
    ks = FR.decode_fast(scalars.cpu().numpy())
    return g1.encode_points([ref_g1.msm(ks, pts)], device=points.x.device)



def dev4_env(mp) -> tuple:
    """The fixture's chain for the node's CPU tests, through the monkeypatch
    ``mp``: its genesis in ``ledger._GENESIS_CACHE`` (not proved anew), a
    puzzle on the CPU over the known dev tau at its log degree (the block
    check and the solution checks read its SRS), and the execution SRSs its
    blocks' programs need, the same lazy powers. Returns (fixture, committee,
    the blocks 1-2)."""
    from snarkos_tpu_torch import convert
    from snarkos_tpu_torch.node import ledger
    from snarkos_tpu_torch.ops import puzzle

    doc = fixture()
    comm = convert.committee(bytes.fromhex(doc["committee"]))
    mp.setitem(ledger._GENESIS_CACHE, comm.id, convert.block(bytes.fromhex(doc["genesis"])))
    mp.setattr(puzzle, "_PUZZLE", puzzle.Puzzle(doc["log_degree"], "cpu",
                                                 srs=tau_srs(1 << doc["log_degree"])))
    for need in (16384, 32768):
        mp.setitem(ledger._EXEC_SRS_CACHE, (need, torch.device("cpu")), tau_srs(need))
    return doc, comm, [convert.block(bytes.fromhex(b)) for b in doc["blocks"]]
