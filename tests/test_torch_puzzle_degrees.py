"""The port's puzzle at the log degrees the node accepts beyond 4-15, on the
CPU, against the JAX package's host reference (``tests/fixtures/
torch_puzzle_k{LOG}_b{N}.json``, built by
``scripts/make_torch_puzzle_fixture.py --log-degree LOG --nonces N``): the
coefficients at log degree 0-3, the multi-MSM's layout at small widths,
and, in the slow tier, prove_batch byte for byte and verify_batch. Also the
last two public functions of the JAX package's device layer that the port
had not carried over: ``poseidon.hash_batch`` and ``mesh.replicate``.

The ranks of ``mesh.spawn`` import this module by name, so it imports
nothing of JAX at its top.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from snarkos_tpu_torch.crypto import params
from snarkos_tpu_torch.crypto.ref import poseidon as ref_poseidon
from snarkos_tpu_torch.ops import msm, msm_kernels, poseidon, puzzle
from snarkos_tpu_torch.ops.fieldspec import FR
from snarkos_tpu_torch.parallel import mesh as mesh_mod

# the plain versions run many small tensor ops: intra-op threads only add
# contention when test workers share the CPU
torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
# (log degree, nonces) of the committed fixtures beyond the 2^12 one
DEGREES = ((0, 8), (1, 8), (2, 8), (3, 8), (16, 8), (20, 2))


def _fixture(ld, nb):
    with open(os.path.join(FIXTURES, f"torch_puzzle_k{ld}_b{nb}.json")) as fh:
        return json.load(fh)


def _no_srs(ld):
    """A Puzzle on the CPU without an SRS (the coefficients need none; the
    dev SRS's host copy costs a G2 scalar multiplication)."""
    srs = puzzle.PuzzleSRS(degree=1 << ld, points=None, srs_ref=None)
    return puzzle.Puzzle(log_degree=ld, device="cpu", srs=srs)


@pytest.mark.parametrize("ld, nb", DEGREES)
def test_fixture_shapes(ld, nb):
    """Each fixture holds nonces 0 .. N - 1 of the epoch and address of the
    2^12 one; at log degree 0 the quotient is 0, so every witness is the
    identity's encoding."""
    doc, base = _fixture(ld, nb), _fixture(12, 8)
    assert doc["log_degree"] == ld
    assert (doc["epoch_hash"], doc["address"]) == (base["epoch_hash"], base["address"])
    assert [row["nonce"] for row in doc["solutions"]] == list(range(nb))
    for row in doc["solutions"]:
        assert len(bytes.fromhex(row["commitment"])) == len(bytes.fromhex(row["witness"])) == 97
        assert (row["witness"] == "00" * 96 + "01") == (ld == 0)


@pytest.mark.parametrize("ld", [0, 1, 2, 3])
def test_coefficients_match_host_reference(ld):
    """The port's coefficients on the CPU (the plain sponge and the plain
    epoch program) equal the JAX package's host reference, host Poseidon
    leaves through ``EpochProgram.apply_host``, at K = 1, 2, 4, 8 for 8
    nonces."""
    from snarkos_tpu.crypto.ref import poseidon as jref
    from snarkos_tpu.ops import puzzle as jpuzzle

    doc = _fixture(ld, 8)
    epoch, address = bytes.fromhex(doc["epoch_hash"]), doc["address"]
    pz = _no_srs(ld)
    got = pz.coefficients(epoch, address, range(8)).numpy()
    jprog = jpuzzle.EpochProgram(epoch, 1 << ld)
    for n in range(8):
        seed = pz._seed_field(epoch, address, n)
        leaves = [jref.hash_many([seed, i], rate=2, domain=jpuzzle.COEFF_DOMAIN)[0]
                  for i in range(1 << ld)]
        assert FR.decode_fast(got[:, n], mont=True) == jprog.apply_host(leaves)


@pytest.mark.parametrize("nb, npts, width, lanes, serial", [
    (8, 1, 8, 8, True), (8, 2, 16, 16, True), (8, 8, 64, 64, True), (3, 2, 6, 6, True),
    (8, 4096, 32768, 256, True), (8, 8192, 65536, 256, False)])
def test_multi_msm_layout(nb, npts, width, lanes, serial, monkeypatch):
    """The multi-MSM's layout: on serial chains (B N <= SERIAL_MAX_N) K = min(
    _default_lanes, B N) chains and nothing padded, so that prove_batch at
    log degree 0-3 scans 8-64 points and not 8 x 1024; at 8 x 2^12 (the
    fixture's prover) and on wide chains the layout is the one before."""
    calls = []

    def body(x, ycat, packed, c, lanes_, chunk, serial=True, nbatch=1):
        calls.append((x.shape[-1], lanes_, serial, nbatch, packed.shape[-1]))
        return tuple(torch.zeros((24, nbatch), dtype=torch.int32) for _ in range(3))

    monkeypatch.setattr(msm, "_fused_msm_body", body)
    zeros = torch.zeros((24, npts), dtype=torch.int32)
    msm.msm_affine_multi(zeros, zeros, torch.zeros((16, nb, npts), dtype=torch.int32))
    assert calls == [(width, lanes, serial, nb, width)]
    assert serial == (nb * npts <= msm_kernels.SERIAL_MAX_N)


def _check_solutions(sols, doc):
    want = [(r["commitment"], r["eval_y"], r["witness"], r["solution_id"])
            for r in doc["solutions"]]
    got = [(s.commitment.hex(), str(s.eval_y), s.witness.hex(), str(s.solution_id))
           for s in sols]
    assert got == want


@pytest.mark.slow
@pytest.mark.parametrize("ld", [0, 1, 2, 3])
def test_prove_batch_small_degrees_match_fixtures(ld):
    """Puzzle(log_degree=ld, device="cpu").prove_batch over nonces 0-7 equals
    the JAX-built fixture byte for byte (about a minute each on one CPU
    core: 64 windows of c = 4 for each of the two multi-MSMs)."""
    doc = _fixture(ld, 8)
    pz = puzzle.Puzzle(log_degree=ld, device="cpu")
    sols = pz.prove_batch(bytes.fromhex(doc["epoch_hash"]), doc["address"], range(8))
    _check_solutions(sols, doc)


@pytest.mark.slow
@pytest.mark.parametrize("ld", [0, 1])
def test_verify_batch_small_degrees(ld):
    """The fixture's solutions at log degree 0 (identity witnesses: the
    generic engine in batch_verify) and 1 pass verify_batch on the CPU and
    fail it with one eval_y + 1; verify accepts the first."""
    doc = _fixture(ld, 8)
    epoch, address = bytes.fromhex(doc["epoch_hash"]), doc["address"]
    pz = puzzle.Puzzle(log_degree=ld, device="cpu")
    items = [(epoch, address, r["nonce"], bytes.fromhex(r["commitment"]), int(r["eval_y"]),
              bytes.fromhex(r["witness"]), 1) for r in doc["solutions"][:4]]
    assert pz.verify_batch(items)
    bad = list(items)
    bad[2] = bad[2][:4] + ((bad[2][4] + 1) % params.FR_MODULUS,) + bad[2][5:]
    assert not pz.verify_batch(bad)
    assert pz.verify(*items[0])


# -- the last two public functions --------------------------------------------------


def _montgomery_rows(rows):
    """rows: per lane a list of field elements -> (n, L, B) Montgomery limbs."""
    return np.stack([FR.encode_fast([r[k] for r in rows], mont=True)
                     for k in range(len(rows[0]))])


@pytest.mark.parametrize("rate", [1, 2])
def test_hash_batch_matches_host(rate):
    """hash_batch takes a numpy array (sent to the device asked for) or a
    tensor (hashed where it lies), and gives hash_fixed(...)[0]: the JAX
    package's host sponge's first output, lane by lane."""
    from snarkos_tpu.crypto.ref import poseidon as jref

    rng = random.Random(160 + rate)
    rows = [[rng.randrange(params.FR_MODULUS) for _ in range(2)] for _ in range(4)]
    values = _montgomery_rows(rows)
    if rate == 1:
        got = poseidon.hash_batch(values, rate, "d", device="cpu")
    else:
        got = poseidon.hash_batch(torch.from_numpy(values), rate, "d")
    assert tuple(got.shape) == (FR.nlimbs, 4) and got.device.type == "cpu"
    want = [jref.hash_many(r, rate=rate, domain="d")[0] for r in rows]
    assert FR.decode_fast(got.numpy(), mont=True) == want
    assert want == [ref_poseidon.hash_many(r, rate=rate, domain="d")[0] for r in rows]


@pytest.mark.slow
def test_hash_batch_limb_exact_against_jax():
    """hash_batch against the JAX package's own hash_batch (jnp), limb for
    limb (its XLA:CPU compile takes seconds)."""
    from snarkos_tpu.ops import poseidon as jpos

    rng = random.Random(167)
    rows = [[rng.randrange(params.FR_MODULUS) for _ in range(2)] for _ in range(8)]
    values = _montgomery_rows(rows)
    want = np.asarray(jpos.hash_batch(values, rate=2, domain="d"))
    np.testing.assert_array_equal(poseidon.hash_batch(values, 2, "d", device="cpu").numpy(), want)


def _replicate_rank(mesh, tensors):
    """Rank r offers tensors[r]; returns what replicate gives it."""
    return mesh_mod.replicate(mesh, tensors[mesh.rank])


@pytest.mark.slow
def test_replicate_world2_matches_jax():
    """replicate at world 2 (gloo, two spawned CPU ranks): both ranks end
    with rank 0's tensor, as jax.device_put(arr, NamedSharding(mesh, P()))
    puts the array whole on each device of the JAX package's 2-device CPU
    mesh (a spawn takes a few seconds)."""
    from snarkos_tpu.parallel import mesh as jmesh_mod

    rng = np.random.default_rng(16)
    tensors = [torch.from_numpy(rng.integers(0, 1 << 30, (16, 5)).astype(np.int32))
               for _ in range(2)]
    outs = mesh_mod.spawn(_replicate_rank, 2, "gloo", "cpu", tensors)
    jmesh = jmesh_mod.make_mesh(2, backend="cpu")
    placed = jmesh_mod.replicate(jmesh, tensors[0].numpy())
    shards = [np.asarray(s.data) for s in placed.addressable_shards]
    assert len(shards) == 2
    for out, shard in zip(outs, shards):
        assert np.array_equal(out.numpy(), shard)
        assert torch.equal(out, tensors[0])
