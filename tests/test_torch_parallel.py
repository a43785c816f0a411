"""The port's multi-device layer (``snarkos_tpu_torch/parallel/``) on the
CPU: gloo across spawned processes, rendezvous through a file.

Tier 1 spawns once, at world 4, and holds what the ranks return against
the JAX package on the same inputs, made from numpy seeds, all exactly
(field limbs limb for limb, points after affine normalisation):
``ntt_dist`` / ``intt_dist`` at n = 64 (N1 = N2) and n = 512 (N1 != N2)
against the JAX package's host NTT and the port's ``ntt.ntt``; the field
step; the mock-group ``msm_dist`` against the host sum; the collectives
against JAX's tiled ``lax.all_to_all`` / ``all_gather`` on the 4-device
virtual CPU mesh, and ``replicate`` against the JAX package's. Single-process tests: ``_split``, ``_twiddle_matrix``
against host powers and its rank blocks against the whole matrix, and the
tree reduce on real G1 points at widths 1-5.
The slow tier runs ``entry.dryrun_multichip(8, device="cpu")`` and holds the port's
``ntt_dist`` and real-G1 ``msm_dist`` at world 4 against the JAX package's
on its 4-device mesh.

The ranks import this module by name, so it imports nothing of JAX at
its top.
"""

import functools
import random

import numpy as np
import pytest
import torch

from snarkos_tpu_torch import entry
from snarkos_tpu_torch.crypto import params
from snarkos_tpu_torch.ops import g1, msm, ntt
from snarkos_tpu_torch.ops import modarith as fa
from snarkos_tpu_torch.ops.fieldspec import FQ, FR
from snarkos_tpu_torch.parallel import mesh as mesh_mod
from snarkos_tpu_torch.parallel import msm_dist, ntt_dist

# the plain versions run many small tensor ops: intra-op threads only add
# contention when test workers share the CPU
torch.set_num_threads(1)

P = FR.p
WORLD = 4
NTT_SIZES = (64, 512)
MOCK_N = 128
# (split_axis, concat_axis) of the all_to_all checks; ntt_dist uses the
# first two
A2A_AXES = ((2, 1), (1, 2), (0, 2), (2, 0), (1, 1))
A2A_SHAPE = (4, 8, 12)


def _dec(t):
    return FR.decode_fast(t.numpy(), mont=True)


def _inputs():
    rng = np.random.default_rng(10)
    ntt_in = {n: torch.from_numpy(FR.random(n, rng)) for n in NTT_SIZES}
    a, b = (torch.from_numpy(FR.random(64, rng)) for _ in range(2))
    scalars = FR.encode_fast([int(v) for v in rng.integers(0, 1 << 62, MOCK_N)])
    scalars[:, 5] = 0  # a zero scalar on rank 0's shard
    points = rng.integers(0, entry.MOCK_MOD, (1, MOCK_N)).astype(np.int32)
    # rank r's own tensor for the collectives
    a2a = torch.from_numpy(rng.integers(0, 1 << 30, (WORLD,) + A2A_SHAPE).astype(np.int32))
    return {"ntt": ntt_in, "a": a, "b": b, "scalars": torch.from_numpy(scalars),
            "points": torch.from_numpy(points), "a2a": a2a}


def _world_rank(mesh, inp):
    """One rank of the tier-1 run: every path on this rank's shard; the
    local outputs come back to the test."""
    out = {}
    for n, x in inp["ntt"].items():
        xl = mesh_mod.shard_last(mesh, x)
        ev = ntt_dist.ntt_dist(xl, mesh)
        out[f"ntt{n}"] = ev
        out[f"intt{n}"] = ntt_dist.intt_dist(xl, mesh)
        out[f"back{n}"] = ntt_dist.intt_dist(ev, mesh)
        out[f"gathered{n}"] = mesh_mod.all_gather_last(mesh, ev)
    a, b = (mesh_mod.shard_last(mesh, inp[k]) for k in "ab")
    out["field"] = fa.add(FR, fa.mont_mul(FR, a, b), a)
    out["mock"] = msm_dist.msm_dist((mesh_mod.shard_last(mesh, inp["points"]),),
                                    mesh_mod.shard_last(mesh, inp["scalars"]), mesh, c=4,
                                    group=entry.mock_group("cpu"))[0]
    mine = inp["a2a"][mesh.rank]
    for s, c in A2A_AXES:
        out[f"a2a{s}{c}"] = mesh_mod.all_to_all(mesh, mine, s, c)
    out["gather"] = mesh_mod.all_gather_last(mesh, mine)
    out["replicate"] = mesh_mod.replicate(mesh, mine)
    return out


@pytest.fixture(scope="module")
def world():
    inp = _inputs()
    return inp, mesh_mod.spawn(_world_rank, WORLD, "gloo", "cpu", inp)


@pytest.mark.parametrize("n", NTT_SIZES)
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_dist_world4_matches_host(world, n, inverse):
    """Rank r holds block r of the natural-order output: the blocks in rank
    order equal the JAX package's host NTT and the port's ``ntt.ntt``."""
    from snarkos_tpu.crypto.ref import ntt as jref

    inp, outs = world
    x = inp["ntt"][n]
    got = torch.cat([o[f"{'intt' if inverse else 'ntt'}{n}"] for o in outs], dim=-1)
    assert _dec(got) == jref.ntt(_dec(x), inverse)
    assert torch.equal(got, ntt.ntt(x, inverse))


@pytest.mark.parametrize("n", NTT_SIZES)
def test_ntt_dist_world4_round_trip_and_gather(world, n):
    inp, outs = world
    x = inp["ntt"][n]
    assert torch.equal(torch.cat([o[f"back{n}"] for o in outs], dim=-1), x)
    whole = torch.cat([o[f"ntt{n}"] for o in outs], dim=-1)
    for o in outs:
        assert torch.equal(o[f"gathered{n}"], whole)


def test_field_step_world4(world):
    inp, outs = world
    got = _dec(torch.cat([o["field"] for o in outs], dim=-1))
    assert got == [(x * y + x) % P for x, y in zip(_dec(inp["a"]), _dec(inp["b"]))]


def test_mock_msm_dist_world4(world):
    """Every rank returns the host sum of k_i x_i mod MOCK_MOD."""
    inp, outs = world
    ks = FR.decode_fast(inp["scalars"].numpy())
    want = sum(k * int(x) for k, x in zip(ks, inp["points"][0])) % entry.MOCK_MOD
    assert [int(o["mock"][0, 0]) for o in outs] == [want] * WORLD
    assert all(o["mock"].shape == (1, 1) for o in outs)


@pytest.mark.parametrize("split_axis,concat_axis", A2A_AXES)
def test_all_to_all_matches_jax(world, split_axis, concat_axis):
    """``mesh.all_to_all`` against JAX's tiled ``lax.all_to_all`` on the
    4-device virtual CPU mesh, each rank with its own input."""
    import jax
    from jax.sharding import PartitionSpec as P_
    from snarkos_tpu.parallel.mesh import make_mesh

    inp, outs = world
    jmesh = make_mesh(WORLD, backend="cpu")

    @functools.partial(jax.shard_map, mesh=jmesh, in_specs=P_("x"), out_specs=P_("x"),
                       check_vma=False)
    def body(t):
        return jax.lax.all_to_all(t[0], "x", split_axis, concat_axis, tiled=True)[None]

    want = np.asarray(jax.jit(body)(inp["a2a"].numpy()))
    for r, o in enumerate(outs):
        assert np.array_equal(o[f"a2a{split_axis}{concat_axis}"].numpy(), want[r])


def test_all_gather_last_matches_jax(world):
    import jax
    from jax.sharding import PartitionSpec as P_
    from snarkos_tpu.parallel.mesh import make_mesh

    inp, outs = world
    jmesh = make_mesh(WORLD, backend="cpu")

    @functools.partial(jax.shard_map, mesh=jmesh, in_specs=P_("x"), out_specs=P_("x"),
                       check_vma=False)
    def body(t):
        return jax.lax.all_gather(t[0], "x", axis=-1, tiled=True)[None]

    want = np.asarray(jax.jit(body)(inp["a2a"].numpy()))
    for r, o in enumerate(outs):
        assert np.array_equal(o["gather"].numpy(), want[r])


def test_replicate_matches_jax(world):
    """replicate: every rank ends with rank 0's tensor, as the JAX package's
    replicate puts the array whole on each device of its mesh."""
    from snarkos_tpu.parallel.mesh import make_mesh, replicate

    inp, outs = world
    placed = replicate(make_mesh(WORLD, backend="cpu"), inp["a2a"][0].numpy())
    shards = [np.asarray(s.data) for s in placed.addressable_shards]
    assert len(shards) == WORLD
    for o, shard in zip(outs, shards):
        assert np.array_equal(o["replicate"].numpy(), shard)


def test_split_matches_jax():
    from snarkos_tpu.parallel import ntt_dist as jdist

    for log_n in range(25):
        assert ntt_dist._split(1 << log_n) == jdist._split(1 << log_n)


@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("invert", [False, True])
def test_twiddle_matrix_host_powers(n, invert):
    """T[k1, j2] = omega^(k1 j2), omega of order n or its inverse."""
    from snarkos_tpu.crypto.ref import ntt as jref

    n1, n2 = ntt_dist._split(n)
    omega = jref.root_of_unity(n)
    if invert:
        omega = pow(omega, -1, P)
    t = ntt_dist._twiddle_matrix(n, invert, torch.device("cpu"))
    assert t.shape == (FR.nlimbs, n1, n2) and t.is_contiguous()
    got = _dec(t.reshape(FR.nlimbs, -1))
    assert got == [pow(omega, k1 * j2, P) for k1 in range(n1) for j2 in range(n2)]


@pytest.mark.parametrize("n,world", [(64, 4), (512, 4), (128, 2)])
def test_twiddle_matrix_rank_block(n, world):
    """Rank r's block is columns [r N2/D, (r + 1) N2/D) of the whole matrix,
    contiguous; the blocks in rank order are the whole matrix."""
    n1, n2 = ntt_dist._split(n)
    cpu = torch.device("cpu")
    whole = ntt_dist._twiddle_matrix(n, False, cpu)
    blocks = [ntt_dist._twiddle_matrix(n, False, cpu, r, world) for r in range(world)]
    for b in blocks:
        assert b.shape == (FR.nlimbs, n1, n2 // world) and b.is_contiguous()
    assert torch.equal(torch.cat(blocks, dim=-1), whole)


@pytest.mark.parametrize("width", [1, 2, 3, 4, 5])
def test_tree_reduce_g1(width):
    """The tree reduce over real G1 points, odd leftovers included, against
    the JAX package's host G1 sum; an identity among the inputs."""
    from snarkos_tpu.crypto.ref import g1 as jg1

    prng = random.Random(width)
    pts = [jg1.scalar_mul(prng.randrange(1, params.FR_MODULUS), jg1.GENERATOR)
           for _ in range(width)]
    if width > 2:
        pts[1] = jg1.INFINITY
    enc = g1.encode_points(pts)
    out = msm_dist.tree_reduce(msm.g1_group(torch.device("cpu")), (enc.x, enc.y, enc.z))
    assert out[0].shape == (FQ.nlimbs, 1)
    got = g1.decode_points(g1.JacobianPoints(*out))[0]
    assert jg1.affine(got) == jg1.affine(functools.reduce(jg1.add, pts))


def test_make_mesh_checks_the_group(tmp_path):
    """Inside an initialised group: the world size and the backend asked
    for are checked, the device is the one given."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", world_size=1,
                            rank=0)
    try:
        m = mesh_mod.make_mesh(1, device="cpu")
        assert (m.rank, m.world, m.device) == (0, 1, torch.device("cpu"))
        with pytest.raises(ValueError, match="requested 2"):
            mesh_mod.make_mesh(2, device="cpu")
        with pytest.raises(ValueError, match="not nccl"):
            mesh_mod.make_mesh(1, backend="nccl", device="cpu")
        x = torch.arange(16, dtype=torch.int32).reshape(2, 8)
        assert torch.equal(mesh_mod.all_gather_last(m, mesh_mod.shard_last(m, x)), x)
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# slow tier
# --------------------------------------------------------------------------


@pytest.mark.slow
def test_dryrun_multichip_8():
    entry.dryrun_multichip(8, device="cpu")


def _jax_rank(mesh, x, points, scalars):
    xl = mesh_mod.shard_last(mesh, x)
    pts = g1.JacobianPoints(*(mesh_mod.shard_last(mesh, t) for t in points))
    out = msm_dist.msm_dist(pts, mesh_mod.shard_last(mesh, scalars), mesh, c=4)
    return {"ntt": ntt_dist.ntt_dist(xl, mesh), "intt": ntt_dist.intt_dist(xl, mesh),
            "msm": (out.x, out.y, out.z)}


@pytest.mark.slow
def test_dist_world4_matches_jax_mesh():
    """The port at world 4 against the JAX package's ``ntt_dist`` /
    ``intt_dist`` (n = 512) and ``msm_dist`` (8 real G1 points, a zero
    scalar, c = 4) on its 4-device virtual CPU mesh, the same inputs."""
    import jax.numpy as jnp
    from snarkos_tpu.crypto.ref import g1 as jg1
    from snarkos_tpu.ops import g1 as jg1ops
    from snarkos_tpu.parallel import msm_dist as jmsm_dist, ntt_dist as jntt_dist
    from snarkos_tpu.parallel.mesh import make_mesh, shard_last

    rng = np.random.default_rng(77)
    prng = random.Random(77)
    x = FR.random(512, rng)
    scalars = [prng.randrange(P) for _ in range(8)]
    scalars[3] = 0
    pts = [jg1.scalar_mul(prng.randrange(1, 1 << 48), jg1.GENERATOR) for _ in range(8)]
    limbs = FR.encode(scalars, mont=False)

    enc = g1.encode_points(pts)
    outs = mesh_mod.spawn(_jax_rank, WORLD, "gloo", "cpu", torch.from_numpy(x),
                          (enc.x, enc.y, enc.z), torch.from_numpy(limbs))

    jmesh = make_mesh(WORLD, backend="cpu")
    xs = shard_last(jmesh, jnp.array(x))
    for key, fn in (("ntt", jntt_dist.ntt_dist), ("intt", jntt_dist.intt_dist)):
        want = np.asarray(fn(xs, jmesh))
        assert np.array_equal(torch.cat([o[key] for o in outs], dim=-1).numpy(), want)
    jout = jmsm_dist.msm_dist(jg1ops.encode_points(pts), jnp.array(limbs), jmesh, c=4,
                              use_pallas=False)
    want = jg1.affine(jg1ops.decode_points(jg1ops.JacobianPoints(
        jout.x[..., :1], jout.y[..., :1], jout.z[..., :1]))[0])
    assert want == jg1.affine(jg1.msm(scalars, pts))
    got = [jg1.affine(g1.decode_points(g1.JacobianPoints(*o["msm"]))[0]) for o in outs]
    assert got == [want] * WORLD
