"""The PyTorch port stands alone: no module of snarkos_tpu_torch, nor
chip_smoke.py, imports JAX, the JAX package or its native engines
(``native/``, loaded through ``snarkos_tpu.utils.native``); no kernel wrapper catches an
exception around a launch (a CUDA tensor launches its kernel or raises); the
entry points default to the card and refuse to run without one."""

import ast
import os

import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _port_files():
    # chip_smoke.py imports the in-process network of the port's validators
    # and the block sync's client and server halves
    out = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "tests", "torch_bft_support.py"),
           os.path.join(ROOT, "tests", "torch_net_support.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "snarkos_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "snarkos_tpu", "native")


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    bad = [m for m in _imported(tree) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def _calls_kernel(node) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            f = sub.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
            if name == "launch" or name.endswith("_kernel"):
                return True
    return False


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_fallback_around_kernel_launch(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Try) and node.handlers:
            assert not any(_calls_kernel(stmt) for stmt in node.body), (
                f"{path}:{node.lineno} catches an exception around a kernel launch")


def test_entry_points_refuse_without_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from snarkos_tpu_torch import convert
    from snarkos_tpu_torch.ops import _build
    from snarkos_tpu_torch.ops.puzzle import Puzzle, PuzzleSRS

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Puzzle(log_degree=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PuzzleSRS.dev(log_degree=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.points(*[torch.zeros((24, 1), dtype=torch.int32).numpy()] * 3)
    # the verifier half: the device is resolved before any file is read or
    # any point is decoded
    from snarkos_tpu_torch.crypto import srs_artifact
    from snarkos_tpu_torch.crypto.ref import g1 as ref_g1, kzg as ref_kzg
    from snarkos_tpu_torch.ops import kzg

    with pytest.raises(RuntimeError, match="no CUDA device"):
        PuzzleSRS.from_artifact("no-such-artifact.srs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        srs_artifact.load_srs("no-such-artifact.srs")
    srs = ref_kzg.SRS(powers_g1=[ref_g1.GENERATOR], h=None, tau_h=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kzg.batch_verify(srs, [(ref_g1.GENERATOR, 1, 1, ref_g1.INFINITY)])
    # the pipeline step builds its inputs on the card by default
    from snarkos_tpu_torch import entry

    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
    # the mesh of the multi-device layer is this rank's card unless told
    # otherwise; the device is resolved before any process group is joined
    from snarkos_tpu_torch.parallel import mesh

    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh(1, backend="gloo", device="cuda:0")
    # the dry run's ranks are on the card unless told otherwise; nothing is
    # spawned without one
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(2)
    # the node's roles resolve the card before they build a ledger or bind
    # a socket, and so does the CLI's start
    import socket

    from snarkos_tpu_torch.node import cli, roles, types

    comm = types.Committee.new(1, {"aleo1" + "11" * 32: 100})
    acct = cli.AccountView(cli.dev_account(0))
    binds = []
    real_bind = socket.socket.bind

    def bind(self, *args):
        binds.append(args)
        return real_bind(self, *args)

    socket.socket.bind = bind
    try:
        for make in (lambda: roles.Validator(acct, comm), lambda: roles.Client(acct, comm),
                     lambda: roles.Prover(acct, b"\x00" * 32)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["start", "--dev", "0", "--norest"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["start", "--prover", "--dev", "4"])
    finally:
        socket.socket.bind = real_bind
    assert binds == []
    assert _build.resolve_device("cpu").type == "cpu"


def test_global_puzzle_keys_the_device(monkeypatch):
    """The cached puzzle is handed out only for its own log degree and
    device: a CPU instance never answers a call for the card."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    import types

    from snarkos_tpu_torch.ops import puzzle

    stub = types.SimpleNamespace(log_degree=3, device=torch.device("cpu"))
    monkeypatch.setattr(puzzle, "_PUZZLE", stub)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        puzzle.global_puzzle(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        puzzle.global_puzzle()
    assert puzzle.global_puzzle(3, "cpu") is stub
    assert puzzle.global_puzzle(device="cpu") is stub


def test_kernel_wrappers_reject_cpu_tensors():
    """The launchers take only what their kernels take; they never run the
    plain version."""
    from snarkos_tpu_torch.ops import g1, g1_kernels, msm_kernels, ntt, poseidon, puzzle
    from snarkos_tpu_torch.ops import modarith as fa
    from snarkos_tpu_torch.ops.fieldspec import FQ, FR

    a = torch.zeros((16, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fa.mont_mul_kernel(FR, a, a)
    with pytest.raises(ValueError, match="expected"):
        fa.mont_mul_kernel(FQ, a, a)
    state = torch.zeros((3, 16, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        poseidon.permute_kernel(state, 2)
    with pytest.raises(ValueError, match="expected"):
        poseidon.permute_kernel(state, 4)
    with pytest.raises(ValueError, match="CUDA"):
        poseidon.sponge_kernel(2, inputs=state[:2], num_outputs=1)
    v = torch.zeros((16, 2, 4), dtype=torch.int32)
    perm = torch.arange(4, dtype=torch.int32)
    prog = puzzle.EpochProgram.from_tensors(b"", perm.reshape(1, 4), perm.reshape(1, 1, 4),
                                            a.reshape(1, 16, 4))
    with pytest.raises(ValueError, match="CUDA"):
        puzzle.program_kernel(v, prog)
    with pytest.raises(ValueError, match="CUDA"):
        puzzle.program_kernel_global(v, perm.reshape(1, 4), a.reshape(1, 4, 16)[..., :8])
    p = g1.infinity((4,))
    with pytest.raises(ValueError, match="CUDA"):
        g1_kernels.add_kernel(p, p)
    stack = tuple(t.unsqueeze(0) for t in (p.x, p.y, p.z))
    with pytest.raises(ValueError, match="CUDA"):
        g1_kernels.horner_chain_kernel(stack, 3)
    keys = torch.zeros(4, dtype=torch.int64)
    heads = torch.ones((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        g1_kernels.bucket_fixup_kernel((p.x, p.y, p.z), keys, heads, (p.x, p.y, p.z), 2, 2, 1, 3)
    with pytest.raises(ValueError, match="multiple"):
        g1_kernels.bucket_fixup_kernel((p.x, p.y, p.z), keys, heads, (p.x, p.y, p.z), 3, 1, 1, 3)
    flag = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        g1_kernels.seg_prefix_kernel(flag, p.x, p.y, p.z)
    xs = torch.zeros((24, 2, 4), dtype=torch.int32)
    fl = torch.zeros((1, 2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        msm_kernels.bucket_scan_serial_kernel(xs, xs, fl)
    with pytest.raises(ValueError, match="CUDA"):
        msm_kernels.bucket_scan_kernel(xs, xs, fl, 2)
    with pytest.raises(ValueError, match="CUDA"):
        msm_kernels.bucket_scan_fast_kernel(xs, xs, fl, fl, 2)
    with pytest.raises(ValueError, match="CUDA"):
        msm_kernels.bucket_total_kernel(p.x, p.y, p.z)
    with pytest.raises(ValueError, match="CUDA"):
        ntt.pass_kernel(v, torch.empty_like(v), a[:, :3], 0, 2)
    with pytest.raises(ValueError, match="CUDA"):
        ntt.pass_kernel(v, v, a[:, :3], 1, 1)
    assert fa.mont_mul_kernel.launches == 0
    assert ntt.pass_kernel.launches == 0
    assert poseidon.sponge_kernel.launches == puzzle.program_kernel_cluster.launches == 0
    assert puzzle.program_kernel_global.launches == 0
    assert g1_kernels.seg_prefix_kernel.launches == 0
    assert g1_kernels.horner_chain_kernel.launches == g1_kernels.bucket_fixup_kernel.launches == 0
    assert msm_kernels.bucket_scan_fast_kernel.launches == 0
    assert msm_kernels.bucket_total_kernel.launches == 0


def test_lane_scan_wrappers_reject_cpu_tensors():
    """The generic engine's window launchers (``g1_lane_buckets``,
    ``g1_lane_bucket_carry``) take only what their kernels take: CUDA
    tensors, K lanes that divide the positions, a plan of M members a lane
    (a power of two) and a block of a multiple of M members, at most 256;
    they never run the plain version."""
    from snarkos_tpu_torch.ops import g1, g1_kernels

    p = g1.infinity((8,))
    keys = torch.zeros(8, dtype=torch.int64)
    ck = torch.zeros(4, dtype=torch.int32)
    agg = g1.infinity((4,))
    with pytest.raises(ValueError, match="CUDA"):
        g1_kernels.lane_buckets_kernel(keys, p.x, p.y, p.z, 4, 16, (1, 32))
    with pytest.raises(ValueError, match="multiple"):
        g1_kernels.lane_buckets_kernel(keys, p.x, p.y, p.z, 3, 16, (1, 32))
    for plan in ((3, 33), (0, 32), (2, 3), (32, 512)):
        with pytest.raises(ValueError, match="plan"):
            g1_kernels.lane_buckets_kernel(keys, p.x, p.y, p.z, 4, 16, plan)
    with pytest.raises(ValueError, match="CUDA"):
        g1_kernels.lane_bucket_carry_kernel(p.x, p.y, p.z, agg.x, agg.y, agg.z, ck)
    assert g1_kernels.lane_buckets_kernel.launches == 0
    assert g1_kernels.lane_bucket_carry_kernel.launches == 0

def test_scan_covers_the_node_and_the_vm():
    """The import scan above reaches the node's modules (the consensus core,
    the network planes, the roles and the CLI among them), the VM and the in-process network
    and the block sync's halves of the tests and the chip check."""
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    for name in ("node/ledger.py", "node/types.py", "node/state_tree.py", "node/codec.py",
                 "node/messages.py", "vm/circuit.py", "vm/interpreter.py", "vm/program.py",
                 "vm/values.py", "crypto/ref/varuna.py", "crypto/ref/edwards.py",
                 "node/events.py", "node/metrics.py", "node/proposal_cache.py",
                 "node/consensus.py", "node/bft/__init__.py", "node/bft/dag.py",
                 "node/bft/storage.py", "node/bft/primary.py", "node/bft/bft.py",
                 "node/tcp.py", "node/router.py", "node/gateway.py", "node/block_sync.py",
                 "node/roles.py", "node/rest.py", "node/cli.py", "node/cdn.py",
                 "node/display.py"):
        assert os.path.join("snarkos_tpu_torch", name) in rel, name
    assert os.path.join("tests", "torch_bft_support.py") in rel
    assert os.path.join("tests", "torch_net_support.py") in rel


def test_node_entry_points_refuse_without_card():
    """The ledger's entry points resolve the card before they touch a
    cache, a file or a proof; the block check's batch has no host
    fallback."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    import inspect

    from snarkos_tpu_torch import convert
    from snarkos_tpu_torch.node import ledger, types

    comm = types.Committee.new(1, {"aleo1" + "11" * 32: 100})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ledger.Ledger(comm)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ledger.create_transaction(b"execute credits.aleo/bond_public 5u64")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ledger.make_genesis(comm)
    for fn, args in ((ledger.global_varuna, ()), (ledger.execution_srs, (512,)),
                     (ledger.verify_transaction, (None,)), (ledger.MockLedgerService, (comm,))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(*args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.ledger(comm.to_bytes(), [types.genesis_block(comm).to_bytes()])
    assert ledger._GENESIS_CACHE.get(comm.id) is None
    src = inspect.getsource(ledger.Ledger.check_next_block)
    assert "kzg_ops.batch_verify(" in src and "ref_kzg.batch_verify" not in src
