"""The node's CLI (snarkos_tpu_torch/node/cli.py) and display on the CPU:
the dev accounts and committee are the JAX package's; the parser has every
subcommand and option string of the JAX parser, and ``--device`` on
``start``; ``start --srs <artifact>`` makes the port's Prover read the
ceremony SRS (a fault the port once had: its puzzle ignored the
artifact); ``start`` returns 1 when the node stopped on
a device fault, from its sync loop or from the CDN bootstrap, and 0 when it
was stopped; the display's overview reads a Validator's state.

``start`` runs in this process with ``--device cpu`` on the committee and
genesis of tests/fixtures/torch_ledger_dev4.json, on port 0 and outside
``--dev`` mode (whose ports are fixed); each test stops its node itself."""

import argparse
import asyncio

import pytest
import torch

from snarkos_tpu.node import cli as jcli
from snarkos_tpu.node.types import point_to_address as jpoint_to_address
from snarkos_tpu.ops import puzzle as jpuzzle
from snarkos_tpu_torch.crypto import params, srs_artifact
from snarkos_tpu_torch.crypto.ref import g1 as ref_g1, kzg as ref_kzg
from snarkos_tpu_torch.node import cdn, cli, ledger, roles, types
from snarkos_tpu_torch.node.block_sync import BlockSync
from snarkos_tpu_torch.node.display import Display
from snarkos_tpu_torch.ops import g1, puzzle

import torch_node_support as sup

R = params.FR_MODULUS
CEREMONY_TAU = pow(params.FR_GENERATOR, 24681357, R)


@pytest.fixture
def env(monkeypatch, tmp_path):
    """The fixture's chain, the puzzle's environment restored after the
    test (start sets it), and the node's base options: port 0, no REST, its
    ledger under tmp_path."""
    doc, comm, blocks = sup.dev4_env(monkeypatch)
    for name in ("SNARKOS_TPU_SRS_PATH", "SNARKOS_TPU_SRS_DIGEST",
                 "SNARKOS_TPU_PUZZLE_LOG_DEGREE"):
        # setenv first, so that the variable start sets is removed after the
        # test also where it was not set before (delenv alone records nothing)
        monkeypatch.setenv(name, "")
        monkeypatch.delenv(name)
    monkeypatch.setattr(roles, "SYNC_INTERVAL_S", 0.02)
    base = ["start", "--private-key-seed", "cli test", "--node", "127.0.0.1:0",
            "--bft", "127.0.0.1:0", "--norest", "--storage", str(tmp_path / "ledger.dat"),
            "--device", "cpu"]
    return comm, base


def _stop_after_start(monkeypatch, cls, delay=0.0):
    """Make ``cls.start`` stop the node ``delay`` seconds after it has
    started, as a signal would; the started nodes are returned. A test that
    waits for the node to stop itself gives a long delay, so that a node
    which does not stop ends the test with status 0 instead of hanging."""
    started, real = [], cls.start

    async def start(self):
        await real(self)
        started.append(self)
        loop = asyncio.get_running_loop()
        loop.call_later(delay, lambda: loop.create_task(self.shut_down()))

    monkeypatch.setattr(cls, "start", start)
    return started


# ------------------------------------------------------ against the JAX package
def test_dev_accounts_and_committees_match_the_jax_package():
    for i in range(8):
        mine, theirs = cli.dev_account(i), jcli.dev_account(i)
        assert (mine.sk, cli.AccountView(mine).address) == (theirs.sk,
                                                            jpoint_to_address(theirs.pk))
    for n in range(1, 5):
        mine, theirs = cli.dev_committee(n), jcli.dev_committee(n)
        assert mine.id == theirs.id and mine.to_bytes() == theirs.to_bytes()
    assert (cli.DEV_SEED, cli.DEFAULT_DATA_DIR) == (jcli.DEV_SEED, jcli.DEFAULT_DATA_DIR)


def _surface(parser: argparse.ArgumentParser, path=()) -> dict:
    """{subcommand path: sorted option strings (and positional names)}."""
    out = {path: sorted(s for a in parser._actions for s in (a.option_strings or [a.dest])
                        if not isinstance(a, argparse._SubParsersAction))}
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            for name, sub in a.choices.items():
                out.update(_surface(sub, path + (name,)))
    return out


def _jax_parser() -> argparse.ArgumentParser:
    """The JAX CLI's parser, caught as its main() parses."""
    class Caught(Exception):
        pass

    def catch(self, args=None, namespace=None):
        raise Caught(self)

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = catch
    try:
        jcli.main([])
    except Caught as c:
        return c.args[0]
    finally:
        argparse.ArgumentParser.parse_args = real
    raise AssertionError("the JAX CLI parsed nothing")


def test_parser_is_the_jax_parser_plus_device():
    mine, theirs = _surface(cli.build_parser()), _surface(_jax_parser())
    assert set(mine) == set(theirs) and len(mine) > 10
    for path, opts in theirs.items():
        extra = ["--device"] if path == ("start",) else []
        assert mine[path] == sorted(opts + extra), path
    args = cli.build_parser().parse_args(["start", "--dev", "1"])
    assert args.device == "cuda" and args.dev == 1


# ------------------------------------------------------- the ceremony SRS
def test_start_srs_makes_the_prover_read_the_ceremony_srs(env, monkeypatch, tmp_path):
    """``start --prover --srs <artifact> --srs-digest <d>``: the Prover's
    puzzle (built in start) loads the artifact, is_dev False, its points the
    artifact's, as the JAX Puzzle loads it; a wrong digest raises on both
    sides."""
    _comm, base = env
    art = ref_kzg.SRS.setup(1 << 2, tau=CEREMONY_TAU)
    path = str(tmp_path / "ceremony.srs")
    digest = srs_artifact.save_srs(path, art)
    monkeypatch.setattr(srs_artifact.msm, "msm", sup.host_sum_msm)
    monkeypatch.setattr(puzzle, "_PUZZLE", None)
    started = _stop_after_start(monkeypatch, roles.Prover)
    argv = base + ["--prover", "--puzzle-log-degree", "2", "--srs", path]

    assert cli.main(argv + ["--srs-digest", digest]) == 0
    (prover,) = started
    pz = prover.puzzle
    assert pz is puzzle._PUZZLE and pz.device == torch.device("cpu") and pz.log_degree == 2
    assert pz.srs.is_dev is False
    powers = [ref_g1.from_affine(ref_g1.affine(p)) for p in art.powers_g1]
    assert pz.srs.srs_ref.powers_g1 == powers
    want = g1.encode_points(powers)
    for got, exp in zip((pz.srs.points.x, pz.srs.points.y, pz.srs.points.z),
                        (want.x, want.y, want.z)):
        assert torch.equal(got, exp)
    jpz = jpuzzle.Puzzle(2)  # reads the environment start set
    assert jpz.srs.srs_ref.powers_g1 == pz.srs.srs_ref.powers_g1
    assert (jpz.srs.srs_ref.h, jpz.srs.srs_ref.tau_h, jpz.srs.is_dev) == (
        pz.srs.srs_ref.h, pz.srs.srs_ref.tau_h, pz.srs.is_dev)

    puzzle._PUZZLE = None
    with pytest.raises(srs_artifact.SRSArtifactError, match="digest"):
        cli.main(argv + ["--srs-digest", "00" * 32])
    assert len(started) == 1


# ------------------------------------------------------ the exit status
def test_start_returns_0_when_stopped(env, monkeypatch):
    _comm, base = env
    started = _stop_after_start(monkeypatch, roles.Validator)
    assert cli.main(base + ["--allow-dev-srs"]) == 0
    (v,) = started
    assert v.fault is None and v.halted.is_set() and not v.router._running


@pytest.mark.parametrize("role", ["--validator", "--client"])
def test_start_returns_1_on_a_device_fault(env, monkeypatch, capsys, role):
    """The node's sync loop meets a device fault: the role stops itself and
    start returns 1, naming the fault."""
    _comm, base = env

    async def try_block_sync(self):
        raise RuntimeError("bucket_scan_serial: CUDA error 700")

    monkeypatch.setattr(BlockSync, "try_block_sync", try_block_sync)
    cls = roles.Validator if role == "--validator" else roles.Client
    started = _stop_after_start(monkeypatch, cls, delay=30.0)
    assert cli.main(base + [role, "--allow-dev-srs"]) == 1
    (node,) = started
    assert "CUDA error 700" in str(node.fault) and not node.router._running
    assert "stopped on a device fault: bucket_scan_serial: CUDA error 700" in \
        capsys.readouterr().err


def test_cdn_device_fault_returns_1(env, monkeypatch, tmp_path):
    """A device fault in the CDN bootstrap's block check: start returns 1
    without starting the node; the reference went on to p2p sync."""
    comm, base = env
    src = ledger.Ledger(comm, device="cpu")
    blocks = [src.latest_block]
    for i in range(cdn.BLOCKS_PER_FILE - 1):
        prev = blocks[-1]
        blocks.append(types.Block(
            height=prev.height + 1, previous_hash=prev.hash, timestamp=prev.timestamp + 1,
            round=2 * (i + 1), epoch_hash=prev.epoch_hash, proof_target=prev.proof_target,
            subdag=None, transmissions=()))
    bundles = tmp_path / "cdn"
    bundles.mkdir()
    cdn.write_bundle(str(bundles / cdn.bundle_name(0)), blocks)
    monkeypatch.setattr(cdn, "MAX_RETRIES", 1)

    def check_next_block(self, block):
        raise RuntimeError("g1_bucket_fixup: CUDA error 700")

    monkeypatch.setattr(ledger.CoreLedgerService, "check_next_block", check_next_block)
    started = _stop_after_start(monkeypatch, roles.Validator)
    assert cli.main(base + ["--allow-dev-srs", "--cdn", f"file://{bundles}"]) == 1
    assert started == []


# ------------------------------------------------------------- the display
class _Screen:
    def __init__(self):
        self.rows = []

    def addnstr(self, y, x, text, n, *attr):
        self.rows.append(text)


def test_display_overview_reads_the_node(env):
    comm, _base = env
    v = roles.Validator(cli.AccountView(cli.dev_account(0)), comm, device="cpu")
    d = Display(v)
    for i in range(600):
        d.push_log(f"line {i}")
    assert len(d.log_lines) == 500 and d.log_lines[0] == "line 100"
    screen = _Screen()
    d._draw_overview(screen, 24, 80)
    assert [r.split(":")[0].strip() for r in screen.rows] == [
        "address", "peers", "height", "round", "proof target", "bft round", "mempool"]
    assert screen.rows[0].endswith(v.account.address) and screen.rows[4].endswith(": 256")
    d.stop()
    assert not d._running
