"""The CDN bootstrap (snarkos_tpu_torch/node/cdn.py) on the CPU: the JAX
package's tests/test_aux.py ``test_cdn_file_bootstrap`` (a ledger filled
from a directory of 50-block bundles); a bundle of the golden blocks 1-2
(tests/fixtures/torch_ledger_dev4.json) is the same bytes from both
packages' ``write_bundle``, and each ``read_bundle`` reads the other's;
then the rule by which the port parts from the reference: a
``RuntimeError`` from a block's check (a device fault) propagates out of
``sync_ledger_with_cdn``, the block unapplied, while a refusal
(``ValueError``, ``KeyError``, ``ledger.SRSTooSmall``) ends the bootstrap
at the last good block, as the reference does."""

import pytest

from snarkos_tpu.node import cdn as jcdn, types as jtypes
from snarkos_tpu_torch.node import cdn, ledger, types
from snarkos_tpu_torch.node.ledger import CoreLedgerService, Ledger

import torch_node_support as sup
from torch_net_support import run


@pytest.fixture(scope="module")
def env():
    """The fixture's chain; one try a bundle (the reference retries a
    missing bundle 10 times over 5.5 s, and the last window's always are)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(cdn, "MAX_RETRIES", 1)
    yield sup.dev4_env(mp)
    mp.undo()


class _NoCheck(CoreLedgerService):
    def check_next_block(self, block):
        pass  # structural checks only (bundles carry no proofs)


def _empty_chain(comm, n):
    src = Ledger(comm, device="cpu")
    for i in range(n):
        prev = src.latest_block
        src.advance_to_next_block(types.Block(
            height=prev.height + 1, previous_hash=prev.hash, timestamp=prev.timestamp + 1,
            round=2 * (i + 1), epoch_hash=src._next_epoch_hash(prev.height + 1),
            proof_target=prev.proof_target, subdag=None, transmissions=()))
    return src


def _publish(src, path, top):
    for start in range(0, top + 1, cdn.BLOCKS_PER_FILE):
        blocks = [src.get_block(h) for h in range(start, min(start + cdn.BLOCKS_PER_FILE,
                                                              top + 1))]
        if len(blocks) == cdn.BLOCKS_PER_FILE:
            cdn.write_bundle(str(path / cdn.bundle_name(start)), blocks)


def test_cdn_file_bootstrap(env, tmp_path):
    """A fresh ledger bootstraps from a file:// CDN of 1 + 100 blocks: every
    complete bundle applied, the hashes the source's."""
    comm = env[1]
    src = _empty_chain(comm, 100)
    _publish(src, tmp_path, 100)
    dst = _NoCheck(Ledger(comm, device="cpu"))
    applied = run(cdn.sync_ledger_with_cdn(f"file://{tmp_path}", dst), 60)
    assert applied >= 99 and dst.latest_height() == applied
    assert dst.ledger.get_hash(50) == src.get_hash(50)
    assert run(cdn.cdn_height(f"file://{tmp_path}"), 10) == 100


def test_bundles_match_the_jax_package(env, tmp_path):
    """A bundle of the golden blocks 1-2: the same bytes from both packages'
    write_bundle, and each package reads the other's."""
    doc, _comm, blocks = env
    jblocks = [jtypes.Block.from_bytes(bytes.fromhex(b)) for b in doc["blocks"]]
    mine, theirs = tmp_path / "port.bundle", tmp_path / "jax.bundle"
    cdn.write_bundle(str(mine), blocks)
    jcdn.write_bundle(str(theirs), jblocks)
    assert mine.read_bytes() == theirs.read_bytes()
    assert [b.to_bytes().hex() for b in cdn.read_bundle(theirs.read_bytes())] == doc["blocks"]
    assert [b.to_bytes().hex() for b in jcdn.read_bundle(mine.read_bytes())] == doc["blocks"]
    assert cdn.bundle_name(50) == jcdn.bundle_name(50) == "block.50.100.bundle"


class _Failing(CoreLedgerService):
    """Checks nothing until ``height``, where it raises ``exc``."""

    def __init__(self, led, height, exc):
        super().__init__(led)
        self.height, self.exc = height, exc

    def check_next_block(self, block):
        if block.height == self.height:
            raise self.exc


@pytest.mark.parametrize("exc,propagates", [
    (RuntimeError("g1_horner_chain: CUDA error 700"), True),
    (ValueError("invalid puzzle solution"), False), (KeyError("unknown program"), False),
    (ledger.SRSTooSmall("SRS artifact too small"), False)],
    ids=["RuntimeError", "ValueError", "KeyError", "SRSTooSmall"])
def test_check_errors_refuse_or_propagate(env, tmp_path, exc, propagates):
    comm = env[1]
    src = _empty_chain(comm, 50)
    _publish(src, tmp_path, 50)
    dst = _Failing(Ledger(comm, device="cpu"), 20, exc)
    if propagates:
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            run(cdn.sync_ledger_with_cdn(f"file://{tmp_path}", dst), 60)
    else:
        assert run(cdn.sync_ledger_with_cdn(f"file://{tmp_path}", dst), 60) == 19
    assert dst.latest_height() == 19
