"""An N-validator network of the port's ``Consensus`` in one process, over an
in-process transport: the copy of ``tests/common_bft.py`` (``MockTransport``,
``TestNetwork``) on ``snarkos_tpu_torch.node.consensus``, for the port's CPU
tests and for chip_smoke.py's consensus phase on the card.

Each validator gets the ledger service that ``ledger_factory(committee)``
returns: ``MockLedgerService(committee, device="cpu")`` in the CPU tests,
``CoreLedgerService(Ledger(committee, device=cuda))`` on the card, where
every check the consensus makes (intake, the proposal re-checks, the block
check at each commit) runs on the card. The accounts sign; ``dev_account``
derives the dev accounts as the node's CLI does (``snarkos_tpu/node/cli.py``
``dev_account``), so that ``dev_committee(4)`` is the committee of
tests/fixtures/torch_ledger_dev4.json. ``StubLedger`` and the stand-in
signatures serve the CPU tests that hold the core against the JAX
package's. Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging

from snarkos_tpu_torch.crypto.ref import edwards
from snarkos_tpu_torch.node import events as ev
from snarkos_tpu_torch.node.consensus import Consensus
from snarkos_tpu_torch.node.types import Committee, point_to_address

DEV_SEED = 1234567890

log = logging.getLogger("testnet")


def dev_account(index: int) -> edwards.Account:
    """The node CLI's dev account ``index`` (``--dev index``)."""
    seed = hashlib.sha256(b"snarkos_tpu.dev" + DEV_SEED.to_bytes(8, "little")
                          + index.to_bytes(4, "little")).digest()
    return edwards.Account.new(seed=seed)


def dev_committee(num_validators: int) -> Committee:
    """The node CLI's dev committee: dev accounts 0..n-1, 100 stake each."""
    members = {point_to_address(dev_account(i).pk): 100 for i in range(num_validators)}
    return Committee.new(1, members)


def standin_signature(pk_bytes: bytes, msg: bytes) -> tuple:
    """A keyed hash of (signer, message) in the form of a Schnorr signature:
    the CPU tests put it in place of ``edwards.sign_bytes`` /
    ``verify_bytes`` where they test the consensus flow and not the
    signatures (four pure-Python Schnorr verifies a certificate)."""
    h = hashlib.sha256(b"stand-in signature" + pk_bytes + msg).digest()
    return (int.from_bytes(h, "little") % edwards.ORDER, 1)


def standin_sign(sk, pk, msg, nonce=None):
    return standin_signature(edwards.compress(pk), msg)


def standin_verify(pk, msg, sig):
    return tuple(sig) == standin_signature(edwards.compress(pk), msg)


class StubLedger:
    """What the consensus core asks of a ledger service, over one fixed
    committee of either package, checking nothing; committed transmission
    ids are kept."""

    def __init__(self, committee):
        self.committee = committee
        self.committed = set()

    def latest_round(self): return 0
    def latest_height(self): return 0
    def current_committee(self): return self.committee
    def committee_lookback_for(self, round_): return self.committee
    def contains_transmission(self, tid): return tid in self.committed
    def check_solution_basic(self, sol): pass
    def check_transaction_basic(self, tx): pass


class AccountView:
    """Adapter exposing .address/.sk/.pk for signing APIs."""

    def __init__(self, acct):
        self.sk = acct.sk
        self.pk = acct.pk
        self.address = point_to_address(acct.pk)


class MockTransport:
    """Routes events directly between in-process consensus instances."""

    def __init__(self, network: "TestNetwork", my_address: str):
        self.network = network
        self.address = my_address
        self.connected: set[str] = set()

    def send(self, peer, event) -> bool:
        # peer may be a validator address (str); in mock mode addr==address
        target = peer if isinstance(peer, str) else peer[0]
        if target not in self.network.nodes:
            return False
        self.network.deliver(self.address, target, event)
        return True

    def broadcast(self, event) -> int:
        n = 0
        for addr in self.connected:
            if self.send(addr, event):
                n += 1
        return n


class TestNetwork:
    """N complete ``Consensus`` instances wired over MockTransports.

    ``accounts``: the validators' edwards accounts; ``ledger_factory``:
    committee -> a ledger service, called once a validator; ``committee``:
    None for the accounts at 100 stake each."""

    __test__ = False  # not a pytest class

    def __init__(self, accounts, ledger_factory, committee: Committee | None = None):
        self.accounts = list(accounts)
        if committee is None:
            committee = Committee.new(1, {point_to_address(a.pk): 100 for a in self.accounts})
        self.committee = committee
        self.nodes: dict[str, Consensus] = {}
        self.services: dict[str, object] = {}
        self.transports: dict[str, MockTransport] = {}
        self.blocks: dict[str, list] = {}
        self._intake_tasks: list[asyncio.Task] = []
        for acct in self.accounts:
            addr = point_to_address(acct.pk)
            if not committee.is_member(addr):
                raise ValueError(f"account {addr[:16]} is not a committee member")
            service = ledger_factory(committee)
            transport = MockTransport(self, addr)
            node = Consensus(AccountView(acct), service, transport)
            self.nodes[addr] = node
            self.services[addr] = service
            self.transports[addr] = transport
            self.blocks[addr] = []
            node.on_block = self._make_block_hook(addr)

    def _make_block_hook(self, addr):
        async def hook(block):
            self.blocks[addr].append(block)

        return hook

    def connect_all(self):
        for addr, transport in self.transports.items():
            transport.connected = {a for a in self.nodes if a != addr}

    def deliver(self, sender: str, target: str, event):
        node = self.nodes[target]

        async def handle():
            try:
                if isinstance(event, ev.BatchPropose):
                    await node.primary.process_batch_propose(sender, event)
                elif isinstance(event, ev.BatchSignature):
                    await node.primary.process_batch_signature(sender, event, sender)
                elif isinstance(event, ev.BatchCertified):
                    await node.primary.process_batch_certified(sender, event)
                elif isinstance(event, ev.CertificateRequest):
                    node.primary.serve_certificate_request(sender, event)
                elif isinstance(event, ev.CertificateResponse):
                    await node.primary.process_certificate_response(sender, event)
                elif isinstance(event, ev.TransmissionRequest):
                    node.primary.worker.serve_transmission_request(sender, event)
                elif isinstance(event, ev.TransmissionResponse):
                    node.primary.worker.process_transmission_response(event)
                elif isinstance(event, ev.WorkerPing):
                    node.primary.worker.process_worker_ping(sender, event)
            except Exception as exc:
                log.debug("%s handling %s from %s failed: %s",
                          target[:12], type(event).__name__, sender[:12], exc)

        asyncio.get_event_loop().create_task(handle())

    async def start_intake(self):
        """The mempool half of ``Consensus.run`` alone: each node's drain
        loop, which moves what ``add_unconfirmed_solution`` /
        ``add_unconfirmed_transaction`` queued into its worker after the
        ledger's check, and no primary. ``start`` ends it."""
        for node in self.nodes.values():
            node._running = True
            self._intake_tasks.append(asyncio.create_task(node._mempool_drain_loop()))

    async def start(self):
        """``Consensus.run`` on every node (after ``start_intake``, its
        drain loops give way to the ones ``run`` starts)."""
        for task in self._intake_tasks:
            task.cancel()
        await asyncio.gather(*self._intake_tasks, return_exceptions=True)
        self._intake_tasks.clear()
        for node in self.nodes.values():
            await node.run()

    async def stop(self):
        """Shut every node down, cancel every task of the loop but the
        caller's (the drain loops, the event handlers) and wait for them;
        checks already in the loop's executor run on to their end: wait
        for them with ``loop.shutdown_default_executor()``."""
        for node in self.nodes.values():
            await node.shut_down()
        me = asyncio.current_task()
        tasks = [t for t in asyncio.all_tasks() if t is not me]
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
