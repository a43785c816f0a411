"""The node's roles (snarkos_tpu_torch/node/roles.py) on the CPU, over
localhost TCP: case for case the JAX package's tests/test_devnet.py (four
Validators commit blocks; an account outside the committee cannot complete
the gateway handshake), tests/test_roles_e2e.py (a Client syncs from a
Validator; a router of another genesis is refused; the Client checks
solutions off the event loop) and test_aux.py's restart (a Validator
restarted from its store rejoins at the tip). Then the Prover's loop, and
the rule by which the port parts from the reference at each place the
reference logs and carries on: a ``RuntimeError`` (a device fault) stops
the node, kept as ``fault``; a ``ValueError``, ``KeyError`` or
``ledger.SRSTooSmall`` keeps the reference's handling.

Every role runs with ``device="cpu"`` on the committee and genesis of
tests/fixtures/torch_ledger_dev4.json (``torch_node_support.dev4_env``).
The timers are short, the signatures the keyed-hash stand-in and the
transmissions' checks stubbed where those are not the point; the tests
poll and assert no timing. ``-m slow`` runs the devnet with every check
and a transfer_public created and executed through consensus."""

import asyncio
import threading
import types as pytypes

import pytest
import torch

from snarkos_tpu_torch.crypto.ref import edwards
from snarkos_tpu_torch.node import events as ev, ledger, messages as msg, roles, types
from snarkos_tpu_torch.node import router as router_mod
from snarkos_tpu_torch.node.bft import bft as bft_mod, primary
from snarkos_tpu_torch.node.cli import AccountView
from snarkos_tpu_torch.node.gateway import Gateway
from snarkos_tpu_torch.node.router import Router
from snarkos_tpu_torch.ops import puzzle

import torch_node_support as sup
from torch_bft_support import standin_sign, standin_verify
from torch_net_support import account, run, until

FAULT = RuntimeError("mont_mul_fr: CUDA error 700")
_REAL_SIGN, _REAL_VERIFY = edwards.sign_bytes, edwards.verify_bytes
_JAX_TIMERS = {name: getattr(mod, name) for mod, name in (
    (primary, "MIN_BATCH_DELAY_S"), (primary, "MAX_BATCH_DELAY_S"),
    (primary, "MAX_LEADER_CERTIFICATE_DELAY_S"))}
TIMERS = ((primary, "MIN_BATCH_DELAY_S", 0.02), (primary, "MAX_BATCH_DELAY_S", 0.1),
          (primary, "MAX_LEADER_CERTIFICATE_DELAY_S", 0.2),
          (bft_mod, "MAX_LEADER_CERTIFICATE_DELAY_S", 0.2))


@pytest.fixture
def env(monkeypatch):
    """The fixture's committee and genesis, short timers, the stand-in
    signatures and a sync loop that runs every 20 ms."""
    doc, comm, blocks = sup.dev4_env(monkeypatch)
    for mod, name, value in TIMERS:
        monkeypatch.setattr(mod, name, value)
    monkeypatch.setattr(edwards, "sign_bytes", standin_sign)
    monkeypatch.setattr(edwards, "verify_bytes", standin_verify)
    monkeypatch.setattr(roles, "SYNC_INTERVAL_S", 0.02)
    return pytypes.SimpleNamespace(doc=doc, comm=comm, blocks=blocks)


def _av(i: int) -> AccountView:
    return AccountView(account(i))


def _stub_checks(node) -> None:
    node.ledger_service.check_solution_basic = lambda sol: None
    node.ledger_service.check_transaction_basic = lambda tx: None


async def _spawn_validators(comm, n=4, storage=None, translucent=True, stub=True):
    nodes = []
    for i in range(n):
        v = roles.Validator(_av(i), comm, node_port=0, bft_port=0, rest_port=None,
                            storage_path=storage[i] if storage else None,
                            translucent=translucent, device="cpu")
        if stub:
            _stub_checks(v)
        await v.start()
        nodes.append(v)
    # everyone trusts everyone, plus the initial dials i -> 0..i-1
    for i, v in enumerate(nodes):
        v.gateway.trusted_validators = [nodes[j].gateway.local_addr for j in range(n) if j != i]
    for i, v in enumerate(nodes):
        for j in range(i):
            await v.gateway.connect_to(nodes[j].gateway.local_addr)
    return nodes


def _committed(v) -> list:
    return [t.id for b in v.ledger.blocks[1:] for t in b.transmissions]


def _grow_chain(led, n):
    for i in range(n):
        prev = led.latest_block
        led.advance_to_next_block(types.Block(
            height=prev.height + 1, previous_hash=prev.hash,
            timestamp=prev.timestamp + 1, round=2 * (i + 1),
            epoch_hash=led._next_epoch_hash(prev.height + 1),
            proof_target=prev.proof_target, subdag=None, transmissions=()))


def _stub_solution(epoch_hash, address, i):
    return types.Solution(epoch_hash=epoch_hash, address=address, nonce=i,
                          commitment=bytes(97), eval_y=i, witness=bytes(97))


# ------------------------------------------------------- tests/test_devnet.py
def test_tcp_devnet_commits_blocks(env):
    """Four Validators over localhost TCP (signed gateway handshakes, the
    wire codecs) commit a block of the transmissions put in their workers,
    the chains equal, each transmission committed once."""
    async def go():
        nodes = await _spawn_validators(env.comm)
        try:
            assert await until(lambda: all(len(v.gateway.connected_validators) == 3
                                           for v in nodes), 20), "no full mesh"
            sols = [_stub_solution(nodes[0].ledger.latest_epoch_hash,
                                   nodes[0].account.address, i) for i in range(4)]
            for sol in sols:
                for v in nodes:
                    v.consensus.primary.worker.ready[sol.id] = \
                        types.Transmission.from_solution(sol)
            want = {s.id for s in sols}
            assert await until(lambda: all(want <= set(_committed(v)) for v in nodes), 30), \
                f"heights {[v.ledger.latest_height for v in nodes]}"
            h = min(v.ledger.latest_height for v in nodes)
            assert len({v.ledger.get_hash(h) for v in nodes}) == 1, "divergent chains"
            for v in nodes:
                got = _committed(v)
                assert len(got) == len(set(got)) and set(got) == want
        finally:
            for v in nodes:
                await v.shut_down()

    run(go(), 60)


@pytest.mark.slow
def test_tcp_devnet_commits_blocks_checked(env, monkeypatch):
    """The same devnet with every check (Schnorr signatures, the block check
    and the transmissions' checks on the CPU, the KZG batch's MSMs by the
    host Pippenger, Varuna commitments p(tau) G): a transfer_public created
    through ``create_transaction`` rides consensus and its credits.aleo
    mapping update commits. The JAX package's timers: a round outlasts its
    Schnorr checks."""
    for mod, name, _ in TIMERS:
        monkeypatch.setattr(mod, name, _JAX_TIMERS[name])
    monkeypatch.setattr(edwards, "sign_bytes", _REAL_SIGN)
    monkeypatch.setattr(edwards, "verify_bytes", _REAL_VERIFY)
    from snarkos_tpu_torch.ops import msm

    monkeypatch.setattr(ledger, "device_commit", sup.tau_commit)
    monkeypatch.setattr(msm, "msm", sup.host_sum_msm)

    async def go():
        nodes = await _spawn_validators(env.comm, translucent=False, stub=False)
        try:
            assert await until(lambda: all(len(v.gateway.connected_validators) == 3
                                           for v in nodes), 60)
            payee = "aleo1" + "c" * 64
            tx = await asyncio.get_running_loop().run_in_executor(None, lambda: (
                ledger.create_transaction(
                    f"execute credits.aleo/transfer_public {payee} 9u64".encode(),
                    account=nodes[0].account, device="cpu")))
            for v in nodes:
                v.consensus.primary.worker.ready[tx.id] = types.Transmission.from_transaction(tx)
            assert await until(lambda: min(v.ledger.latest_height for v in nodes) >= 2, 600)
            h = min(v.ledger.latest_height for v in nodes)
            assert len({v.ledger.get_hash(h) for v in nodes}) == 1
            assert await until(lambda: any(
                v.ledger.get_mapping_value("credits.aleo", "account", payee) == "9u64"
                for v in nodes), 600)
        finally:
            for v in nodes:
                await v.shut_down()

    run(go(), 1800)


def test_gateway_rejects_unauthorized(env):
    """A non-committee account cannot complete the gateway handshake."""
    async def go():
        v0 = roles.Validator(_av(0), env.comm, node_port=0, bft_port=0, rest_port=None,
                             translucent=True, device="cpu")
        await v0.start()
        try:
            outsider = Gateway(AccountView(edwards.Account.new(seed=b"\x99" * 32)),
                               ledger.MockLedgerService(env.comm, device="cpu"))
            await outsider.run()
            await outsider.connect_to(v0.gateway.local_addr)  # returns once refused
            assert len(v0.gateway.connected_validators) == 0
            assert len(outsider.connected_validators) == 0
            await outsider.shut_down()
        finally:
            await v0.shut_down()

    run(go(), 20)


# ---------------------------------------------------- tests/test_roles_e2e.py
def test_client_syncs_from_validator(env, monkeypatch):
    """A Client syncs 12 blocks from a Validator through BlockLocators and
    BlockRequests over the public router plane (the heartbeat that sends the
    Validator's locators every 50 ms)."""
    monkeypatch.setattr(router_mod, "HEARTBEAT_S", 0.05)

    async def go():
        validator = roles.Validator(_av(0), env.comm, node_port=0, bft_port=0,
                                    rest_port=None, translucent=True, device="cpu")
        _grow_chain(validator.ledger, 12)
        await validator.start()
        client = roles.Client(_av(5), env.comm, node_port=0, rest_port=None, device="cpu")
        client.ledger_service.check_next_block = lambda b: None
        await client.start()
        try:
            assert await client.router.connect(validator.router.local_addr)
            client.router.send(validator.router.local_addr, msg.Ping(
                msg.VERSION, msg.NodeType.CLIENT, client.ledger.latest_block_locators()))
            assert await until(lambda: client.ledger.latest_height >= 12, 20), \
                f"client stuck at height {client.ledger.latest_height}"
            assert client.ledger.get_hash(12) == validator.ledger.get_hash(12)
            assert client.fault is None and not client.halted.is_set()
        finally:
            await client.shut_down()
            await validator.shut_down()

    run(go(), 40)


def test_router_handshake_rejects_wrong_genesis(env):
    async def go():
        validator = roles.Validator(_av(0), env.comm, node_port=0, bft_port=0,
                                    rest_port=None, translucent=True, device="cpu")
        await validator.start()
        try:
            rogue = Router(_av(9), msg.NodeType.CLIENT, b"\xAB" * 32)
            await rogue.run()
            await rogue.connect(validator.router.local_addr)  # returns once refused
            assert not rogue.peers, "rogue connected despite genesis mismatch"
            await rogue.shut_down()
        finally:
            await validator.shut_down()

    run(go(), 20)


def test_client_gossip_verify_off_event_loop(env):
    """The Client runs check_solution_basic in an executor (reference
    spawn_blocking, ledger.rs:312): the check below waits for the event
    loop to turn, which it could not do on the loop's own thread."""
    async def go():
        client = roles.Client(_av(6), env.comm, node_port=0, rest_port=None, device="cpu")
        released, sent = threading.Event(), []

        def check(sol):
            assert released.wait(10), "the event loop did not run during the check"

        client.ledger_service.check_solution_basic = check
        client.router.propagate = lambda m, exclude=None: sent.append(m)
        sol = _stub_solution(bytes(32), "aleo1" + "00" * 32, 7)
        m = msg.UnconfirmedSolution(sol.id, sol.to_bytes())
        task = asyncio.ensure_future(client._on_unconfirmed_solution(("127.0.0.1", 1), None, m))
        for _ in range(5):
            await asyncio.sleep(0)
        assert not task.done()
        released.set()
        await task
        assert sent == [m]

    run(go(), 20)


# ------------------------------------------------------ tests/test_aux.py
def test_restart_rejoins_at_tip(env, tmp_path):
    """A Validator restarted from its stored ledger replays the last GC
    window into Narwhal storage and resumes at the tip round, not round 1."""
    storage = [str(tmp_path / f"dev-{i}" / "ledger.dat") for i in range(4)]

    async def first():
        nodes = await _spawn_validators(env.comm, storage=storage)
        try:
            for i in range(2):
                sol = _stub_solution(nodes[0].ledger.latest_epoch_hash,
                                     nodes[0].account.address, i)
                for v in nodes:
                    v.consensus.primary.worker.ready[sol.id] = \
                        types.Transmission.from_solution(sol)
            assert await until(lambda: min(v.ledger.latest_height for v in nodes) >= 2, 30)
            return nodes[0].ledger.latest_round
        finally:
            for v in nodes:
                await v.shut_down()

    tip_round = run(first(), 60)

    async def restart():
        v0 = roles.Validator(_av(0), env.comm, node_port=0, bft_port=0, rest_port=None,
                             storage_path=storage[0], translucent=True, device="cpu")
        assert v0.ledger.latest_height >= 2  # the stored chain reloaded
        await v0.start()
        try:
            assert v0.consensus.storage.current_round() >= tip_round
            assert v0.consensus.bft.dag.last_committed_round >= tip_round
            tip_block = v0.ledger.latest_block
            if tip_block.subdag is not None:
                cert = tip_block.subdag.leader_certificate
                assert v0.consensus.storage.contains_certificate(cert.id)
        finally:
            await v0.shut_down()

    run(restart(), 20)


# ------------------------------------------------------------- the Prover
class _StubPuzzle:
    """``global_puzzle``'s instance for the Prover: its prove_batch answers
    from ``answer`` (a list of solution ids, or an exception to raise)."""

    def __init__(self, answer):
        self.log_degree, self.device = 12, torch.device("cpu")
        self.answer, self.calls = answer, []

    def prove_batch(self, epoch_hash, address, nonces, proof_target=None):
        self.calls.append((threading.current_thread() is threading.main_thread(), epoch_hash,
                           address, list(nonces), proof_target))
        if isinstance(self.answer, BaseException):
            raise self.answer
        return [puzzle.PuzzleSolutionData(commitment=bytes([i]) * 97, eval_y=i,
                                          witness=bytes([i + 1]) * 97, solution_id=sid)
                for i, sid in enumerate(self.answer[:len(nonces)])]

    passes_target = staticmethod(puzzle.Puzzle.passes_target)


def _prover(monkeypatch, answer, **kw):
    stub = _StubPuzzle(answer)
    monkeypatch.setattr(puzzle, "_PUZZLE", stub)
    return roles.Prover(_av(4), b"\x01" * 32, log_degree=12, device="cpu", **kw), stub


def test_prover_loop_proves_and_propagates(env, monkeypatch):
    """The Prover's loop (JAX roles.py:426-469) takes the puzzle built in
    start(), runs prove_batch from an executor thread, keeps the solutions
    that pass the target and propagates them with their own nonces."""
    epoch = b"\x07" * 32
    prover, stub = _prover(monkeypatch, [0, (1 << 62) + 1, 1 << 62, 1 << 63],
                           nonce_batch=4, max_iterations=4)
    sent = []

    async def go():
        await prover.start()
        prover.router.propagate = lambda m, exclude: sent.append(m)
        assert prover.puzzle is stub
        prover.latest_epoch_hash, prover.latest_proof_target = epoch, 4
        try:
            assert await until(lambda: prover._tasks[1].done(), 10)
        finally:
            await prover.shut_down()

    run(go(), 20)
    (in_main, epoch_hash, address, nonces, target), = stub.calls
    assert not in_main and (epoch_hash, address, target) == (epoch, prover.account.address, None)
    assert prover.solutions_found == 2 and prover.fault is None
    want = [types.Solution(epoch_hash=epoch, address=prover.account.address, nonce=nonces[i],
                           commitment=bytes([i]) * 97, eval_y=i, witness=bytes([i + 1]) * 97)
            for i in (0, 2)]
    assert [m.solution for m in sent] == [s.to_bytes() for s in want]


@pytest.mark.parametrize("answer,stops", [(FAULT, True), (ValueError("bad epoch"), False),
                                          (ledger.SRSTooSmall("artifact"), False)],
                         ids=["RuntimeError", "ValueError", "SRSTooSmall"])
def test_prover_fault_stops_the_prover(env, monkeypatch, answer, stops):
    """A RuntimeError from prove_batch stops the Prover (fault kept, tasks
    ended, the router shut); anything else is logged and the loop goes on
    (the reference's debug log and 0.5 s pause)."""
    prover, stub = _prover(monkeypatch, answer)

    async def go():
        await prover.start()
        prover.latest_epoch_hash = b"\x07" * 32
        try:
            assert await until(lambda: stub.calls, 10)
            if stops:
                assert await until(prover.halted.is_set, 10)
            else:
                await asyncio.sleep(0.05)
                assert not prover.halted.is_set()
        finally:
            await prover.shut_down()

    run(go(), 20)
    assert (prover.fault is answer) == stops and (prover.fault is None) != stops
    assert all(t.done() for t in prover._tasks) and not prover.router._running


def test_prover_builds_its_puzzle_in_start(env, monkeypatch):
    """The puzzle is built in start(), before the router runs: a failed
    build is raised to the caller and no socket is bound."""
    def fail(log_degree=None, device=None):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(puzzle, "global_puzzle", fail)
    prover = roles.Prover(_av(4), b"\x01" * 32, log_degree=12, device="cpu")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        run(prover.start(), 10)
    assert not prover._tasks and not prover.router._running


# ------------------------------------------------- the fault rule, by place
@pytest.mark.parametrize("role", ["validator", "client"])
@pytest.mark.parametrize("exc,stops", [(FAULT, True), (ValueError("refused"), False),
                                       (KeyError("unknown"), False),
                                       (ledger.SRSTooSmall("artifact too small"), False)],
                         ids=["RuntimeError", "ValueError", "KeyError", "SRSTooSmall"])
def test_sync_loop_fault_stops_the_role(env, role, exc, stops):
    """What try_block_sync raises in the role's sync loop: a device fault
    stops the node, anything else is logged and the loop goes on."""
    async def go():
        if role == "validator":
            node = roles.Validator(_av(0), env.comm, node_port=0, bft_port=0,
                                   rest_port=None, device="cpu")
        else:
            node = roles.Client(_av(5), env.comm, node_port=0, rest_port=None, device="cpu")
        calls = []

        async def try_block_sync():
            calls.append(1)
            raise exc

        node.block_sync.try_block_sync = try_block_sync
        await node.start()
        try:
            if stops:
                assert await until(node.halted.is_set, 10)
            else:
                assert await until(lambda: len(calls) >= 3, 10)
                assert not node.halted.is_set()
        finally:
            await node.shut_down()
        return node

    node = run(go(), 20)
    assert (node.fault is exc) == stops and (node.fault is None) != stops
    assert node.halted.is_set() and not node.router._running


@pytest.mark.parametrize("exc,stops", [(FAULT, True), (ValueError("invalid subdag"), False)],
                         ids=["RuntimeError", "ValueError"])
def test_gateway_block_response_fault(env, exc, stops):
    """A block synced over the gateway whose check raises: a device fault
    stops the Validator; a refusal is logged as an invalid block."""
    async def go():
        v = roles.Validator(_av(0), env.comm, node_port=0, bft_port=0, rest_port=None,
                            device="cpu")
        seen = []

        def sync_storage_with_block(block):
            seen.append(block.height)
            raise exc

        v.consensus.sync_storage_with_block = sync_storage_with_block
        await v.start()
        try:
            await v._on_gateway_block_response(
                ("127.0.0.1", 1), msg.BlockResponse(msg.BlockRequest(1, 2), (env.blocks[0],)))
            assert seen == [1]
            assert await until(v.halted.is_set, 10) if stops else not v.halted.is_set()
        finally:
            await v.shut_down()
        return v

    v = run(go(), 20)
    assert (v.fault is exc) == stops and v.ledger.latest_height == 0


@pytest.mark.parametrize("exc,stops", [(FAULT, True), (ValueError("stale certificate"), False)],
                         ids=["RuntimeError", "ValueError"])
def test_primary_ping_fault(env, exc, stops):
    """A primary ping's certificate whose processing raises: a device fault
    stops the Validator; anything else is dropped, as the reference does."""
    async def go():
        v = roles.Validator(_av(0), env.comm, node_port=0, bft_port=0, rest_port=None,
                            device="cpu")
        got = []

        async def process_batch_certified(addr, event):
            got.append(event)
            raise exc

        v.consensus.primary.process_batch_certified = process_batch_certified
        await v.start()
        try:
            await v._on_primary_ping(("127.0.0.1", 1), ev.PrimaryPing(1, 3, b"cert"))
            assert v._gateway_peer_heights == {("127.0.0.1", 1): 3}
            assert got == [ev.BatchCertified(b"cert")]
            assert await until(v.halted.is_set, 10) if stops else not v.halted.is_set()
        finally:
            await v.shut_down()
        return v

    v = run(go(), 20)
    assert (v.fault is exc) == stops


def test_dev_tx_loop_fault(env, monkeypatch):
    """The dev transaction loop creates each transaction on the validator's
    device; a device fault there stops the Validator."""
    calls = []

    def create_transaction(payload, **kwargs):
        calls.append((payload, kwargs))
        raise FAULT

    monkeypatch.setattr(ledger, "create_transaction", create_transaction)

    async def go():
        v = roles.Validator(_av(0), env.comm, node_port=0, bft_port=0, rest_port=None,
                            dev_tx_interval=0.01, device="cpu")
        await v.start()
        try:
            assert await until(v.halted.is_set, 10)
        finally:
            await v.shut_down()
        return v

    v = run(go(), 20)
    assert v.fault is FAULT
    (payload, kwargs), = calls
    assert payload.startswith(b"dev-transfer-") and kwargs == {"device": torch.device("cpu")}


def test_client_sync_fault_stops_the_client(env, monkeypatch):
    """Over the router: the Client syncs from a Validator and the block
    check raises a device fault. insert_block_responses lets it through,
    and the Client role (not the router's handler task) stops the node at
    height 0; a refusal (ValueError) leaves it running at height 0."""
    monkeypatch.setattr(router_mod, "HEARTBEAT_S", 0.05)

    async def go(exc):
        validator = roles.Validator(_av(0), env.comm, node_port=0, bft_port=0,
                                    rest_port=None, translucent=True, device="cpu")
        _grow_chain(validator.ledger, 3)
        await validator.start()
        client = roles.Client(_av(5), env.comm, node_port=0, rest_port=None, device="cpu")
        checked = []

        def check_next_block(block):
            checked.append(block.height)
            raise exc

        client.ledger_service.check_next_block = check_next_block
        await client.start()
        try:
            assert await client.router.connect(validator.router.local_addr)
            client.router.send(validator.router.local_addr, msg.Ping(
                msg.VERSION, msg.NodeType.CLIENT, client.ledger.latest_block_locators()))
            assert await until(lambda: checked, 20)
            if exc is FAULT:
                assert await until(client.halted.is_set, 10)
            else:
                await asyncio.sleep(0.05)
                assert not client.halted.is_set()
        finally:
            await client.shut_down()
            await validator.shut_down()
        return client

    client = run(go(FAULT), 40)
    assert client.fault is FAULT and client.ledger.latest_height == 0
    client = run(go(ValueError("invalid block")), 40)
    assert client.fault is None and client.ledger.latest_height == 0


@pytest.mark.parametrize("exc,stops", [(FAULT, True), (ValueError("invalid puzzle solution"),
                                                       False)],
                         ids=["RuntimeError", "ValueError"])
def test_client_solution_check_fault(env, exc, stops):
    """A gossiped solution whose check raises: a ValueError drops only that
    solution (not propagated, the node running); a device fault stops the
    Client."""
    async def go():
        client = roles.Client(_av(6), env.comm, node_port=0, rest_port=None, device="cpu")
        sent = []

        def check(sol):
            raise exc

        client.ledger_service.check_solution_basic = check
        await client.start()
        client.router.propagate = lambda m, exclude=None: sent.append(m)
        try:
            sol = _stub_solution(bytes(32), "aleo1" + "00" * 32, 7)
            await client._on_unconfirmed_solution(
                ("127.0.0.1", 1), None, msg.UnconfirmedSolution(sol.id, sol.to_bytes()))
            assert sent == []
            assert await until(client.halted.is_set, 10) if stops else \
                not client.halted.is_set()
        finally:
            await client.shut_down()
        return client

    client = run(go(), 20)
    assert (client.fault is exc) == stops


def test_shut_down_runs_once(env):
    """shut_down after a fault waits for the fault's own shut-down; a second
    call does nothing more."""
    async def go():
        c = roles.Client(_av(6), env.comm, node_port=0, rest_port=None, device="cpu")
        await c.start()
        closes = []
        real = c._shut_down

        async def counted():
            closes.append(1)
            await real()

        c._shut_down = counted
        assert c._halt_on_fault(FAULT, "test")
        assert not c._halt_on_fault(ValueError("content"), "test")
        await c.shut_down()
        await c.shut_down()
        return c, closes

    c, closes = run(go(), 10)
    assert closes == [1] and c.fault is FAULT and c.halted.is_set()


def test_fault_rule_reads_is_device_fault():
    assert ledger.is_device_fault(FAULT)
    assert not ledger.is_device_fault(ledger.SRSTooSmall("x"))
    assert not ledger.is_device_fault(ValueError("x"))
    assert not ledger.is_device_fault(KeyError("x"))


# ------------------------------------- the fault rule in the consensus core
FAULT_OR_REFUSAL = pytest.mark.parametrize(
    "exc,stops", [(FAULT, True), (ValueError("invalid puzzle solution"), False)],
    ids=["RuntimeError", "ValueError"])


def _validator(env):
    return roles.Validator(_av(0), env.comm, node_port=0, bft_port=0, rest_port=None,
                           device="cpu")


@FAULT_OR_REFUSAL
def test_mempool_drain_fault(env, exc, stops):
    """A queued solution whose intake check raises in the mempool drain: a
    device fault stops the Validator; a refusal drops the solution, as the
    reference does."""
    async def go():
        v = _validator(env)
        checked = []

        def check(sol):
            checked.append(sol.id)
            raise exc

        v.ledger_service.check_solution_basic = check
        await v.start()
        try:
            sol = _stub_solution(v.ledger.latest_epoch_hash, _av(4).address, 1)
            await v.consensus.add_unconfirmed_solution(sol)
            assert await until(lambda: checked and not v.consensus.solutions_queue, 10)
            if stops:
                assert await until(v.halted.is_set, 10)
            else:
                await asyncio.sleep(0.05)
                assert not v.halted.is_set() and sol.id not in v.consensus.primary.worker.ready
        finally:
            await v.shut_down()
        return v

    v = run(go(), 20)
    assert (v.fault is exc) == stops and (v.consensus.fault is exc) == stops


@FAULT_OR_REFUSAL
def test_block_advance_fault(env, exc, stops):
    """A committed subdag whose block check raises at the advance: a device
    fault stops the Validator; a refusal puts the transmissions back in the
    workers, as the reference does."""
    async def go():
        v = _validator(env)

        def try_advance(subdag, transmissions):
            raise exc

        v.consensus._try_advance = try_advance
        reinserted = []
        v.consensus.primary.reinsert_transmissions = reinserted.append
        await v.start()
        try:
            await v.consensus._process_bft_subdag(None, {"tid": "transmission"})
            assert await until(v.halted.is_set, 10) if stops else not v.halted.is_set()
        finally:
            await v.shut_down()
        return v, reinserted

    v, reinserted = run(go(), 20)
    assert (v.fault is exc) == stops
    assert reinserted == ([] if stops else [{"tid": "transmission"}])


@FAULT_OR_REFUSAL
def test_proposal_recheck_fault(env, exc, stops):
    """A solution in the worker whose re-check at proposal time raises: a
    device fault stops the Validator and its proposer loop; a refusal
    leaves the solution out of the proposal, as the reference does."""
    async def go():
        v = _validator(env)
        primary = v.consensus.primary
        sol = _stub_solution(v.ledger.latest_epoch_hash, _av(4).address, 2)
        primary.worker.ready[sol.id] = types.Transmission.from_solution(sol)
        checked = []

        def check(s):
            checked.append(s.id)
            raise exc

        v.ledger_service.check_solution_basic = check
        await v.start()
        try:
            assert await until(lambda: checked, 10)
            if stops:
                assert await until(v.halted.is_set, 10)
                assert primary._tasks[0].done() and primary.proposed_batch is None
            else:
                assert await until(lambda: primary.proposed_batch is not None, 10)
                assert sol.id not in primary.proposed_batch.transmissions
                assert not v.halted.is_set()
        finally:
            await v.shut_down()
        return v, checked

    v, checked = run(go(), 20)
    assert (v.fault is exc) == stops and checked == [checked[0]]


def test_solution_verified_once_across_proposals(env, monkeypatch):
    """What stalled a four-validator devnet whose Prover kept proving: each
    validator re-checks every queued solution at each proposal, and each
    check verified the puzzle proof anew (a host pairing, ~1.2 s on the
    card's host). The ledger service keeps the verdict by the solution's
    bytes and the proof target: five proposals over three solutions verify
    each once; a solution that differs in its witness alone is verified
    anew, a refusal is kept too, and a stale epoch is refused without a
    verify."""
    calls = []

    class CountingPuzzle:
        def verify(self, epoch_hash, address, nonce, commitment, eval_y, witness, target):
            calls.append((nonce, witness))
            return nonce != 9

    monkeypatch.setattr(ledger, "global_puzzle", lambda device=None: CountingPuzzle())
    v = _validator(env)
    primary, epoch = v.consensus.primary, v.ledger.latest_epoch_hash
    sols = [_stub_solution(epoch, _av(4).address, i) for i in range(3)]
    for sol in sols:
        primary.worker.ready[sol.id] = types.Transmission.from_solution(sol)

    async def proposals(n):
        for _ in range(n):
            drained = await primary._drain_and_revalidate()
            assert set(drained) == {s.id for s in sols}
            primary.reinsert_transmissions(drained)

    run(proposals(5), 20)
    assert sorted(calls) == sorted((s.nonce, s.witness) for s in sols)
    svc = v.ledger_service
    other = types.Solution(epoch_hash=epoch, address=sols[0].address, nonce=0,
                           commitment=bytes(97), eval_y=0, witness=b"\x01" * 97)
    svc.check_solution_basic(other)
    bad = _stub_solution(epoch, _av(4).address, 9)
    for _ in range(2):
        with pytest.raises(ValueError, match="invalid puzzle solution"):
            svc.check_solution_basic(bad)
    with pytest.raises(ValueError, match="stale epoch"):
        svc.check_solution_basic(_stub_solution(b"\x05" * 32, _av(4).address, 4))
    assert len(calls) == 5


# --------------------------------------------- the roles against the JAX package
def test_prover_feeds_a_jax_validator(env, monkeypatch):
    """Across the packages: the port's Prover (its puzzle a stub) asks a JAX
    Validator for the epoch with a PuzzleRequest, proves against the
    PuzzleResponse's epoch hash and target, and the JAX Validator's handler
    takes its UnconfirmedSolution into consensus, where the worker's intake
    check gets the port's solution byte for byte."""
    from snarkos_tpu.crypto.ref import edwards as jedwards
    from snarkos_tpu.node import cli as jcli, codec as jcodec, ledger as jledger
    from snarkos_tpu.node import roles as jroles, types as jtypes

    monkeypatch.setattr(jedwards, "sign_bytes", standin_sign)
    monkeypatch.setattr(jedwards, "verify_bytes", standin_verify)
    jcomm = jtypes.Committee.from_reader(jcodec.Reader(bytes.fromhex(env.doc["committee"])))
    monkeypatch.setitem(jledger._GENESIS_CACHE, jcomm.id,
                        jtypes.Block.from_bytes(bytes.fromhex(env.doc["genesis"])))
    # the JAX router drops a peer that sends more than 5 in its window
    monkeypatch.setattr(roles, "PUZZLE_REQUEST_S", 0.5)
    jacct = jcli.dev_account(0)
    jaccount = pytypes.SimpleNamespace(sk=jacct.sk, pk=jacct.pk,
                                       address=jtypes.point_to_address(jacct.pk))
    jv = jroles.Validator(jaccount, jcomm, node_port=0, bft_port=0, rest_port=None,
                          translucent=True)
    taken = []
    jv.ledger_service.check_solution_basic = taken.append
    genesis = jv.ledger.blocks[0].hash
    assert genesis == env.blocks[0].previous_hash
    stub = _StubPuzzle([0])
    monkeypatch.setattr(puzzle, "_PUZZLE", stub)
    prover = roles.Prover(_av(4), genesis, log_degree=12, nonce_batch=1, max_iterations=1,
                          device="cpu")

    async def go():
        await jv.start()
        await prover.start()
        try:
            assert await prover.router.connect(jv.router.local_addr)
            assert await until(lambda: taken, 10), "the JAX Validator took no solution"
        finally:
            await prover.shut_down()
            await jv.shut_down()

    run(go(), 20)
    (_, epoch_hash, address, nonces, _), = stub.calls
    assert (epoch_hash, address) == (jv.ledger.latest_epoch_hash, prover.account.address)
    assert prover.latest_proof_target == jv.ledger.latest_proof_target
    want = types.Solution(epoch_hash=epoch_hash, address=address, nonce=nonces[0],
                          commitment=bytes(97), eval_y=0, witness=b"\x01" * 97)
    (sol,) = taken
    assert sol.to_bytes() == want.to_bytes() and prover.fault is None
