"""The node's REST API (snarkos_tpu_torch/node/rest.py) on the CPU: case for
case the JAX package's tests/test_rest_parity.py (every reference route
answers; the shapes of the round-2 routes; sealed records by height) and
the REST and program parts of tests/test_aux.py (the routes over a
genesis-only chain with JWT auth and the range cap; the program store and
its routes). Then the port against the JAX package: over the same chain,
the fixture's genesis and its golden blocks 1-2 advanced without the check
on both sides, every route of the inventory gets the same status and the
same JSON from the JAX ``Rest`` and the port's. Last, the one rule that
differs: a device fault in a broadcast's check stops the node.

The chains are tests/fixtures/torch_ledger_dev4.json's
(``torch_node_support.dev4_env``). Where the JAX tests create transactions
to fill a block, these take the fixture's own or build unproved ones: the
ledger advances a block without checking it, and a route reads only what
the block holds."""

import asyncio
import json

import pytest

from snarkos_tpu.node import codec as jcodec, ledger as jledger, rest as jrest
from snarkos_tpu.node import types as jtypes
from snarkos_tpu_torch.crypto.ref import records
from snarkos_tpu_torch.node import ledger, rest as rest_mod, roles, types
from snarkos_tpu_torch.node.cli import AccountView
from snarkos_tpu_torch.node.rest import Rest

import torch_node_support as sup
from torch_net_support import account, run

# the reference route table (lib.rs:132-191), mapped to this framework
REFERENCE_ROUTES = [
    ("GET", "/{n}/node/address", "auth"),
    ("GET", "/{n}/program/{program_id}/mapping/{name}", "auth"),
    ("GET", "/{n}/block/height/latest", None),
    ("GET", "/{n}/block/hash/latest", None),
    ("GET", "/{n}/block/latest", None),
    ("GET", "/{n}/block/{height_or_hash}", None),
    ("GET", "/{n}/block/{height_or_hash}/transactions", None),
    ("GET", "/{n}/transaction/{id}", None),
    ("GET", "/{n}/transaction/confirmed/{id}", None),
    ("POST", "/{n}/transaction/broadcast", None),
    ("POST", "/{n}/solution/broadcast", None),
    ("GET", "/{n}/find/blockHash/{tx_id}", None),
    ("GET", "/{n}/find/blockHeight/{state_root}", None),
    ("GET", "/{n}/find/transactionID/deployment/{program_id}", None),
    ("GET", "/{n}/find/transactionID/{transition_id}", None),
    ("GET", "/{n}/find/transitionID/{io_id}", None),
    ("GET", "/{n}/peers/count", None),
    ("GET", "/{n}/peers/all", None),
    ("GET", "/{n}/peers/all/metrics", None),
    ("GET", "/{n}/program/{program_id}", "may404"),
    ("GET", "/{n}/program/{program_id}/mappings", None),
    ("GET", "/{n}/program/{program_id}/mapping/{name}/{key}", "may404"),
    ("GET", "/{n}/blocks", "query"),
    ("GET", "/{n}/height/{hash}", None),
    ("GET", "/{n}/memoryPool/transmissions", "validator"),
    ("GET", "/{n}/memoryPool/solutions", "validator"),
    ("GET", "/{n}/memoryPool/transactions", "validator"),
    ("GET", "/{n}/statePath/{commitment}", None),
    ("GET", "/{n}/stateRoot/latest", None),
    ("GET", "/{n}/stateRoot/{height}", None),
    ("GET", "/{n}/committee/latest", None),
    ("GET", "/{n}/committee/{height}", None),
    ("GET", "/{n}/delegators/{validator}", None),
]


async def _http(port, method, path, body=None, headers=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode() if body is not None else b""
    hdrs = {"Content-Length": str(len(payload)), **(headers or {})}
    head = "".join(f"{k}: {v}\r\n" for k, v in hdrs.items())
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: x\r\n{head}\r\n".encode() + payload)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    while (await reader.readline()).strip():
        pass
    data = await reader.read()
    writer.close()
    return status, json.loads(data) if data else None


class FakeRouter:
    peers = {}

    def number_of_connected_peers(self):
        return 0

    def propagate(self, m, exclude=None):
        return 0


class FakeNode:
    """What Rest reads of a node that is not a validator."""

    def __init__(self, led, service):
        self.account = AccountView(account(0))
        self.router = FakeRouter()
        self.consensus = None
        self.ledger = led
        self.ledger_service = service


@pytest.fixture(scope="module")
def env():
    mp = pytest.MonkeyPatch()
    doc, comm, blocks = sup.dev4_env(mp)
    mp.setattr(rest_mod, "RATE_LIMIT_PER_S", 10_000)
    yield doc, comm, blocks
    mp.undo()


@pytest.fixture(scope="module")
def chain(env):
    """The fixture's chain, genesis and blocks 1-2, on the port's ledger."""
    _doc, comm, blocks = env
    led = ledger.Ledger(comm, device="cpu")
    for blk in blocks:
        led.advance_to_next_block(blk)
    return led


async def _serve(node):
    rest = Rest(node, port=0)
    await rest.start()
    return rest


def _transfer(blocks):
    """Block 1's transfer_public: its transmission and index."""
    return next((i, t) for i, t in enumerate(blocks[0].transmissions)
                if t.kind == types.TX_TRANSACTION)


def _values(led, blocks, node):
    _, t = _transfer(blocks)
    tid = t.id.digest.hex()
    bhash = led.get_block(1).hash.hex()
    transition = types.sha256d(t.deserialize().payload).hex()
    return {"{n}": "testnet", "{id}": tid, "{height_or_hash}": "1",
            "{tx_id}": tid, "{state_root}": bhash, "{program_id}": "credits.aleo",
            "{transition_id}": transition, "{io_id}": tid, "{hash}": bhash,
            "{commitment}": tid, "{height}": "1", "{validator}": node.account.address,
            "{name}": "account", "{key}": "k"}


def _path(template, kind, vals):
    for k, v in vals.items():
        template = template.replace(k, v)
    return template + ("?start=0&end=2" if kind == "query" else "")


async def _inventory(port, token, vals):
    """(method, path, status, JSON) of every reference route."""
    out = []
    for method, template, kind in REFERENCE_ROUTES:
        path = _path(template, kind, vals)
        headers = {"Authorization": f"Bearer {token}"} if kind == "auth" else {}
        body = "zz" if method == "POST" else None
        out.append((method, path, kind, *await _http(port, method, path, body, headers)))
    return out


# ------------------------------------------------ tests/test_rest_parity.py
def test_route_inventory(env, chain):
    """Every reference route answers; none 404s with 'no such route'."""
    _doc, comm, blocks = env
    node = FakeNode(chain, ledger.MockLedgerService(comm, device="cpu"))

    async def go():
        rest = await _serve(node)
        try:
            return await _inventory(rest.port, rest.auth.issue(), _values(chain, blocks, node))
        finally:
            await rest.stop()

    for method, path, kind, status, out in run(go(), 20):
        if method == "POST":
            # a malformed body gives 400/500, not an unknown-route 404
            assert status in (400, 500), (path, status, out)
            continue
        assert status != 404 or (isinstance(out, dict) and out.get("error") != "no such route"), \
            f"route missing: {method} {path} -> {status} {out}"
        if kind is None and "find" not in path and "delegators" not in path:
            assert status == 200, (path, status, out)


def test_new_route_shapes(env, chain):
    """Spot-checks of the round-2 routes' shapes."""
    _doc, comm, blocks = env
    node = FakeNode(chain, ledger.MockLedgerService(comm, device="cpu"))
    idx, t = _transfer(blocks)
    tid = t.id.digest.hex()
    transition = types.sha256d(t.deserialize().payload).hex()

    async def go():
        rest = await _serve(node)
        port = rest.port
        try:
            status, out = await _http(port, "GET", "/testnet/block/latest")
            assert status == 200 and out["height"] == 2
            status, out = await _http(port, "GET", "/testnet/block/1/transactions")
            assert status == 200 and out[idx]["id"] == tid
            status, out = await _http(port, "GET", f"/testnet/transaction/confirmed/{tid}")
            assert status == 200 and out["status"] == "confirmed" and out["index"] == idx
            status, out = await _http(port, "GET", "/testnet/blocks?start=0&end=2")
            assert status == 200 and [b["height"] for b in out] == [0, 1]
            bhash = chain.get_block(1).hash.hex()
            assert await _http(port, "GET", f"/testnet/height/{bhash}") == (200, 1)
            status, out = await _http(port, "GET", "/testnet/committee/1")
            assert status == 200 and len(out["members"]) == 4
            status, out = await _http(port, "GET", "/testnet/committee/99")
            assert status == 404
            assert await _http(port, "GET", f"/testnet/find/transactionID/{transition}") == \
                (200, tid)
            assert await _http(port, "GET", f"/testnet/find/transitionID/{tid}") == \
                (200, transition)
        finally:
            await rest.stop()

    run(go(), 20)


def test_records_route(env, chain):
    """GET /{n}/records/{height}: the sealed record ciphertexts of a height,
    which only their owner decrypts (block 2's transfer_public_to_private
    seals 10 credits to dev account 3)."""
    _doc, comm, _blocks = env
    node = FakeNode(chain, ledger.MockLedgerService(comm, device="cpu"))

    async def go():
        rest = await _serve(node)
        try:
            return (await _http(rest.port, "GET", "/testnet/records/2"),
                    await _http(rest.port, "GET", "/testnet/records/99"))
        finally:
            await rest.stop()

    (status, out), empty = run(go(), 20)
    assert status == 200 and len(out) == 1
    blob = bytes.fromhex(out[0])
    plain = records.decrypt(account(3).sk, blob[len(b"record1"):])
    assert b"10u64" in plain
    with pytest.raises(ValueError):
        records.decrypt(account(2).sk, blob[len(b"record1"):])
    assert empty == (200, [])


# ---------------------------------------------------------- tests/test_aux.py
def test_rest_routes(env):
    """The routes over a genesis-only chain: heights, blocks, the committee,
    peers, the JWT-guarded node address, malformed input, an unknown network
    prefix and the block-range cap."""
    _doc, comm, _blocks = env
    node = FakeNode(ledger.Ledger(comm, device="cpu"),
                    ledger.MockLedgerService(comm, device="cpu"))

    async def go():
        rest = await _serve(node)
        port = rest.port
        try:
            assert await _http(port, "GET", "/testnet/block/height/latest") == (200, 0)
            status, out = await _http(port, "GET", "/testnet/block/0")
            assert status == 200 and out["height"] == 0
            status, out = await _http(port, "GET", "/testnet/committee/latest")
            assert status == 200 and len(out["members"]) == 4
            assert await _http(port, "GET", "/testnet/peers/count") == (200, 0)
            status, _ = await _http(port, "GET", "/testnet/node/address")
            assert status == 401
            status, out = await _http(port, "GET", "/testnet/node/address",
                                      headers={"Authorization": f"Bearer {rest.auth.issue()}"})
            assert status == 200 and out == node.account.address
            status, _ = await _http(port, "GET", "/testnet/block/zzz")
            assert status in (400, 500)
            status, _ = await _http(port, "GET", "/wrongnet/block/0")
            assert status == 404
            status, _ = await _http(port, "GET", "/testnet/blocks/0/100")
            assert status == 400
        finally:
            await rest.stop()

    run(go(), 20)


def _unproved(payload: bytes, is_deploy=False) -> types.Transaction:
    return types.Transaction(payload=payload, fee=0, auth_tag=0, proof=b"", is_deploy=is_deploy)


def _program_chain(comm, payloads):
    led = ledger.Ledger(comm, device="cpu")
    prev = led.latest_block
    led.advance_to_next_block(types.Block(
        height=1, previous_hash=prev.hash, timestamp=prev.timestamp + 1, round=2,
        epoch_hash=prev.epoch_hash, proof_target=prev.proof_target, subdag=None,
        transmissions=tuple(types.Transmission.from_transaction(_unproved(p, d))
                            for p, d in payloads)))
    return led


def test_program_store_and_rest_routes(env):
    """Deploy transactions register programs; calls update mappings."""
    led = _program_chain(env[1], [(b"program token\nmapping balances;", True),
                                  (b"call token/balances alice=42", False)])
    assert led.get_program("token") == "mapping balances;"
    assert led.program_mappings("token") == ["balances"]
    assert led.get_mapping_value("token", "balances", "alice") == "42"
    assert led.get_mapping("token", "balances") == {"alice": "42"}
    assert led.get_program("nope") is None


def test_program_rest_endpoints(env):
    """The program routes: the source, a mapping entry, the JWT-guarded
    full mapping, an unknown program."""
    comm = env[1]
    node = FakeNode(_program_chain(comm, [(b"program token\nsrc", True),
                                          (b"call token/balances bob=7", False)]),
                    ledger.MockLedgerService(comm, device="cpu"))

    async def go():
        rest = await _serve(node)
        port = rest.port
        try:
            status, body = await _http(port, "GET", "/testnet/program/token")
            assert status == 200 and body["source"] == "src"
            assert await _http(port, "GET", "/testnet/program/token/mapping/balances/bob") == \
                (200, "7")
            status, _ = await _http(port, "GET", "/testnet/program/token/mapping/balances")
            assert status == 401
            assert await _http(
                port, "GET", "/testnet/program/token/mapping/balances",
                headers={"Authorization": f"Bearer {rest.auth.issue()}"}) == (200, {"bob": "7"})
            status, _ = await _http(port, "GET", "/testnet/program/zzz")
            assert status == 404
        finally:
            await rest.stop()

    run(go(), 20)


# ------------------------------------------------------- against the JAX package
@pytest.fixture(scope="module")
def jax_chain(env):
    """The same chain on the JAX package's ledger: the fixture's genesis in
    its cache, and placeholders for its execution SRSs (advancing a block
    asks only whether a function has a circuit)."""
    doc, _comm, _blocks = env
    mp = pytest.MonkeyPatch()
    jcomm = jtypes.Committee.from_reader(jcodec.Reader(bytes.fromhex(doc["committee"])))
    mp.setitem(jledger._GENESIS_CACHE, jcomm.id,
               jtypes.Block.from_bytes(bytes.fromhex(doc["genesis"])))
    for need in (16384, 32768):
        mp.setitem(jledger._EXEC_SRS_CACHE, need, object())
    mp.setattr(jrest, "RATE_LIMIT_PER_S", 10_000)
    led = jledger.Ledger(jcomm)
    for b in doc["blocks"]:
        led.advance_to_next_block(jtypes.Block.from_bytes(bytes.fromhex(b)))
    yield led, jcomm
    mp.undo()


def test_routes_match_the_jax_rest(env, chain, jax_chain):
    """Every route of the inventory, and the records and sync-free routes
    around it, gets the same status and JSON from both packages' Rest over
    the same chain; both chains end at the fixture's state root."""
    doc, comm, blocks = env
    jled, jcomm = jax_chain
    assert chain.latest_state_root.hex() == jled.latest_state_root.hex() == doc["state_roots"][2]
    port_node = FakeNode(chain, ledger.MockLedgerService(comm, device="cpu"))
    jax_node = FakeNode(jled, jledger.MockLedgerService(jcomm))
    vals = _values(chain, blocks, port_node)
    extra = ["/testnet/records/2", "/testnet/records/x", "/testnet/blocks/0/3",
             "/testnet/stateRoot/0", "/testnet/find/blockHeight/" + doc["state_roots"][1],
             "/testnet/program/tally.aleo", "/testnet/program/tally.aleo/mappings",
             "/testnet/program/tally.aleo/mapping/tally/7u64", "/testnet/block/2",
             "/testnet/block/" + chain.get_block(2).hash.hex(), "/testnet/latest/epochHash",
             "/testnet/proofTarget/latest", "/testnet/node/env", "/testnet/sync/status",
             "/testnet/block/1/history/account", "/testnet/nothing/here"]

    async def answers(node, rest_cls):
        rest = rest_cls(node, port=0)
        await rest.start()
        try:
            got = await _inventory(rest.port, rest.auth.issue(), vals)
            for path in extra:
                got.append(("GET", path, None, *await _http(rest.port, "GET", path)))
            return got
        finally:
            await rest.stop()

    port_answers = run(answers(port_node, Rest), 30)
    jax_answers = run(answers(jax_node, jrest.Rest), 30)
    assert len(port_answers) == len(REFERENCE_ROUTES) + len(extra)
    for mine, theirs in zip(port_answers, jax_answers):
        assert mine == theirs, (mine[:2], mine[3:], theirs[3:])


class _RaisingService:
    """A service whose broadcast checks raise ``exc``."""

    def __init__(self, exc):
        self.exc = exc

    def check_transaction_basic(self, tx):
        raise self.exc

    def check_solution_basic(self, sol):
        raise self.exc


class FaultNode(roles._BaseNode):
    """What Rest reads of a node that is not a validator, with the roles'
    fault rule (``_BaseNode._halt_on_fault``); its stops are counted."""

    def __init__(self, led, exc):
        self._init_node("cpu")
        self.account = AccountView(account(0))
        self.router = FakeRouter()
        self.consensus = None
        self.ledger = led
        self.ledger_service = _RaisingService(exc)
        self.stops = 0

    async def _shut_down(self):
        self.stops += 1


@pytest.mark.parametrize("kind", [types.TX_TRANSACTION, types.TX_SOLUTION],
                         ids=["transaction", "solution"])
@pytest.mark.parametrize("exc, status, halts", [
    (RuntimeError("CUDA error 700"), 500, True),
    (ValueError("invalid proof"), 400, False),
    (ledger.SRSTooSmall("SRS artifact too small"), 500, False),
], ids=["RuntimeError", "ValueError", "SRSTooSmall"])
def test_broadcast_check_fault_stops_the_node(env, chain, kind, exc, status, halts):
    """A device fault in a broadcast's check (a Client's or a Prover's
    ``check_transaction_basic`` / ``check_solution_basic``) still answers
    500, and stops the node as the roles' other catch-alls do; a
    ``ValueError`` keeps the reference's 400 and ``SRSTooSmall`` its 500,
    and neither stops the node."""
    _doc, _comm, blocks = env
    item = next(t for t in blocks[0].transmissions if t.kind == kind).deserialize()
    route = "transaction" if kind == types.TX_TRANSACTION else "solution"
    node = FaultNode(chain, exc)

    async def go():
        rest = await _serve(node)
        try:
            got, body = await _http(rest.port, "POST", f"/testnet/{route}/broadcast",
                                    item.to_bytes().hex())
            if halts:
                await asyncio.wait_for(node.halted.wait(), 5)
            return got, body
        finally:
            await rest.stop()

    got, body = run(go(), 20)
    assert (got, body) == (status, {"error": str(exc)})
    assert (node.fault is exc, node.halted.is_set(), node.stops) == (halts, halts, int(halts))
