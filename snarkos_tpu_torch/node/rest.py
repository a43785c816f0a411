"""REST API (node/rest semantics, SURVEY.md §2.9).

A dependency-free asyncio HTTP/1.1 server exposing the reference's route
surface (node/rest/src/lib.rs:132-191): block reads (single/range <= 50),
transaction lookup, broadcast endpoints (solution/transaction), peer
lists, committee, latest chain state, memory-pool dumps, and a JWT-
guarded node-address route. Per-IP rate limiting and a body-size cap
mirror the reference's governor/limit layers.

The port of ``snarkos_tpu/node/rest.py``: the same routes, status codes and
JSON bodies. It holds no tensor: what a route reads or checks goes through
the node's ledger and its service, on the ledger's device.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import hmac
import json
import logging
import os
import time
from collections import defaultdict, deque
from urllib.parse import unquote

from snarkos_tpu_torch.node import messages as msg
from snarkos_tpu_torch.node.codec import Reader
from snarkos_tpu_torch.node.types import (
    Block, Solution, Transaction, TX_TRANSACTION, sha256d,
)

log = logging.getLogger(__name__)

MAX_BODY = 512 * 1024  # lib.rs:202
MAX_BLOCK_RANGE = 50
RATE_LIMIT_PER_S = 10  # requests per second per IP


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64d(data: str) -> bytes:
    pad = "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data + pad)


class JwtAuth:
    """HS256 JWT with a random per-process secret, 10-year expiry
    (helpers/auth.rs:36-80)."""

    def __init__(self, subject: str):
        self.secret = os.urandom(32)
        self.subject = subject

    def issue(self) -> str:
        header = _b64(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
        now = int(time.time())
        payload = _b64(json.dumps(
            {"sub": self.subject, "iat": now, "exp": now + 10 * 365 * 24 * 3600}
        ).encode())
        sig = hmac.new(self.secret, f"{header}.{payload}".encode(), hashlib.sha256).digest()
        return f"{header}.{payload}.{_b64(sig)}"

    def verify(self, token: str) -> bool:
        try:
            header, payload, sig = token.split(".")
            expect = hmac.new(self.secret, f"{header}.{payload}".encode(), hashlib.sha256).digest()
            if not hmac.compare_digest(_b64d(sig), expect):
                return False
            claims = json.loads(_b64d(payload))
            return claims.get("exp", 0) > time.time() and claims.get("sub") == self.subject
        except Exception:
            return False


def _block_json(block: Block) -> dict:
    return {
        "height": block.height,
        "hash": block.hash.hex(),
        "previous_hash": block.previous_hash.hex(),
        "timestamp": block.timestamp,
        "round": block.round,
        "epoch_hash": block.epoch_hash.hex(),
        "proof_target": block.proof_target,
        "num_transmissions": len(block.transmissions),
        "transmission_ids": [str(t.id) for t in block.transmissions],
        "transmissions": [
            {"kind": t.kind, "id": t.id.digest.hex(), "data": t.data.hex()}
            for t in block.transmissions
        ],
    }


class Rest:
    """Routes follow /{network}/... like the reference; network = 'testnet'."""

    def __init__(self, node, port: int = 3030, network: str = "testnet"):
        self.node = node
        self.port = port
        self.network = network
        self.auth = JwtAuth(subject=node.account.address)
        self.server = None
        self._rate: dict[str, deque] = defaultdict(deque)

    async def start(self):
        self.server = await asyncio.start_server(self._handle, "127.0.0.1", self.port)
        self.port = self.server.sockets[0].getsockname()[1]
        log.info("REST listening on 127.0.0.1:%d", self.port)

    async def stop(self):
        if self.server is not None:
            self.server.close()

    # -- http plumbing -------------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            request_line = await asyncio.wait_for(reader.readline(), 10)
            parts = request_line.decode("latin1").split()
            if len(parts) < 2:
                writer.close()
                return
            method, raw_path = parts[0], parts[1]
            headers = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode("latin1").partition(":")
                headers[k.strip().lower()] = v.strip()
            body = b""
            length = int(headers.get("content-length", 0))
            if length > MAX_BODY:
                await self._respond(writer, 413, {"error": "body too large"})
                return
            if length:
                body = await reader.readexactly(length)
            ip = writer.get_extra_info("peername")[0]
            if not self._rate_ok(ip):
                await self._respond(writer, 429, {"error": "rate limited"})
                return
            status, payload = await self._route(method, unquote(raw_path), headers, body)
            await self._respond(writer, status, payload)
        except (asyncio.IncompleteReadError, asyncio.TimeoutError, ConnectionError):
            pass
        except Exception as exc:
            log.debug("rest error: %s", exc)
            try:
                await self._respond(writer, 500, {"error": str(exc)})
            except Exception:
                pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    def _rate_ok(self, ip: str) -> bool:
        q = self._rate[ip]
        now = time.time()
        q.append(now)
        while q and q[0] < now - 1.0:
            q.popleft()
        return len(q) <= RATE_LIMIT_PER_S

    async def _respond(self, writer, status: int, payload):
        data = json.dumps(payload).encode()
        reason = {200: "OK", 400: "Bad Request", 401: "Unauthorized", 404: "Not Found",
                  413: "Payload Too Large", 429: "Too Many Requests",
                  500: "Internal Server Error"}.get(status, "OK")
        writer.write(
            f"HTTP/1.1 {status} {reason}\r\nContent-Type: application/json\r\n"
            f"Content-Length: {len(data)}\r\nConnection: close\r\n\r\n".encode() + data
        )
        await writer.drain()

    # -- routing (lib.rs:132-191 equivalents) --------------------------------
    async def _route(self, method: str, path: str, headers: dict, body: bytes):
        path, _, query_str = path.partition("?")
        path = path.rstrip("/")
        query = {}
        for kv in query_str.split("&"):
            k, _, v = kv.partition("=")
            if k:
                query[k] = v
        parts = [p for p in path.split("/") if p]
        if not parts or parts[0] != self.network:
            return 404, {"error": "unknown network prefix"}
        parts = parts[1:]
        ledger = getattr(self.node, "ledger", None)

        try:
            if method == "GET":
                return await self._route_get(parts, headers, ledger, query)
            if method == "POST":
                return await self._route_post(parts, body, ledger)
        except KeyError as exc:
            return 404, {"error": str(exc)}
        except ValueError as exc:
            return 400, {"error": str(exc)}
        return 404, {"error": "no such route"}

    @staticmethod
    def _block_by_spec(ledger, spec: str):
        """height-or-hash lookup (lib.rs get_block path param)."""
        if spec.isdigit():
            h = int(spec)
            return ledger.get_block(h) if h <= ledger.latest_height else None
        height = ledger.block_index.get(bytes.fromhex(spec))
        return None if height is None else ledger.get_block(height)

    async def _route_get(self, parts, headers, ledger, query=None):
        query = query or {}
        match parts:
            case ["block", "height", "latest"]:
                return 200, ledger.latest_height
            case ["block", "hash", "latest"]:
                return 200, ledger.latest_block.hash.hex()
            case ["block", "round", "latest"]:
                return 200, ledger.latest_round
            case ["block", "latest"]:
                return 200, _block_json(ledger.latest_block)
            case ["block", h, "history", mapping] if h.isdigit():
                # mapping content at a historical height (reference
                # routes.rs:453-464, "history" feature)
                hist = ledger.mapping_history(int(h), mapping)
                if hist is None:
                    return 404, {"error": "height outside the retained "
                                          "mapping-history window"}
                return 200, hist
            case ["block", spec, "transactions"]:
                block = self._block_by_spec(ledger, spec)
                if block is None:
                    return 404, {"error": "unknown block"}
                return 200, [{"id": t.id.digest.hex(), "kind": t.kind,
                              "data": t.data.hex()} for t in block.transmissions]
            case ["latest", "stateRoot"] | ["stateRoot", "latest"]:
                # genuine Merkle ledger root (state_tree.py), not the block
                # hash: commits block history + transmissions + mappings
                # (routes.rs:252-255)
                return 200, ledger.latest_state_root.hex()
            case ["block", spec]:
                if spec.isdigit():
                    return 200, _block_json(ledger.get_block(int(spec)))
                h = bytes.fromhex(spec)
                height = ledger.block_index.get(h)
                if height is None:
                    return 404, {"error": "unknown block hash"}
                return 200, _block_json(ledger.get_block(height))
            case ["blocks"] if "start" in query and "end" in query:
                s, e = int(query["start"]), int(query["end"])
                if e - s > MAX_BLOCK_RANGE:
                    return 400, {"error": f"range exceeds {MAX_BLOCK_RANGE} blocks"}
                return 200, [
                    _block_json(ledger.get_block(h))
                    for h in range(s, min(e, ledger.latest_height + 1))
                ]
            case ["blocks"]:
                return 400, {"error": "missing start/end query parameters"}
            case ["height", hash_hex]:
                height = ledger.block_index.get(bytes.fromhex(hash_hex))
                if height is None:
                    return 404, {"error": "unknown block hash"}
                return 200, height
            case ["blocks", start, end]:
                s, e = int(start), int(end)
                if e - s > MAX_BLOCK_RANGE:
                    return 400, {"error": f"range exceeds {MAX_BLOCK_RANGE} blocks"}
                return 200, [
                    _block_json(ledger.get_block(h))
                    for h in range(s, min(e, ledger.latest_height + 1))
                ]
            case ["transaction", tid_hex]:
                want = bytes.fromhex(tid_hex)
                for block in reversed(ledger.blocks):
                    for t in block.transmissions:
                        if t.id.digest == want:
                            return 200, {"block": block.height, "kind": t.kind,
                                         "data": t.data.hex()}
                return 404, {"error": "transaction not found"}
            case ["transaction", "confirmed", tid_hex]:
                want = bytes.fromhex(tid_hex)
                for block in reversed(ledger.blocks):
                    for idx, t in enumerate(block.transmissions):
                        if t.id.digest == want:
                            return 200, {"status": "confirmed", "block": block.height,
                                         "index": idx, "kind": t.kind,
                                         "data": t.data.hex()}
                return 404, {"error": "transaction not confirmed"}
            case ["committee", "latest"]:
                c = ledger.committee
                return 200, {
                    "starting_round": c.starting_round,
                    "members": {a: {"stake": s, "is_open": o} for a, s, o in c.members},
                }
            case ["committee", height] if height.isdigit():
                # the committee in effect at that block's round (dynamic:
                # derived from on-chain bonding, ledger.committee_history)
                if int(height) > ledger.latest_height:
                    return 404, {"error": "height beyond the chain tip"}
                c = ledger.committee_for_round(ledger.get_block(int(height)).round)
                return 200, {
                    "starting_round": c.starting_round,
                    "members": {a: {"stake": s, "is_open": o} for a, s, o in c.members},
                }
            case ["peers", "count"]:
                return 200, self.node.router.number_of_connected_peers()
            case ["peers", "all"]:
                return 200, [list(p.listening_addr) for p in self.node.router.peers.values()]
            case ["peers", "all", "metrics"]:
                return 200, [
                    {"addr": list(a), "type": int(p.node_type), "address": p.address}
                    for a, p in self.node.router.peers.items()
                ]
            case ["node", "address"]:
                token = headers.get("authorization", "").removeprefix("Bearer ").strip()
                if not self.auth.verify(token):
                    return 401, {"error": "unauthorized"}
                return 200, self.node.account.address
            case ["node", "env"]:
                return 200, {"network": self.network, "version": msg.VERSION}
            case ["latest", "epochHash"] | ["epoch", "latest"]:
                return 200, ledger.latest_epoch_hash.hex()
            case ["proofTarget", "latest"]:
                return 200, ledger.latest_proof_target
            case ["memoryPool", "transmissions"]:
                c = getattr(self.node, "consensus", None)
                if c is None:
                    return 404, {"error": "not a validator"}
                return 200, [str(tid) for w in c.primary.workers for tid in w.ready]
            case ["memoryPool", "solutions"]:
                c = getattr(self.node, "consensus", None)
                if c is None:
                    return 404, {"error": "not a validator"}
                return 200, [str(k) for k in c.solutions_queue]
            case ["memoryPool", "transactions"]:
                c = getattr(self.node, "consensus", None)
                if c is None:
                    return 404, {"error": "not a validator"}
                return 200, [str(k) for k in
                             list(c.executions_queue) + list(c.deployments_queue)]
            case ["sync", "status"]:
                bs = getattr(self.node, "block_sync", None)
                if bs is None:
                    return 404, {"error": "no sync engine"}
                return 200, {"is_synced": bs.is_block_synced(),
                             "blocks_behind": bs.num_blocks_behind()}
            # find/* index lookups (lib.rs:132-191 find routes)
            case ["find", "blockHash", tid_hex]:
                want = bytes.fromhex(tid_hex)
                for block in reversed(ledger.blocks):
                    if any(t.id.digest == want for t in block.transmissions):
                        return 200, block.hash.hex()
                return 404, {"error": "transaction not found"}
            case ["find", "blockHeight", spec_hex]:
                # reference semantics: lookup by STATE ROOT
                # (routes.rs:331-338); block-hash lookup kept as a
                # convenience fallback
                want = bytes.fromhex(spec_hex)
                height = ledger.find_block_height_by_state_root(want)
                if height is None:
                    height = ledger.block_index.get(want)
                if height is None:
                    return 404, {"error": "unknown state root"}
                return 200, height
            case ["find", "transactionID", "deployment", program_id]:
                # deployment payloads declare "program <id>" (cli deploy)
                prefix = f"program {program_id}".encode()
                for block in reversed(ledger.blocks):
                    for t in block.transmissions:
                        if t.kind == TX_TRANSACTION:
                            tx = t.deserialize()
                            if tx.is_deploy and tx.payload.startswith(prefix):
                                return 200, t.id.digest.hex()
                return 404, {"error": "deployment not found"}
            case ["find", "transactionID", transition_hex]:
                # a transition in this framework is the payload execution
                # unit: its id is sha256d of the payload
                want = bytes.fromhex(transition_hex)
                for block in reversed(ledger.blocks):
                    for t in block.transmissions:
                        if t.kind == TX_TRANSACTION and \
                                sha256d(t.deserialize().payload) == want:
                            return 200, t.id.digest.hex()
                return 404, {"error": "transition not found"}
            case ["find", "transitionID", tid_hex]:
                # inverse map: transmission id -> its payload execution id
                want = bytes.fromhex(tid_hex)
                for block in reversed(ledger.blocks):
                    for t in block.transmissions:
                        if t.kind == TX_TRANSACTION and t.id.digest == want:
                            return 200, sha256d(t.deserialize().payload).hex()
                return 404, {"error": "transaction not found"}
            case ["stateRoot", spec] if spec.isdigit():
                root = ledger.state_root_at(int(spec))
                if root is None:
                    return 404, {"error": "unknown height"}
                return 200, root.hex()
            case ["statePath", "mapping", program_id, mapping, key, *rest] \
                    if all(s.isdigit() for s in rest) and len(rest) <= 1:
                h = int(rest[0]) if rest else None
                proof = ledger.state_path_for_mapping(program_id, mapping,
                                                      key, h)
                if proof is None:
                    return 404, {"error": "mapping entry not found at height"}
                return 200, proof
            case ["statePath", tid_hex, *rest] \
                    if all(s.isdigit() for s in rest) and len(rest) <= 1:
                # Merkle inclusion proof under the state root at the
                # trailing height (default: latest state root) —
                # light clients verify against any root they trust
                # (state_tree.verify_transmission_path checks it;
                # routes.rs:256-269 statePath semantics)
                h = int(rest[0]) if rest else None
                proof = ledger.state_path_for_transmission(
                    bytes.fromhex(tid_hex), h)
                if proof is None:
                    return 404, {"error": "transaction not found at height"}
                return 200, proof
            # program/mapping reads (lib.rs:132-191 program routes). The
            # full-mapping dump is JWT-guarded like the reference's bulk
            # mapping reads (helpers/auth.rs).
            case ["program", program_id]:
                prog = ledger.get_program(program_id)
                if prog is None:
                    return 404, {"error": "unknown program"}
                return 200, {"id": program_id, "source": prog}
            case ["program", program_id, "mappings"]:
                return 200, ledger.program_mappings(program_id)
            case ["program", program_id, "mapping", name]:
                token = headers.get("authorization", "").removeprefix("Bearer ").strip()
                if not self.auth.verify(token):
                    return 401, {"error": "unauthorized (bulk mapping read)"}
                return 200, ledger.get_mapping(program_id, name)
            case ["program", program_id, "mapping", name, key]:
                val = ledger.get_mapping_value(program_id, name, key)
                if val is None:
                    return 404, {"error": "no such mapping entry"}
                return 200, val
            case ["records", height_s]:
                # sealed record ciphertexts produced at a height (the
                # capability analogue of the reference's record scanning
                # over blocks; cli developer scan consumes this)
                try:
                    h = int(height_s)
                except ValueError:
                    return 400, {"error": "bad height"}
                blobs = getattr(ledger, "record_ciphertexts", {}).get(h, [])
                return 200, [b.hex() for b in blobs]
            case ["delegators", address]:
                c = ledger.committee
                for a, stake, is_open in c.members:
                    if a == address:
                        return 200, {"address": a, "stake": stake, "is_open": is_open,
                                     "delegators": []}
                return 404, {"error": "not a committee member"}
        raise KeyError("no such route")

    async def _route_post(self, parts, body, ledger):
        match parts:
            case ["transaction", "broadcast"]:
                tx = Transaction.from_reader(Reader(bytes.fromhex(json.loads(body))))
                consensus = getattr(self.node, "consensus", None)
                if consensus is not None:
                    await consensus.add_unconfirmed_transaction(tx)
                else:
                    self.node.ledger_service.check_transaction_basic(tx)
                self.node.router.propagate(
                    msg.UnconfirmedTransaction(tx.id, tx.to_bytes()), exclude=set()
                )
                return 200, tx.id.digest.hex()
            case ["solution", "broadcast"]:
                sol = Solution.from_reader(Reader(bytes.fromhex(json.loads(body))))
                consensus = getattr(self.node, "consensus", None)
                if consensus is not None:
                    await consensus.add_unconfirmed_solution(sol)
                else:
                    self.node.ledger_service.check_solution_basic(sol)
                self.node.router.propagate(
                    msg.UnconfirmedSolution(sol.id, sol.to_bytes()), exclude=set()
                )
                return 200, sol.id.digest.hex()
        raise KeyError("no such route")
