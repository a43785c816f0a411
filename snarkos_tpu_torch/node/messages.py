"""Router-plane wire protocol: the 13 message variants.

Mirrors the reference's `node/router/messages` capability surface
(SURVEY.md §2.2; messages/src/lib.rs:88-154): BlockRequest, BlockResponse,
ChallengeRequest, ChallengeResponse, Disconnect, PeerRequest, PeerResponse,
Ping, Pong, PuzzleRequest, PuzzleResponse, UnconfirmedSolution,
UnconfirmedTransaction. Protocol VERSION gates connections; BlockResponse
carries at most DATA_BLOCKS_MAX blocks; transaction payloads are size-
gated before deserialization.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

from snarkos_tpu_torch.node.codec import Reader, Writer
from snarkos_tpu_torch.node.types import (
    Block,
    Solution,
    Transaction,
    TransmissionID,
    _r_addr,
    _r_sig,
    _w_addr,
    _w_sig,
)

VERSION = 1
DATA_BLOCKS_MAX = 5  # node/bft/events/src/block_response.rs:68 equivalent
MAX_TRANSACTION_SIZE = 128 * 1024


class MessageType(IntEnum):
    BLOCK_REQUEST = 0
    BLOCK_RESPONSE = 1
    CHALLENGE_REQUEST = 2
    CHALLENGE_RESPONSE = 3
    DISCONNECT = 4
    PEER_REQUEST = 5
    PEER_RESPONSE = 6
    PING = 7
    PONG = 8
    PUZZLE_REQUEST = 9
    PUZZLE_RESPONSE = 10
    UNCONFIRMED_SOLUTION = 11
    UNCONFIRMED_TRANSACTION = 12


class NodeType(IntEnum):
    CLIENT = 0
    PROVER = 1
    VALIDATOR = 2


class DisconnectReason(IntEnum):
    PROTOCOL_VIOLATION = 0
    NO_REASON = 1
    OUTDATED_VERSION = 2
    SHUTTING_DOWN = 3
    YOUR_FAULT = 4


@dataclass(frozen=True)
class BlockRequest:
    start_height: int
    end_height: int  # exclusive

    def write(self, w: Writer):
        w.u32(self.start_height).u32(self.end_height)

    @classmethod
    def read(cls, r: Reader):
        return cls(r.u32(), r.u32())


@dataclass(frozen=True)
class BlockResponse:
    request: BlockRequest
    blocks: tuple  # tuple[Block], <= DATA_BLOCKS_MAX

    def write(self, w: Writer):
        self.request.write(w)
        w.u32(len(self.blocks))
        for b in self.blocks:
            w.bytes_var(b.to_bytes())

    @classmethod
    def read(cls, r: Reader):
        req = BlockRequest.read(r)
        n = r.u32()
        if n > DATA_BLOCKS_MAX:
            raise ValueError(f"block response carries {n} > {DATA_BLOCKS_MAX} blocks")
        return cls(req, tuple(Block.from_bytes(r.bytes_var()) for _ in range(n)))

    def ensure_well_formed(self) -> None:
        """DataBlocks::ensure_response_is_well_formed
        (events/src/block_response.rs:69-91): non-empty, sequentially
        ordered, and exactly matching the request range."""
        if not self.blocks:
            raise ValueError("empty block response")
        heights = [b.height for b in self.blocks]
        if any(b + 1 != a for b, a in zip(heights, heights[1:])):
            raise ValueError("block response not sequentially ordered")
        if heights[0] != self.request.start_height or \
                heights[-1] + 1 != self.request.end_height:
            raise ValueError("block response range does not match the request")


@dataclass(frozen=True)
class ChallengeRequest:
    version: int
    listener_port: int
    node_type: int
    address: str
    nonce: int

    def write(self, w: Writer):
        w.u32(self.version).u16(self.listener_port).u8(self.node_type)
        _w_addr(w, self.address)
        w.u64(self.nonce)

    @classmethod
    def read(cls, r: Reader):
        return cls(r.u32(), r.u16(), r.u8(), _r_addr(r), r.u64())


@dataclass(frozen=True)
class ChallengeResponse:
    genesis_hash: bytes  # 32
    restrictions_id: bytes  # 32
    signature: tuple  # over nonce || response_nonce
    nonce: int  # response nonce

    def write(self, w: Writer):
        w.raw(self.genesis_hash).raw(self.restrictions_id)
        _w_sig(w, self.signature)
        w.u64(self.nonce)

    @classmethod
    def read(cls, r: Reader):
        return cls(r.take(32), r.take(32), _r_sig(r), r.u64())


@dataclass(frozen=True)
class Disconnect:
    reason: int = DisconnectReason.NO_REASON

    def write(self, w: Writer):
        w.u8(self.reason)

    @classmethod
    def read(cls, r: Reader):
        return cls(r.u8())


@dataclass(frozen=True)
class PeerRequest:
    def write(self, w: Writer):
        pass

    @classmethod
    def read(cls, r: Reader):
        return cls()


@dataclass(frozen=True)
class PeerResponse:
    peers: tuple  # tuple[(ip, port)], <= 1000

    def write(self, w: Writer):
        w.u32(len(self.peers))
        for ip, port in self.peers:
            w.string(ip)
            w.u16(port)

    @classmethod
    def read(cls, r: Reader):
        n = r.u32()
        if n > 1000:
            raise ValueError("too many peers in response")
        return cls(tuple((r.string(), r.u16()) for _ in range(n)))


@dataclass(frozen=True)
class BlockLocators:
    """100 recents + every-10_000th checkpoints
    (node/sync/locators/src/block_locators.rs:24-28)."""

    recents: tuple  # ((height, hash32), ...)
    checkpoints: tuple  # ((height, hash32), ...)

    NUM_RECENTS = 100
    CHECKPOINT_INTERVAL = 10_000

    def write(self, w: Writer):
        w.u32(len(self.recents))
        for h, hsh in self.recents:
            w.u32(h)
            w.raw(hsh)
        w.u32(len(self.checkpoints))
        for h, hsh in self.checkpoints:
            w.u32(h)
            w.raw(hsh)

    @classmethod
    def read(cls, r: Reader):
        recents = tuple((r.u32(), r.take(32)) for _ in range(r.u32()))
        checkpoints = tuple((r.u32(), r.take(32)) for _ in range(r.u32()))
        return cls(recents, checkpoints)

    @property
    def latest_height(self) -> int:
        return self.recents[-1][0] if self.recents else 0

    def is_well_formed(self) -> bool:
        if not self.recents:
            return False
        heights = [h for h, _ in self.recents]
        if heights != sorted(set(heights)) or len(heights) > self.NUM_RECENTS:
            return False
        if heights[-1] - heights[0] > self.NUM_RECENTS:
            return False
        for h, _ in self.checkpoints:
            if h % self.CHECKPOINT_INTERVAL != 0:
                return False
        cp_heights = [h for h, _ in self.checkpoints]
        return cp_heights == sorted(set(cp_heights))

    def is_consistent_with(self, other: "BlockLocators") -> bool:
        """Shared heights must map to identical hashes."""
        mine = dict(self.recents) | dict(self.checkpoints)
        theirs = dict(other.recents) | dict(other.checkpoints)
        for h, hsh in mine.items():
            if h in theirs and theirs[h] != hsh:
                return False
        return True


@dataclass(frozen=True)
class Ping:
    version: int
    node_type: int
    locators: BlockLocators | None

    def write(self, w: Writer):
        w.u32(self.version).u8(self.node_type).bool_(self.locators is not None)
        if self.locators is not None:
            self.locators.write(w)

    @classmethod
    def read(cls, r: Reader):
        version, node_type = r.u32(), r.u8()
        locators = BlockLocators.read(r) if r.bool_() else None
        return cls(version, node_type, locators)


@dataclass(frozen=True)
class Pong:
    is_fork: bool | None = None

    def write(self, w: Writer):
        w.u8(0 if self.is_fork is None else (1 if self.is_fork else 2))

    @classmethod
    def read(cls, r: Reader):
        v = r.u8()
        return cls(None if v == 0 else v == 1)


@dataclass(frozen=True)
class PuzzleRequest:
    def write(self, w: Writer):
        pass

    @classmethod
    def read(cls, r: Reader):
        return cls()


@dataclass(frozen=True)
class PuzzleResponse:
    epoch_hash: bytes  # 32
    block_height: int
    proof_target: int

    def write(self, w: Writer):
        w.raw(self.epoch_hash).u32(self.block_height).u64(self.proof_target)

    @classmethod
    def read(cls, r: Reader):
        return cls(r.take(32), r.u32(), r.u64())


@dataclass(frozen=True)
class UnconfirmedSolution:
    solution_id: TransmissionID
    solution: bytes  # serialized Solution (deferred deserialization)

    def write(self, w: Writer):
        w.raw(self.solution_id.to_bytes())
        w.bytes_var(self.solution)

    @classmethod
    def read(cls, r: Reader):
        return cls(TransmissionID.from_reader(r), r.bytes_var())

    def deserialize(self) -> Solution:
        rr = Reader(self.solution)
        out = Solution.from_reader(rr)
        rr.expect_done()
        return out


@dataclass(frozen=True)
class UnconfirmedTransaction:
    transaction_id: TransmissionID
    transaction: bytes  # serialized Transaction (deferred deserialization)

    def write(self, w: Writer):
        w.raw(self.transaction_id.to_bytes())
        w.bytes_var(self.transaction)

    @classmethod
    def read(cls, r: Reader):
        return cls(TransmissionID.from_reader(r), r.bytes_var())

    def deserialize(self) -> Transaction:
        rr = Reader(self.transaction)
        out = Transaction.from_reader(rr)
        rr.expect_done()
        return out


_TYPES = {
    MessageType.BLOCK_REQUEST: BlockRequest,
    MessageType.BLOCK_RESPONSE: BlockResponse,
    MessageType.CHALLENGE_REQUEST: ChallengeRequest,
    MessageType.CHALLENGE_RESPONSE: ChallengeResponse,
    MessageType.DISCONNECT: Disconnect,
    MessageType.PEER_REQUEST: PeerRequest,
    MessageType.PEER_RESPONSE: PeerResponse,
    MessageType.PING: Ping,
    MessageType.PONG: Pong,
    MessageType.PUZZLE_REQUEST: PuzzleRequest,
    MessageType.PUZZLE_RESPONSE: PuzzleResponse,
    MessageType.UNCONFIRMED_SOLUTION: UnconfirmedSolution,
    MessageType.UNCONFIRMED_TRANSACTION: UnconfirmedTransaction,
}
_TYPE_IDS = {v: k for k, v in _TYPES.items()}


def serialize(msg) -> bytes:
    w = Writer()
    mid = _TYPE_IDS[type(msg)]
    w.u16(mid)
    msg.write(w)
    return w.out()


def deserialize(data: bytes):
    """Pre-deserialization size gate for transactions
    (messages/src/lib.rs:157-180 equivalent)."""
    r = Reader(data)
    mid = MessageType(r.u16())
    if mid == MessageType.UNCONFIRMED_TRANSACTION and len(data) > MAX_TRANSACTION_SIZE:
        raise ValueError("transaction message exceeds maximum size")
    msg = _TYPES[mid].read(r)
    r.expect_done()
    return msg


def message_name(msg) -> str:
    return type(msg).__name__
