"""Core chain data types with canonical serialization.

These are this framework's own wire/storage formats (NOT a byte-level copy
of snarkVM's): each type mirrors a capability of the reference node —
BatchHeader/BatchCertificate/Subdag/Block/Committee reached via snarkVM in
SURVEY.md §1 layer 0, Solution = the puzzle solution (§2.10 puzzle
rows), Transaction = payload + Varuna AHP authorization proof (the Varuna
verify hot path, crypto/ref/varuna.py; §2.10 transaction rows).

All hashes are sha256 over canonical bytes; signatures are Schnorr over
Edwards-BLS12 (crypto/ref/edwards.py) on the canonical bytes sans the
signature itself.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from snarkos_tpu_torch.crypto.ref import edwards
from snarkos_tpu_torch.node.codec import Reader, Writer


def sha256d(data: bytes) -> bytes:
    return hashlib.sha256(hashlib.sha256(data).digest()).digest()


Address = str  # "aleo1" + 64 hex chars (compressed Edwards point)


def address_to_point(addr: Address):
    assert addr.startswith("aleo1"), addr
    return edwards.decompress(bytes.fromhex(addr[5:]))


def point_to_address(p) -> Address:
    return "aleo1" + edwards.compress(p).hex()


def _w_addr(w: Writer, addr: Address):
    w.bytes_var(addr.encode())


def _r_addr(r: Reader) -> Address:
    return r.bytes_var().decode()


def _w_sig(w: Writer, sig: tuple[int, int]):
    w.field(sig[0]).field(sig[1])


def _r_sig(r: Reader) -> tuple[int, int]:
    return (r.field(), r.field())


# --------------------------------------------------------------------------
# Transmissions
# --------------------------------------------------------------------------

TX_SOLUTION = 0
TX_TRANSACTION = 1


@dataclass(frozen=True)
class TransmissionID:
    kind: int  # TX_SOLUTION | TX_TRANSACTION
    digest: bytes  # 32 bytes

    def to_bytes(self) -> bytes:
        return Writer().u8(self.kind).raw(self.digest).out()

    @classmethod
    def from_reader(cls, r: Reader) -> "TransmissionID":
        return cls(kind=r.u8(), digest=r.take(32))

    def __str__(self):
        kind = "solution" if self.kind == TX_SOLUTION else "transaction"
        return f"{kind}:{self.digest.hex()[:16]}"


@dataclass(frozen=True)
class Solution:
    """A puzzle solution (see ops/puzzle.py): KZG commitment + opening
    of a pseudorandom polynomial derived from (epoch_hash, address, nonce)."""

    epoch_hash: bytes  # 32 bytes
    address: Address
    nonce: int  # u64
    commitment: bytes  # 97 bytes: G1 affine (x:48 LE, y:48 LE, inf:1)
    eval_y: int  # Fr
    witness: bytes  # 97 bytes: G1 affine

    def to_bytes(self) -> bytes:
        w = Writer()
        w.raw(self.epoch_hash)
        _w_addr(w, self.address)
        w.u64(self.nonce).bytes_var(self.commitment).field(self.eval_y)
        w.bytes_var(self.witness)
        return w.out()

    @classmethod
    def from_reader(cls, r: Reader) -> "Solution":
        return cls(
            epoch_hash=r.take(32), address=_r_addr(r), nonce=r.u64(),
            commitment=r.bytes_var(), eval_y=r.field(), witness=r.bytes_var(),
        )

    @property
    def id(self) -> TransmissionID:
        return TransmissionID(TX_SOLUTION, sha256d(self.to_bytes()))


@dataclass(frozen=True)
class Transaction:
    """Opaque payload + fee + a Varuna AHP proof of authorization.

    The proof (crypto/ref/varuna.py) shows knowledge of a key k with
    Poseidon2(k, m) = auth_tag for the binding field m derived from
    (payload, fee) — the capability analogue of snarkVM's Varuna-verified
    execution proof (ledger-service/src/ledger.rs:318-343)."""

    payload: bytes
    fee: int  # u64
    auth_tag: int  # Fr: public Poseidon authorization tag
    proof: bytes  # serialized VarunaProof
    is_deploy: bool = False
    # execution proof (vm/circuit.py): Varuna proof of the function-body
    # register trace for provable functions; empty for others.  exec_outs
    # carries the CLAIMED outputs (finalize args + literal outputs) for
    # executes, and the per-function verifying-key digests for deploys.
    exec_proof: bytes = b""
    exec_outs: bytes = b""

    def to_bytes(self) -> bytes:
        w = Writer()
        w.bytes_var(self.payload).u64(self.fee).field(self.auth_tag)
        w.bytes_var(self.proof).bool_(self.is_deploy)
        w.bytes_var(self.exec_proof).bytes_var(self.exec_outs)
        return w.out()

    @classmethod
    def from_reader(cls, r: Reader) -> "Transaction":
        return cls(
            payload=r.bytes_var(), fee=r.u64(), auth_tag=r.field(),
            proof=r.bytes_var(), is_deploy=r.bool_(),
            exec_proof=r.bytes_var(), exec_outs=r.bytes_var(),
        )

    @property
    def id(self) -> TransmissionID:
        return TransmissionID(TX_TRANSACTION, sha256d(self.to_bytes()))


@dataclass(frozen=True)
class Transmission:
    """The serialized union carried in batches (deferred deserialization,
    like the reference's Data::Buffer — router/src/inbound.rs:116-128)."""

    kind: int
    data: bytes  # serialized Solution or Transaction

    def to_bytes(self) -> bytes:
        return Writer().u8(self.kind).bytes_var(self.data).out()

    @classmethod
    def from_reader(cls, r: Reader) -> "Transmission":
        return cls(kind=r.u8(), data=r.bytes_var())

    @classmethod
    def from_solution(cls, s: Solution) -> "Transmission":
        return cls(TX_SOLUTION, s.to_bytes())

    @classmethod
    def from_transaction(cls, t: Transaction) -> "Transmission":
        return cls(TX_TRANSACTION, t.to_bytes())

    def deserialize(self):
        r = Reader(self.data)
        if self.kind == TX_SOLUTION:
            out = Solution.from_reader(r)
        else:
            out = Transaction.from_reader(r)
        r.expect_done()
        return out

    @property
    def id(self) -> TransmissionID:
        return TransmissionID(self.kind, sha256d(self.data))


# --------------------------------------------------------------------------
# Committee
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Committee:
    starting_round: int
    members: tuple  # ((address, stake, is_open), ...) sorted by address

    MAX_COMMITTEE_SIZE = 200

    @classmethod
    def new(cls, starting_round: int, members: dict[Address, int]) -> "Committee":
        ordered = tuple(sorted((a, s, True) for a, s in members.items()))
        return cls(starting_round=starting_round, members=ordered)

    @property
    def addresses(self) -> list[Address]:
        return [m[0] for m in self.members]

    def is_member(self, addr: Address) -> bool:
        return any(m[0] == addr for m in self.members)

    def stake(self, addr: Address) -> int:
        for m in self.members:
            if m[0] == addr:
                return m[1]
        return 0

    @property
    def total_stake(self) -> int:
        return sum(m[1] for m in self.members)

    def quorum_threshold(self) -> int:
        """2f+1 equivalent over stake: > 2/3 of total."""
        return self.total_stake * 2 // 3 + 1

    def availability_threshold(self) -> int:
        """f+1 equivalent over stake: >= 1/3 of total (rounded up)."""
        return (self.total_stake + 2) // 3

    def is_quorum(self, addrs) -> bool:
        return sum(self.stake(a) for a in set(addrs)) >= self.quorum_threshold()

    def is_availability(self, addrs) -> bool:
        return sum(self.stake(a) for a in set(addrs)) >= self.availability_threshold()

    def get_leader(self, round_: int) -> Address:
        """Deterministic stake-weighted leader for an even round (mirrors
        the reference's committee.get_leader semantics: seeded by round,
        weighted by stake)."""
        total = self.total_stake
        seed = int.from_bytes(
            sha256d(Writer().u64(round_).u64(self.starting_round).out())[:8], "little"
        )
        target = seed % total
        acc = 0
        for addr, stake, _ in self.members:
            acc += stake
            if target < acc:
                return addr
        return self.members[-1][0]

    def to_bytes(self) -> bytes:
        w = Writer().u64(self.starting_round).u32(len(self.members))
        for addr, stake, is_open in self.members:
            _w_addr(w, addr)
            w.u64(stake).bool_(is_open)
        return w.out()

    @classmethod
    def from_reader(cls, r: Reader) -> "Committee":
        starting_round = r.u64()
        n = r.u32()
        members = tuple((_r_addr(r), r.u64(), r.bool_()) for _ in range(n))
        return cls(starting_round=starting_round, members=members)

    @property
    def id(self) -> bytes:
        return sha256d(self.to_bytes())


# --------------------------------------------------------------------------
# Batches & certificates (the Narwhal DAG vertices)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class BatchHeader:
    author: Address
    round: int
    timestamp: int
    committee_id: bytes  # 32
    transmission_ids: tuple  # tuple[TransmissionID]
    previous_certificate_ids: tuple  # tuple[bytes32]
    signature: tuple[int, int]

    MAX_TRANSMISSIONS_PER_BATCH = 250

    def _unsigned_bytes(self) -> bytes:
        w = Writer()
        _w_addr(w, self.author)
        w.u64(self.round).i64(self.timestamp).raw(self.committee_id)
        w.u32(len(self.transmission_ids))
        for tid in self.transmission_ids:
            w.raw(tid.to_bytes())
        w.u32(len(self.previous_certificate_ids))
        for cid in self.previous_certificate_ids:
            w.raw(cid)
        return w.out()

    @classmethod
    def sign_new(cls, account, round_: int, timestamp: int, committee_id: bytes,
                 transmission_ids, previous_certificate_ids) -> "BatchHeader":
        hdr = cls(
            author=account.address, round=round_, timestamp=timestamp,
            committee_id=committee_id, transmission_ids=tuple(transmission_ids),
            previous_certificate_ids=tuple(previous_certificate_ids),
            signature=(0, 0),
        )
        sig = edwards.sign_bytes(account.sk, account.pk, hdr._unsigned_bytes())
        return cls(**{**hdr.__dict__, "signature": sig})

    def verify_signature(self) -> bool:
        try:
            pk = address_to_point(self.author)
        except ValueError:
            return False
        return edwards.verify_bytes(pk, self._unsigned_bytes(), self.signature)

    def to_bytes(self) -> bytes:
        w = Writer().raw(self._unsigned_bytes())
        _w_sig(w, self.signature)
        return w.out()

    @classmethod
    def from_reader(cls, r: Reader) -> "BatchHeader":
        author = _r_addr(r)
        round_ = r.u64()
        timestamp = r.i64()
        committee_id = r.take(32)
        tids = tuple(TransmissionID.from_reader(r) for _ in range(r.u32()))
        cids = tuple(r.take(32) for _ in range(r.u32()))
        sig = _r_sig(r)
        return cls(author=author, round=round_, timestamp=timestamp,
                   committee_id=committee_id, transmission_ids=tids,
                   previous_certificate_ids=cids, signature=sig)

    @property
    def batch_id(self) -> bytes:
        return sha256d(self._unsigned_bytes())


@dataclass(frozen=True)
class BatchCertificate:
    batch_header: BatchHeader
    signatures: tuple  # tuple[(Address, (c, s))] — peer endorsements

    def to_bytes(self) -> bytes:
        w = Writer().raw(self.batch_header.to_bytes()).u32(len(self.signatures))
        for addr, sig in self.signatures:
            _w_addr(w, addr)
            _w_sig(w, sig)
        return w.out()

    @classmethod
    def from_reader(cls, r: Reader) -> "BatchCertificate":
        hdr = BatchHeader.from_reader(r)
        sigs = tuple((_r_addr(r), _r_sig(r)) for _ in range(r.u32()))
        return cls(batch_header=hdr, signatures=sigs)

    @classmethod
    def from_bytes(cls, data: bytes) -> "BatchCertificate":
        r = Reader(data)
        out = cls.from_reader(r)
        r.expect_done()
        return out

    @property
    def id(self) -> bytes:
        return sha256d(self.batch_header.batch_id)

    @property
    def round(self) -> int:
        return self.batch_header.round

    @property
    def author(self) -> Address:
        return self.batch_header.author

    def signer_addresses(self) -> list[Address]:
        """Author + endorsers (the set counted toward quorum)."""
        return [self.batch_header.author] + [a for a, _ in self.signatures]

    def verify(self, committee: Committee) -> bool:
        if not self.batch_header.verify_signature():
            return False
        msg = self.batch_header.batch_id
        for addr, sig in self.signatures:
            if not committee.is_member(addr):
                return False
            try:
                pk = address_to_point(addr)
            except ValueError:
                return False
            if not edwards.verify_bytes(pk, msg, sig):
                return False
        return committee.is_quorum(self.signer_addresses())


@dataclass(frozen=True)
class Subdag:
    """round -> tuple of certificates (the commit's causal history)."""

    rounds: tuple  # ((round, (cert, ...)), ...) ascending

    def to_bytes(self) -> bytes:
        w = Writer().u32(len(self.rounds))
        for round_, certs in self.rounds:
            w.u64(round_).u32(len(certs))
            for c in certs:
                w.bytes_var(c.to_bytes())
        return w.out()

    @classmethod
    def from_reader(cls, r: Reader) -> "Subdag":
        rounds = []
        for _ in range(r.u32()):
            round_ = r.u64()
            certs = tuple(BatchCertificate.from_bytes(r.bytes_var()) for _ in range(r.u32()))
            rounds.append((round_, certs))
        return cls(rounds=tuple(rounds))

    @property
    def anchor_round(self) -> int:
        return self.rounds[-1][0] if self.rounds else 0

    @property
    def leader_certificate(self) -> "BatchCertificate":
        return self.rounds[-1][1][0]

    def all_certificates(self):
        for _, certs in self.rounds:
            yield from certs


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Block:
    height: int
    previous_hash: bytes  # 32
    timestamp: int
    round: int
    epoch_hash: bytes  # 32; rotates every EPOCH_BLOCKS heights
    proof_target: int
    subdag: Subdag | None
    transmissions: tuple  # tuple[Transmission] in committed order

    EPOCH_BLOCKS = 360

    def _header_bytes(self) -> bytes:
        w = Writer()
        w.u64(self.height).raw(self.previous_hash).i64(self.timestamp)
        w.u64(self.round).raw(self.epoch_hash).u64(self.proof_target)
        w.bool_(self.subdag is not None)
        if self.subdag is not None:
            w.bytes_var(self.subdag.to_bytes())
        w.u32(len(self.transmissions))
        for t in self.transmissions:
            w.bytes_var(t.to_bytes())
        return w.out()

    def to_bytes(self) -> bytes:
        return self._header_bytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "Block":
        r = Reader(data)
        height = r.u64()
        previous_hash = r.take(32)
        timestamp = r.i64()
        round_ = r.u64()
        epoch_hash = r.take(32)
        proof_target = r.u64()
        subdag = None
        if r.bool_():
            sr = Reader(r.bytes_var())
            subdag = Subdag.from_reader(sr)
            sr.expect_done()
        txs = tuple(Transmission.from_reader(Reader(r.bytes_var())) for _ in range(r.u32()))
        r.expect_done()
        return cls(height=height, previous_hash=previous_hash, timestamp=timestamp,
                   round=round_, epoch_hash=epoch_hash, proof_target=proof_target,
                   subdag=subdag, transmissions=txs)

    @property
    def hash(self) -> bytes:
        return sha256d(self._header_bytes())


def genesis_block(committee: Committee) -> Block:
    return Block(
        height=0,
        previous_hash=b"\x00" * 32,
        timestamp=0,
        round=0,
        epoch_hash=sha256d(b"snarkos_tpu.genesis.epoch" + committee.id),
        proof_target=1 << 8,
        subdag=None,
        transmissions=(),
    )
