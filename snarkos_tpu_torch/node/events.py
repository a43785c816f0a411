"""Gateway-plane (BFT) wire protocol: the 16 event variants.

Mirrors `node/bft/events` (SURVEY.md §2.4; events/src/lib.rs:94-121):
BatchPropose, BatchSignature, BatchCertified, BlockRequest, BlockResponse,
CertificateRequest, CertificateResponse, ChallengeRequest,
ChallengeResponse, Disconnect, PrimaryPing, TransmissionRequest,
TransmissionResponse, ValidatorsRequest, ValidatorsResponse, WorkerPing.
Framing is the same LE length-delimited codec with a 256 MiB cap.

The port of ``snarkos_tpu/node/events.py``: every event encodes to the same
bytes as there.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

from snarkos_tpu_torch.node.codec import Reader, Writer
from snarkos_tpu_torch.node.messages import BlockRequest, BlockResponse, Disconnect
from snarkos_tpu_torch.node.types import (
    BatchCertificate,
    BatchHeader,
    TransmissionID,
    _r_addr,
    _r_sig,
    _w_addr,
    _w_sig,
)

VERSION = 1


class EventType(IntEnum):
    BATCH_PROPOSE = 0
    BATCH_SIGNATURE = 1
    BATCH_CERTIFIED = 2
    BLOCK_REQUEST = 3
    BLOCK_RESPONSE = 4
    CERTIFICATE_REQUEST = 5
    CERTIFICATE_RESPONSE = 6
    CHALLENGE_REQUEST = 7
    CHALLENGE_RESPONSE = 8
    DISCONNECT = 9
    PRIMARY_PING = 10
    TRANSMISSION_REQUEST = 11
    TRANSMISSION_RESPONSE = 12
    VALIDATORS_REQUEST = 13
    VALIDATORS_RESPONSE = 14
    WORKER_PING = 15


@dataclass(frozen=True)
class BatchPropose:
    round: int
    batch_header: bytes  # serialized BatchHeader (deferred deserialization)

    def write(self, w: Writer):
        w.u64(self.round).bytes_var(self.batch_header)

    @classmethod
    def read(cls, r: Reader):
        return cls(r.u64(), r.bytes_var())

    def deserialize(self) -> BatchHeader:
        rr = Reader(self.batch_header)
        out = BatchHeader.from_reader(rr)
        rr.expect_done()
        return out


@dataclass(frozen=True)
class BatchSignature:
    batch_id: bytes  # 32
    signature: tuple

    def write(self, w: Writer):
        w.raw(self.batch_id)
        _w_sig(w, self.signature)

    @classmethod
    def read(cls, r: Reader):
        return cls(r.take(32), _r_sig(r))


@dataclass(frozen=True)
class BatchCertified:
    certificate: bytes  # serialized BatchCertificate

    def write(self, w: Writer):
        w.bytes_var(self.certificate)

    @classmethod
    def read(cls, r: Reader):
        return cls(r.bytes_var())

    def deserialize(self) -> BatchCertificate:
        return BatchCertificate.from_bytes(self.certificate)


@dataclass(frozen=True)
class CertificateRequest:
    certificate_id: bytes  # 32

    def write(self, w: Writer):
        w.raw(self.certificate_id)

    @classmethod
    def read(cls, r: Reader):
        return cls(r.take(32))


@dataclass(frozen=True)
class CertificateResponse:
    certificate_id: bytes
    certificate: bytes | None  # serialized, None if unknown

    def write(self, w: Writer):
        w.raw(self.certificate_id).bool_(self.certificate is not None)
        if self.certificate is not None:
            w.bytes_var(self.certificate)

    @classmethod
    def read(cls, r: Reader):
        cid = r.take(32)
        cert = r.bytes_var() if r.bool_() else None
        return cls(cid, cert)


@dataclass(frozen=True)
class GatewayChallengeRequest:
    version: int
    listener_port: int
    address: str
    nonce: int

    def write(self, w: Writer):
        w.u32(self.version).u16(self.listener_port)
        _w_addr(w, self.address)
        w.u64(self.nonce)

    @classmethod
    def read(cls, r: Reader):
        return cls(r.u32(), r.u16(), _r_addr(r), r.u64())


@dataclass(frozen=True)
class GatewayChallengeResponse:
    signature: tuple  # over nonce || response_nonce
    nonce: int

    def write(self, w: Writer):
        _w_sig(w, self.signature)
        w.u64(self.nonce)

    @classmethod
    def read(cls, r: Reader):
        return cls(_r_sig(r), r.u64())


@dataclass(frozen=True)
class PrimaryPing:
    version: int
    block_height: int
    primary_certificate: bytes | None  # latest own certificate

    def write(self, w: Writer):
        w.u32(self.version).u32(self.block_height)
        w.bool_(self.primary_certificate is not None)
        if self.primary_certificate is not None:
            w.bytes_var(self.primary_certificate)

    @classmethod
    def read(cls, r: Reader):
        version, height = r.u32(), r.u32()
        cert = r.bytes_var() if r.bool_() else None
        return cls(version, height, cert)


@dataclass(frozen=True)
class TransmissionRequest:
    transmission_id: TransmissionID

    def write(self, w: Writer):
        w.raw(self.transmission_id.to_bytes())

    @classmethod
    def read(cls, r: Reader):
        return cls(TransmissionID.from_reader(r))


@dataclass(frozen=True)
class TransmissionResponse:
    transmission_id: TransmissionID
    transmission: bytes | None  # serialized Transmission

    def write(self, w: Writer):
        w.raw(self.transmission_id.to_bytes()).bool_(self.transmission is not None)
        if self.transmission is not None:
            w.bytes_var(self.transmission)

    @classmethod
    def read(cls, r: Reader):
        tid = TransmissionID.from_reader(r)
        t = r.bytes_var() if r.bool_() else None
        return cls(tid, t)


@dataclass(frozen=True)
class ValidatorsRequest:
    def write(self, w: Writer):
        pass

    @classmethod
    def read(cls, r: Reader):
        return cls()


@dataclass(frozen=True)
class ValidatorsResponse:
    validators: tuple  # ((ip, port, address), ...) <= 200

    MAX_VALIDATORS = 200  # gateway.rs:90 equivalent

    def write(self, w: Writer):
        w.u32(len(self.validators))
        for ip, port, addr in self.validators:
            w.string(ip)
            w.u16(port)
            _w_addr(w, addr)

    @classmethod
    def read(cls, r: Reader):
        n = r.u32()
        if n > cls.MAX_VALIDATORS:
            raise ValueError("too many validators in response")
        return cls(tuple((r.string(), r.u16(), _r_addr(r)) for _ in range(n)))


@dataclass(frozen=True)
class WorkerPing:
    transmission_ids: tuple  # advertised ids, <= batch/10

    def write(self, w: Writer):
        w.u32(len(self.transmission_ids))
        for tid in self.transmission_ids:
            w.raw(tid.to_bytes())

    @classmethod
    def read(cls, r: Reader):
        return cls(tuple(TransmissionID.from_reader(r) for _ in range(r.u32())))


_TYPES = {
    EventType.BATCH_PROPOSE: BatchPropose,
    EventType.BATCH_SIGNATURE: BatchSignature,
    EventType.BATCH_CERTIFIED: BatchCertified,
    EventType.BLOCK_REQUEST: BlockRequest,
    EventType.BLOCK_RESPONSE: BlockResponse,
    EventType.CERTIFICATE_REQUEST: CertificateRequest,
    EventType.CERTIFICATE_RESPONSE: CertificateResponse,
    EventType.CHALLENGE_REQUEST: GatewayChallengeRequest,
    EventType.CHALLENGE_RESPONSE: GatewayChallengeResponse,
    EventType.DISCONNECT: Disconnect,
    EventType.PRIMARY_PING: PrimaryPing,
    EventType.TRANSMISSION_REQUEST: TransmissionRequest,
    EventType.TRANSMISSION_RESPONSE: TransmissionResponse,
    EventType.VALIDATORS_REQUEST: ValidatorsRequest,
    EventType.VALIDATORS_RESPONSE: ValidatorsResponse,
    EventType.WORKER_PING: WorkerPing,
}
_TYPE_IDS = {v: k for k, v in _TYPES.items()}


def serialize(event) -> bytes:
    w = Writer()
    w.u16(_TYPE_IDS[type(event)])
    event.write(w)
    return w.out()


def deserialize(data: bytes):
    r = Reader(data)
    eid = EventType(r.u16())
    event = _TYPES[eid].read(r)
    r.expect_done()
    return event


def event_name(event) -> str:
    return type(event).__name__
