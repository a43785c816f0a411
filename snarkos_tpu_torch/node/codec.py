"""Wire framing: little-endian length-delimited frames over asyncio.

Mirrors the reference's framing semantics (node/router/messages/src/
helpers/codec.rs:24-46 and node/bft/events/src/helpers/codec.rs:25-46):
4-byte little-endian length prefix, with per-plane maximum frame sizes
(128 MiB router / 256 MiB gateway; 1 MiB during handshake).
"""

from __future__ import annotations

import asyncio
import struct

MAX_FRAME_ROUTER = 128 * 1024 * 1024
MAX_FRAME_GATEWAY = 256 * 1024 * 1024
MAX_FRAME_HANDSHAKE = 1024 * 1024


class FrameError(Exception):
    pass


async def read_frame(reader: asyncio.StreamReader, max_size: int) -> bytes:
    header = await reader.readexactly(4)
    (length,) = struct.unpack("<I", header)
    if length > max_size:
        raise FrameError(f"frame of {length} bytes exceeds limit {max_size}")
    return await reader.readexactly(length)


def write_frame(writer: asyncio.StreamWriter, payload: bytes, max_size: int) -> None:
    if len(payload) > max_size:
        raise FrameError(f"frame of {len(payload)} bytes exceeds limit {max_size}")
    writer.write(struct.pack("<I", len(payload)) + payload)


# --- canonical primitive (de)serializers ------------------------------------


class Reader:
    """Cursor over bytes with the primitive decoders used by all wire types."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise FrameError("unexpected end of buffer")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self.take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self.take(8))[0]

    def bytes_var(self) -> bytes:
        return self.take(self.u32())

    def string(self) -> str:
        return self.bytes_var().decode("utf-8")

    def field(self) -> int:
        """A field/scalar element as 32 little-endian bytes."""
        return int.from_bytes(self.take(32), "little")

    def bool_(self) -> bool:
        return self.u8() != 0

    def done(self) -> bool:
        return self.pos == len(self.buf)

    def expect_done(self) -> None:
        if not self.done():
            raise FrameError(f"{len(self.buf) - self.pos} trailing bytes")


class Writer:
    __slots__ = ("parts",)

    def __init__(self):
        self.parts: list[bytes] = []

    def u8(self, v: int):
        self.parts.append(struct.pack("<B", v))
        return self

    def u16(self, v: int):
        self.parts.append(struct.pack("<H", v))
        return self

    def u32(self, v: int):
        self.parts.append(struct.pack("<I", v))
        return self

    def u64(self, v: int):
        self.parts.append(struct.pack("<Q", v))
        return self

    def i64(self, v: int):
        self.parts.append(struct.pack("<q", v))
        return self

    def bytes_var(self, v: bytes):
        self.u32(len(v))
        self.parts.append(bytes(v))
        return self

    def string(self, v: str):
        return self.bytes_var(v.encode("utf-8"))

    def field(self, v: int):
        self.parts.append(int(v).to_bytes(32, "little"))
        return self

    def bool_(self, v: bool):
        return self.u8(1 if v else 0)

    def raw(self, v: bytes):
        self.parts.append(bytes(v))
        return self

    def out(self) -> bytes:
        return b"".join(self.parts)
