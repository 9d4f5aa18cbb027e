"""Network byte-order codec buffers.

Equivalent surface to the reference's BytesExt/BytesMutExt extension traits
(holo-utils/src/bytes.rs:20,132): cursor-based big-endian get/put for the
packet codecs, with TLV helpers.  Decode errors raise ``DecodeError`` — the
protocol layers translate into their own error enums.
"""

from __future__ import annotations

import struct
from ipaddress import IPv4Address, IPv6Address


class DecodeError(Exception):
    pass


class Reader:
    """Big-endian cursor over immutable bytes."""

    __slots__ = ("data", "pos", "end")

    def __init__(self, data: bytes, start: int = 0, end: int | None = None):
        self.data = data
        self.pos = start
        self.end = len(data) if end is None else end

    def remaining(self) -> int:
        return self.end - self.pos

    def _take(self, n: int) -> bytes:
        if self.remaining() < n:
            raise DecodeError(f"short read: need {n}, have {self.remaining()}")
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b

    def u8(self) -> int:
        return self._take(1)[0]

    def u16(self) -> int:
        return struct.unpack(">H", self._take(2))[0]

    def u24(self) -> int:
        b = self._take(3)
        return (b[0] << 16) | (b[1] << 8) | b[2]

    def u32(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack(">Q", self._take(8))[0]

    def ipv4(self) -> IPv4Address:
        return IPv4Address(self._take(4))

    def ipv6(self) -> IPv6Address:
        return IPv6Address(self._take(16))

    def bytes(self, n: int) -> bytes:
        return self._take(n)

    def rest(self) -> bytes:
        return self._take(self.remaining())

    def sub(self, n: int) -> "Reader":
        """Sub-reader over the next n bytes (TLV bodies, LSA bodies)."""
        if self.remaining() < n:
            raise DecodeError(f"short sub: need {n}, have {self.remaining()}")
        r = Reader(self.data, self.pos, self.pos + n)
        self.pos += n
        return r


class Writer:
    """Big-endian append buffer with backpatching (lengths, checksums)."""

    __slots__ = ("buf",)

    def __init__(self) -> None:
        self.buf = bytearray()

    def __len__(self) -> int:
        return len(self.buf)

    def u8(self, v: int) -> "Writer":
        self.buf.append(v & 0xFF)
        return self

    def u16(self, v: int) -> "Writer":
        self.buf += struct.pack(">H", v & 0xFFFF)
        return self

    def u24(self, v: int) -> "Writer":
        self.buf += bytes(((v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF))
        return self

    def u32(self, v: int) -> "Writer":
        self.buf += struct.pack(">I", v & 0xFFFFFFFF)
        return self

    def u64(self, v: int) -> "Writer":
        self.buf += struct.pack(">Q", v & 0xFFFFFFFFFFFFFFFF)
        return self

    def ipv4(self, a: IPv4Address) -> "Writer":
        self.buf += a.packed
        return self

    def ipv6(self, a: IPv6Address) -> "Writer":
        self.buf += a.packed
        return self

    def bytes(self, b: bytes) -> "Writer":
        self.buf += b
        return self

    def zeros(self, n: int) -> "Writer":
        self.buf += bytes(n)
        return self

    def patch_u16(self, pos: int, v: int) -> None:
        self.buf[pos : pos + 2] = struct.pack(">H", v & 0xFFFF)

    def patch_bytes(self, pos: int, b: bytes) -> None:
        self.buf[pos : pos + len(b)] = b

    def finish(self) -> bytes:
        return bytes(self.buf)


def ip_checksum(data: bytes) -> int:
    """RFC 1071 internet checksum (OSPF packet header, RIP none, etc.)."""
    if len(data) % 2:
        data += b"\x00"
    s = sum(struct.unpack(f">{len(data) // 2}H", data))
    while s >> 16:
        s = (s & 0xFFFF) + (s >> 16)
    return (~s) & 0xFFFF


def fletcher16_checksum(data: bytes, offset: int) -> int:
    """ISO/Fletcher checksum as used by LSAs (RFC 2328 §12.1.7, RFC 905
    annex B): returns the 16-bit check field value to place at ``offset``
    (byte index into ``data``, whose two check bytes must be zero)."""
    c0 = c1 = 0
    for byte in data:
        c0 = (c0 + byte) % 255
        c1 = (c1 + c0) % 255
    # Solve c0_total ≡ 0 and c1_total ≡ 0 for check bytes x (at ``offset``)
    # and y (at offset+1):  x ≡ (L-offset-1)·c0 − c1,  y ≡ −c0 − x.
    x = ((len(data) - offset - 1) * c0 - c1) % 255
    y = (-c0 - x) % 255
    if x == 0:
        x = 255
    if y == 0:
        y = 255
    return (x << 8) | y


def fletcher16_verify(data: bytes) -> bool:
    """True if the Fletcher checksum over data (check bytes in place) is ok."""
    c0 = c1 = 0
    for byte in data:
        c0 = (c0 + byte) % 255
        c1 = (c1 + c0) % 255
    return c0 == 0 and c1 == 0
