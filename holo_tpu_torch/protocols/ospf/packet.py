"""OSPFv2 packet and LSA codecs (RFC 2328 §A).

Zero-copy-ish cursor codecs in the style of the reference's packet layer
(holo-ospf/src/ospfv2/packet/), with strict length/checksum validation.
All multi-byte fields are network byte order via utils.bytesbuf.
"""

from __future__ import annotations

import enum
import hashlib
import hmac as _hmac
from dataclasses import dataclass, field
from ipaddress import IPv4Address

from holo_tpu_torch.utils.bytesbuf import (
    DecodeError,
    Reader,
    Writer,
    fletcher16_checksum,
    fletcher16_verify,
    ip_checksum,
)

OSPF_VERSION = 2
PKT_HDR_LEN = 24
LSA_HDR_LEN = 20
MAX_AGE = 3600  # seconds (RFC 2328 §B)
LS_REFRESH_TIME = 1800
MAX_AGE_DIFF = 900
LS_INFINITY = 0xFFFFFF
# RFC 6987 §2: the largest 16-bit router-link metric — a stub router
# advertises it on transit links so neighbors avoid it for transit
# traffic while its own prefixes stay reachable.
MAX_LINK_METRIC = 0xFFFF
INITIAL_SEQ_NO = -0x7FFFFFFF  # 0x80000001 signed
MAX_SEQ_NO = 0x7FFFFFFF


def lsa_tx_copy(lsa, delay: int, max_age: int = MAX_AGE):
    """§13.3: LS age is incremented by the interface's InfTransDelay
    (transmit-delay leaf) when copied into an outgoing LS Update, capped
    at MaxAge.  The Fletcher checksum excludes the age field, so the raw
    bytes only need the age halfword patched.  RFC 5340 keeps both the
    header layout and §13.3 unchanged, so the v2 and v3 instances share
    this one helper."""
    if delay <= 0 or lsa.age >= max_age:
        return lsa
    import copy

    out = copy.copy(lsa)
    out.age = min(lsa.age + delay, max_age)
    if lsa.raw:
        raw = bytearray(lsa.raw)
        raw[0:2] = out.age.to_bytes(2, "big")
        out.raw = bytes(raw)
    return out


class PacketType(enum.IntEnum):
    HELLO = 1
    DB_DESC = 2
    LS_REQUEST = 3
    LS_UPDATE = 4
    LS_ACK = 5


class LsaType(enum.IntEnum):
    ROUTER = 1
    NETWORK = 2
    SUMMARY_NETWORK = 3
    SUMMARY_ROUTER = 4
    AS_EXTERNAL = 5
    NSSA_EXTERNAL = 7  # RFC 3101 type-7 (same body as type-5)
    OPAQUE_LINK = 9
    OPAQUE_AREA = 10
    OPAQUE_AS = 11


class Options(enum.IntFlag):
    E = 0x02  # external routing capability (not a stub area)
    MC = 0x04
    NP = 0x08  # NSSA
    L = 0x10  # LLS data block present (RFC 5613)
    DC = 0x20
    O = 0x40  # opaque capable


class RouterLinkType(enum.IntEnum):
    POINT_TO_POINT = 1
    TRANSIT_NETWORK = 2
    STUB_NETWORK = 3
    VIRTUAL_LINK = 4


class RouterFlags(enum.IntFlag):
    B = 0x01  # area border router
    E = 0x02  # AS boundary router
    V = 0x04  # virtual link endpoint


class AuthType(enum.IntEnum):
    NULL = 0
    SIMPLE = 1
    CRYPTOGRAPHIC = 2


# ===== LSA bodies =====


@dataclass(frozen=True)
class RouterLink:
    link_type: RouterLinkType
    id: IPv4Address  # neighbor router id / DR addr / network
    data: IPv4Address  # iface addr / mask for stub
    metric: int


@dataclass
class LsaRouter:
    flags: RouterFlags = RouterFlags(0)
    links: list[RouterLink] = field(default_factory=list)

    def encode(self, w: Writer) -> None:
        w.u8(int(self.flags)).u8(0).u16(len(self.links))
        for l in self.links:
            w.ipv4(l.id).ipv4(l.data).u8(int(l.link_type)).u8(0).u16(l.metric)

    @classmethod
    def decode(cls, r: Reader) -> "LsaRouter":
        flags = RouterFlags(r.u8() & 0x07)
        r.u8()
        n = r.u16()
        links = []
        for _ in range(n):
            lid, data = r.ipv4(), r.ipv4()
            ltype = r.u8()
            ntos = r.u8()
            metric = r.u16()
            for _ in range(ntos):  # skip per-TOS metrics
                r.u32()
            try:
                lt = RouterLinkType(ltype)
            except ValueError as e:
                raise DecodeError(f"bad router link type {ltype}") from e
            links.append(RouterLink(lt, lid, data, metric))
        return cls(RouterFlags(flags), links)


@dataclass
class LsaNetwork:
    mask: IPv4Address = IPv4Address(0)
    attached: list[IPv4Address] = field(default_factory=list)

    def encode(self, w: Writer) -> None:
        w.ipv4(self.mask)
        for a in self.attached:
            w.ipv4(a)

    @classmethod
    def decode(cls, r: Reader) -> "LsaNetwork":
        mask = r.ipv4()
        attached = []
        while r.remaining() >= 4:
            attached.append(r.ipv4())
        return cls(mask, attached)


@dataclass
class LsaSummary:
    """Type 3 (network) and 4 (ASBR) summary share the body format."""

    mask: IPv4Address = IPv4Address(0)
    metric: int = 0

    def encode(self, w: Writer) -> None:
        w.ipv4(self.mask).u32(self.metric & LS_INFINITY)

    @classmethod
    def decode(cls, r: Reader) -> "LsaSummary":
        mask = r.ipv4()
        metric = r.u32() & LS_INFINITY
        return cls(mask, metric)


@dataclass
class LsaAsExternal:
    mask: IPv4Address = IPv4Address(0)
    e_bit: bool = True  # type 2 external metric
    metric: int = 0
    fwd_addr: IPv4Address = IPv4Address(0)
    tag: int = 0

    def encode(self, w: Writer) -> None:
        w.ipv4(self.mask)
        w.u32(((0x80000000 if self.e_bit else 0) | (self.metric & LS_INFINITY)))
        w.ipv4(self.fwd_addr).u32(self.tag)

    @classmethod
    def decode(cls, r: Reader) -> "LsaAsExternal":
        mask = r.ipv4()
        word = r.u32()
        fwd = r.ipv4()
        tag = r.u32()
        # additional TOS routes ignored
        return cls(mask, bool(word & 0x80000000), word & LS_INFINITY, fwd, tag)


@dataclass
class LsaOpaque:
    data: bytes = b""

    def encode(self, w: Writer) -> None:
        w.bytes(self.data)

    @classmethod
    def decode(cls, r: Reader) -> "LsaOpaque":
        return cls(r.rest())


GRACE_OPAQUE_TYPE = 3  # RFC 3623 Grace-LSA (opaque type 9.3)
RI_OPAQUE_TYPE = 4  # RFC 7770 Router Information (opaque type 10.4)
EXT_PREFIX_OPAQUE_TYPE = 7  # RFC 7684 Extended Prefix (opaque type 10.7)

# RFC 7770 informational capability bits (bit 0 = MSB of the 32-bit field).
RI_CAP_GR_CAPABLE = 0x80000000
RI_CAP_GR_HELPER = 0x40000000
RI_CAP_STUB_ROUTER = 0x20000000


def ri_lsid() -> IPv4Address:
    return IPv4Address(RI_OPAQUE_TYPE << 24)


def encode_router_info(
    info_caps: int,
    hostname: str | None = None,
    node_tags: tuple[int, ...] = (),
) -> bytes:
    """RI LSA body: Informational Capabilities TLV (type 1, RFC 7770
    §2.2), Dynamic Hostname TLV (type 7, RFC 5642), and Node Admin Tag
    TLV (type 10, RFC 7777) when set."""
    w = Writer()
    w.u16(1).u16(4).u32(info_caps & 0xFFFFFFFF)
    if hostname:
        raw = hostname.encode()[:255]
        w.u16(7).u16(len(raw)).bytes(raw)
        w.zeros((4 - len(raw) % 4) % 4)
    if node_tags:
        w.u16(10).u16(4 * len(node_tags))
        for tag in node_tags:
            w.u32(tag)
    return w.finish()


def decode_router_info(data: bytes) -> dict:
    """Returns {'info_caps': int, 'hostname': str|None, 'node_tags': tuple}."""
    r = Reader(data)
    out = {
        "info_caps": 0, "hostname": None, "node_tags": (),
        "sr_algos": (), "srgb_ranges": (),
    }
    while r.remaining() >= 4:
        t = r.u16()
        length = r.u16()
        body = r.sub(min((length + 3) // 4 * 4, r.remaining()))
        if t == 1 and body.remaining() >= 4:
            out["info_caps"] = body.u32()
        elif t == 8:  # SR-Algorithm TLV (RFC 8665 §3.1)
            out["sr_algos"] = tuple(
                body.u8()
                for _ in range(min(length, body.remaining()))
            )
        elif t == 9 and body.remaining() >= 4:  # SID/Label Range (§3.2)
            size = body.u24()
            body.u8()
            first = None
            if body.remaining() >= 4:
                st = body.u16()
                sl = body.u16()
                if st == 1 and body.remaining() >= 3:
                    first = (
                        body.u24()
                        if sl == 3 or body.remaining() < 4
                        else body.u32()
                    )
            out["srgb_ranges"] = out["srgb_ranges"] + (
                (size, first),
            )
        elif t == 7 and body.remaining() >= length:
            try:
                out["hostname"] = body.bytes(length).decode()
            except UnicodeDecodeError:
                pass
        elif t == 10:
            tags = []
            while body.remaining() >= 4:
                tags.append(body.u32())
            out["node_tags"] = tuple(tags)
    return out


def ext_prefix_lsid(opaque_id: int) -> IPv4Address:
    return IPv4Address((EXT_PREFIX_OPAQUE_TYPE << 24) | (opaque_id & 0xFFFFFF))


# Extended-prefix attribute flags (RFC 7684/9085; reference iana.rs).
EXT_PREFIX_FLAG_A = 0x80  # attach
EXT_PREFIX_FLAG_N = 0x40  # node
EXT_PREFIX_FLAG_AC = 0x10  # anycast


def _encode_ext_prefix_tlv1(prefix, sub_tlvs: bytes, flags: int = 0) -> bytes:
    """Extended-Prefix TLV (1) framing shared by the SR/BIER/flag
    encoders (RFC 7684 §2.1)."""
    w = Writer()
    body = Writer()
    plen = prefix.prefixlen
    body.u8(1).u8(plen).u8(0).u8(flags)  # route-type IntraArea, af 0
    nbytes = (plen + 7) // 8
    body.bytes(prefix.network_address.packed[:nbytes])
    body.zeros((4 - nbytes % 4) % 4)
    body.bytes(sub_tlvs)
    w.u16(1).u16(len(body)).bytes(body.finish())
    return w.finish()


def encode_ext_prefix_flags(entries) -> bytes:
    """One Extended-Prefix TLV per (prefix, flags) pair — the N/AC
    attribute advertisement (reference ospfv2/lsdb.rs:760-800)."""
    out = b""
    for prefix, flags in entries:
        out += _encode_ext_prefix_tlv1(prefix, b"", flags=flags)
    return out


def _walk_ext_prefix_tlv1(data: bytes, with_meta: bool = False):
    """Yield (prefix, sub-TLV Reader) — or (prefix, route_type, flags,
    Reader) with ``with_meta`` — for each Extended-Prefix TLV; host bits
    below the prefix length are masked off (foreign advertisements may
    carry them)."""
    from ipaddress import IPv4Network

    r = Reader(data)
    while r.remaining() >= 4:
        t = r.u16()
        length = r.u16()
        body = r.sub(min((length + 3) // 4 * 4, r.remaining()))
        if t != 1 or body.remaining() < 4:
            continue
        route_type = body.u8()
        plen = body.u8()
        body.u8()  # AF
        flags = body.u8()
        if plen > 32:
            continue
        nbytes = (plen + 7) // 8
        if body.remaining() < nbytes:
            continue
        raw = body.bytes(nbytes) + bytes(4 - nbytes)
        pad = (4 - nbytes % 4) % 4
        if body.remaining() >= pad:
            body.bytes(pad)
        val = int.from_bytes(raw, "big")
        if plen < 32:
            val &= ~((1 << (32 - plen)) - 1)
        prefix = IPv4Network((val, plen))
        if with_meta:
            yield prefix, route_type, flags, body
        else:
            yield prefix, body


def decode_ext_prefix_entries(data: bytes) -> list:
    """All Extended-Prefix TLVs of an opaque LSA, fully parsed:
    [(prefix, route_type, flags, [{flags, mt, algo, sid}])] — the SID
    sub-TLV fields per RFC 8665 §5."""
    out = []
    for prefix, route_type, flags, body in _walk_ext_prefix_tlv1(
        data, with_meta=True
    ):
        sids = []
        while body.remaining() >= 4:
            st = body.u16()
            sl = body.u16()
            sbody = body.sub(min((sl + 3) // 4 * 4, body.remaining()))
            if st == 2 and sbody.remaining() >= 8:
                sid_flags = sbody.u8()
                sbody.u8()  # reserved
                mt = sbody.u8()
                algo = sbody.u8()
                sids.append(
                    {
                        "flags": sid_flags,
                        "mt": mt,
                        "algo": algo,
                        "sid": sbody.u32(),
                    }
                )
        out.append((prefix, route_type, flags, sids))
    return out


def decode_ext_link(data: bytes) -> list:
    """Extended-Link TLVs (RFC 7684 §3, opaque type 8) with their
    Adj-SID sub-TLVs (RFC 8665 §6.1):
    [(link_type, link_id, link_data, [{flags, mt, weight, sid}])]."""
    r = Reader(data)
    out = []
    while r.remaining() >= 4:
        t = r.u16()
        length = r.u16()
        body = r.sub(min((length + 3) // 4 * 4, r.remaining()))
        if t != 1 or body.remaining() < 12:  # Extended-Link TLV
            continue
        ltype = body.u8()
        body.u8()
        body.u16()
        link_id = body.ipv4()
        link_data = body.ipv4()
        sids = []
        while body.remaining() >= 4:
            st = body.u16()
            sl = body.u16()
            sbody = body.sub(min((sl + 3) // 4 * 4, body.remaining()))
            if st == 2 and sbody.remaining() >= 7:  # Adj-SID
                fl = sbody.u8()
                sbody.u8()  # reserved
                mt = sbody.u8()
                weight = sbody.u8()
                # sub-TLV length decides the SID width: 7 = 3-byte
                # label (L flag), 8 = 4-byte index (§6.1).
                sid = (
                    sbody.u24()
                    if sl == 7 or sbody.remaining() < 4
                    else sbody.u32()
                )
                sids.append(
                    {"flags": fl, "mt": mt, "weight": weight, "sid": sid}
                )
            elif st == 3 and sbody.remaining() >= 11:  # LAN Adj-SID
                fl = sbody.u8()
                sbody.u8()
                mt = sbody.u8()
                weight = sbody.u8()
                nbr = sbody.ipv4()
                sid = (
                    sbody.u24()
                    if sl == 11 or sbody.remaining() < 4
                    else sbody.u32()
                )
                sids.append(
                    {
                        "flags": fl, "mt": mt, "weight": weight,
                        "nbr": nbr, "sid": sid,
                    }
                )
        out.append((ltype, link_id, link_data, sids))
    return out


def encode_ext_prefix_sid(prefix, sid_index: int, flags: int = 0) -> bytes:
    """Extended-Prefix TLV (1) with a Prefix-SID sub-TLV (2) — the RFC
    7684/8665 shape, condensed to the fields the SPF/SR path consumes."""
    sub = Writer()
    # Prefix-SID sub-TLV: type 2, flags, reserved, MT, algo, SID index.
    inner = Writer()
    inner.u8(flags).u8(0).u8(0).u8(0).u32(sid_index)
    sub.u16(2).u16(len(inner)).bytes(inner.finish())
    return _encode_ext_prefix_tlv1(prefix, sub.finish())


def encode_ext_prefix_bier(
    prefix, sd_id: int, bfr_id: int, bsls, mt_id: int = 0
) -> bytes:
    """Extended-Prefix TLV (1) with a BIER sub-TLV (9, RFC 9089 §2.1)
    carrying our BFR-id in a sub-domain plus one BIER MPLS Encapsulation
    sub-sub-TLV (1) per advertised bitstring length."""
    sub = Writer()
    inner = Writer()
    inner.u8(sd_id).u8(mt_id).u16(bfr_id)
    inner.u8(0).u8(0).u16(0)  # BAR, IPA, reserved
    for bsl in bsls:
        # RFC 8296 BSL identifier: 1 = 64 bits, doubling per step.
        bsl_id = (bsl // 64).bit_length()
        inner.u16(1).u16(4).u8(0).u8(bsl_id << 4).u16(0)
    sub.u16(9).u16(len(inner)).bytes(inner.finish())
    return _encode_ext_prefix_tlv1(prefix, sub.finish())


def decode_ext_prefix_bier(data: bytes):
    """Returns (IPv4Network prefix, sd_id, mt_id, bfr_id, (bsl, ...))
    or None when no BIER sub-TLV is present."""
    for prefix, body in _walk_ext_prefix_tlv1(data):
        while body.remaining() >= 4:
            st = body.u16()
            sl = body.u16()
            sbody = body.sub(min((sl + 3) // 4 * 4, body.remaining()))
            if st != 9 or sbody.remaining() < 8:
                continue
            sd_id = sbody.u8()
            mt_id = sbody.u8()
            bfr_id = sbody.u16()
            sbody.u8()
            sbody.u8()
            sbody.u16()
            bsls = []
            while sbody.remaining() >= 4:
                sst = sbody.u16()
                ssl = sbody.u16()
                ssb = sbody.sub(min((ssl + 3) // 4 * 4, sbody.remaining()))
                if sst == 1 and ssb.remaining() >= 4:
                    ssb.u8()
                    bsl_id = ssb.u8() >> 4
                    if bsl_id >= 1:
                        bsls.append(64 << (bsl_id - 1))
            return prefix, sd_id, mt_id, bfr_id, tuple(bsls)
    return None


def decode_ext_prefix_sid(data: bytes):
    """Returns (IPv4Network prefix, sid_index, flags) or None."""
    for prefix, body in _walk_ext_prefix_tlv1(data):
        while body.remaining() >= 4:
            st = body.u16()
            sl = body.u16()
            sbody = body.sub(min((sl + 3) // 4 * 4, body.remaining()))
            if st == 2 and sbody.remaining() >= 8:
                flags = sbody.u8()
                sbody.u8()
                sbody.u8()
                sbody.u8()
                return prefix, sbody.u32(), flags
    return None


def grace_lsa_lsid(opaque_id: int = 0) -> IPv4Address:
    """Opaque LSAs carry (opaque type, opaque id) in the link-state id;
    the opaque id keeps per-interface Grace-LSAs distinct."""
    return IPv4Address((GRACE_OPAQUE_TYPE << 24) | (opaque_id & 0xFFFFFF))


def encode_grace_tlvs(
    grace_period: int, reason: int, addr: IPv4Address | None
) -> bytes:
    """RFC 3623 §B: grace period (1), restart reason (2), and — only when
    present (it is optional on p2p links) — IP address (3)."""
    w = Writer()
    w.u16(1).u16(4).u32(grace_period)
    w.u16(2).u16(1).u8(reason).zeros(3)
    if addr is not None:
        w.u16(3).u16(4).ipv4(addr)
    return w.finish()


def decode_grace_tlvs(data: bytes) -> dict:
    """Tolerant parse: gates on ACTUAL remaining bytes, never the declared
    length (a crafted short TLV must not raise out of the rx path)."""
    r = Reader(data)
    out: dict = {}
    while r.remaining() >= 4:
        t = r.u16()
        length = r.u16()
        body = r.sub(min((length + 3) // 4 * 4, r.remaining()))
        if t == 1 and body.remaining() >= 4:
            out["grace_period"] = body.u32()
        elif t == 2 and body.remaining() >= 1:
            out["reason"] = body.u8()
        elif t == 3 and body.remaining() >= 4:
            out["addr"] = body.ipv4()
    return out


_BODY_CODECS = {
    LsaType.ROUTER: LsaRouter,
    LsaType.NETWORK: LsaNetwork,
    LsaType.SUMMARY_NETWORK: LsaSummary,
    LsaType.SUMMARY_ROUTER: LsaSummary,
    LsaType.AS_EXTERNAL: LsaAsExternal,
    LsaType.NSSA_EXTERNAL: LsaAsExternal,
    LsaType.OPAQUE_LINK: LsaOpaque,
    LsaType.OPAQUE_AREA: LsaOpaque,
    LsaType.OPAQUE_AS: LsaOpaque,
}


@dataclass(frozen=True)
class LsaKey:
    """LSDB key (RFC 2328 §12.1: type, link-state id, advertising router)."""

    type: LsaType
    lsid: IPv4Address
    adv_rtr: IPv4Address


@dataclass
class Lsa:
    """Header + body; raw wire image cached for flooding/checksum."""

    age: int
    options: Options
    type: LsaType
    lsid: IPv4Address
    adv_rtr: IPv4Address
    seq_no: int
    body: object
    cksum: int = 0
    length: int = 0
    raw: bytes = b""

    @property
    def key(self) -> LsaKey:
        return LsaKey(self.type, self.lsid, self.adv_rtr)

    @property
    def is_maxage(self) -> bool:
        return self.age >= MAX_AGE

    def encode(self) -> bytes:
        """Encode body, compute length + Fletcher checksum, cache raw."""
        w = Writer()
        w.u16(self.age).u8(int(self.options)).u8(int(self.type))
        w.ipv4(self.lsid).ipv4(self.adv_rtr)
        w.u32(self.seq_no & 0xFFFFFFFF)
        w.u16(0)  # checksum placeholder
        w.u16(0)  # length placeholder
        self.body.encode(w)
        w.patch_u16(18, len(w))
        self.length = len(w)
        # Fletcher over everything except the age field (first 2 bytes).
        cks = fletcher16_checksum(bytes(w.buf[2:]), 14)
        w.patch_u16(16, cks)
        self.cksum = cks
        self.raw = w.finish()
        return self.raw

    @classmethod
    def decode(cls, r: Reader) -> "Lsa":
        start = r.pos
        if r.remaining() < LSA_HDR_LEN:
            raise DecodeError("short LSA header")
        age = r.u16()
        options = Options(r.u8())
        try:
            ltype = LsaType(r.u8())
        except ValueError as e:
            raise DecodeError("unknown LSA type") from e
        lsid, adv = r.ipv4(), r.ipv4()
        seq = r.u32()
        if seq & 0x80000000:
            seq -= 1 << 32
        cksum = r.u16()
        length = r.u16()
        if length < LSA_HDR_LEN:
            raise DecodeError(f"bad LSA length {length}")
        body_len = length - LSA_HDR_LEN
        if r.remaining() < body_len:
            raise DecodeError("LSA length exceeds buffer")
        raw = r.data[start : start + length]
        # A checksum mismatch does NOT abort the decode: the rx path
        # validates separately and emits if-rx-bad-lsa (reference decodes
        # tolerantly, lsa.rs validate() flags it — events.rs:830-845).
        body = _BODY_CODECS[ltype].decode(r.sub(body_len))
        return cls(age, options, ltype, lsid, adv, seq, body, cksum, length, raw)

    @classmethod
    def decode_header(cls, r: Reader) -> "Lsa":
        """Header-only decode (DD packets, LS Ack)."""
        age = r.u16()
        options = Options(r.u8())
        ltype = LsaType(r.u8())
        lsid, adv = r.ipv4(), r.ipv4()
        seq = r.u32()
        if seq & 0x80000000:
            seq -= 1 << 32
        cksum = r.u16()
        length = r.u16()
        return cls(age, options, ltype, lsid, adv, seq, None, cksum, length)

    def encode_header(self, w: Writer) -> None:
        w.u16(self.age).u8(int(self.options)).u8(int(self.type))
        w.ipv4(self.lsid).ipv4(self.adv_rtr).u32(self.seq_no & 0xFFFFFFFF)
        w.u16(self.cksum).u16(self.length)

    def compare(self, other: "Lsa") -> int:
        """RFC 2328 §13.1 which-is-newer: >0 self newer, <0 other newer."""
        if self.seq_no != other.seq_no:
            return 1 if self.seq_no > other.seq_no else -1
        if self.cksum != other.cksum:
            return 1 if self.cksum > other.cksum else -1
        if self.is_maxage != other.is_maxage:
            return 1 if self.is_maxage else -1
        if abs(self.age - other.age) > MAX_AGE_DIFF:
            return 1 if self.age < other.age else -1
        return 0


# ===== Packets =====


@dataclass
class Hello:
    mask: IPv4Address
    hello_interval: int
    options: Options
    priority: int
    dead_interval: int
    dr: IPv4Address
    bdr: IPv4Address
    neighbors: list[IPv4Address] = field(default_factory=list)

    TYPE = PacketType.HELLO

    def encode_body(self, w: Writer) -> None:
        w.ipv4(self.mask).u16(self.hello_interval).u8(int(self.options))
        w.u8(self.priority).u32(self.dead_interval)
        w.ipv4(self.dr).ipv4(self.bdr)
        for n in self.neighbors:
            w.ipv4(n)

    @classmethod
    def decode_body(cls, r: Reader) -> "Hello":
        mask = r.ipv4()
        hello_int = r.u16()
        options = Options(r.u8())
        prio = r.u8()
        dead = r.u32()
        dr, bdr = r.ipv4(), r.ipv4()
        nbrs = []
        while r.remaining() >= 4:
            nbrs.append(r.ipv4())
        return cls(mask, hello_int, options, prio, dead, dr, bdr, nbrs)


class DbDescFlags(enum.IntFlag):
    MS = 0x01  # master
    M = 0x02  # more
    I = 0x04  # init


@dataclass
class DbDesc:
    mtu: int
    options: Options
    flags: DbDescFlags
    dd_seq_no: int
    lsa_headers: list[Lsa] = field(default_factory=list)

    TYPE = PacketType.DB_DESC

    def encode_body(self, w: Writer) -> None:
        w.u16(self.mtu).u8(int(self.options)).u8(int(self.flags))
        w.u32(self.dd_seq_no)
        for h in self.lsa_headers:
            h.encode_header(w)

    @classmethod
    def decode_body(cls, r: Reader) -> "DbDesc":
        mtu = r.u16()
        options = Options(r.u8())
        flags = DbDescFlags(r.u8())
        seq = r.u32()
        hdrs = []
        while r.remaining() >= LSA_HDR_LEN:
            hdrs.append(Lsa.decode_header(r))
        return cls(mtu, options, flags, seq, hdrs)


@dataclass
class LsRequest:
    entries: list[LsaKey] = field(default_factory=list)

    TYPE = PacketType.LS_REQUEST

    def encode_body(self, w: Writer) -> None:
        for k in self.entries:
            w.u32(int(k.type)).ipv4(k.lsid).ipv4(k.adv_rtr)

    @classmethod
    def decode_body(cls, r: Reader) -> "LsRequest":
        entries = []
        while r.remaining() >= 12:
            t = LsaType(r.u32())
            entries.append(LsaKey(t, r.ipv4(), r.ipv4()))
        return cls(entries)


@dataclass
class LsUpdate:
    lsas: list[Lsa] = field(default_factory=list)

    TYPE = PacketType.LS_UPDATE

    def encode_body(self, w: Writer) -> None:
        w.u32(len(self.lsas))
        for lsa in self.lsas:
            w.bytes(lsa.raw if lsa.raw else lsa.encode())

    @classmethod
    def decode_body(cls, r: Reader) -> "LsUpdate":
        n = r.u32()
        lsas = []
        for _ in range(n):
            start = r.pos
            try:
                lsas.append(Lsa.decode(r))
            except DecodeError:
                # §13 steps 2-3: an LSA of unknown type (or otherwise
                # undecodable body) is discarded; the REST of the update
                # is still processed.  Advance by the header's length
                # field; if even that is unusable, the packet is
                # unrecoverable.
                r.pos = start
                if r.remaining() < LSA_HDR_LEN:
                    raise
                length = int.from_bytes(r.data[start + 18 : start + 20], "big")
                if length < LSA_HDR_LEN or r.remaining() < length:
                    raise
                r.pos = start + length
        return cls(lsas)


@dataclass
class LsAck:
    lsa_headers: list[Lsa] = field(default_factory=list)

    TYPE = PacketType.LS_ACK

    def encode_body(self, w: Writer) -> None:
        for h in self.lsa_headers:
            h.encode_header(w)

    @classmethod
    def decode_body(cls, r: Reader) -> "LsAck":
        hdrs = []
        while r.remaining() >= LSA_HDR_LEN:
            hdrs.append(Lsa.decode_header(r))
        return cls(hdrs)


_PKT_CODECS = {
    PacketType.HELLO: Hello,
    PacketType.DB_DESC: DbDesc,
    PacketType.LS_REQUEST: LsRequest,
    PacketType.LS_UPDATE: LsUpdate,
    PacketType.LS_ACK: LsAck,
}


# Digest algorithms: RFC 2328 Appendix D keyed-MD5 plus the RFC 5709
# HMAC-SHA family.  Value = (digest_len, hmac_name or None for keyed-md5).
AUTH_ALGOS = {
    "md5": (16, None),
    "hmac-sha-1": (20, "sha1"),
    "hmac-sha-256": (32, "sha256"),
    "hmac-sha-384": (48, "sha384"),
    "hmac-sha-512": (64, "sha512"),
}


@dataclass
class AuthCtx:
    """Interface authentication context (RFC 2328 Appendix D / RFC 5709).

    type SIMPLE: ``key`` is the 8-byte password.  type CRYPTOGRAPHIC: a
    keyed digest (per ``algo``) is appended after the packet; ``seqno``
    provides replay protection (non-decreasing per neighbor).
    """

    type: AuthType = AuthType.NULL
    key: bytes = b""
    key_id: int = 1
    seqno: int = 0
    algo: str = "md5"
    # Lifetime-based key selection (reference holo-utils/src/keychain.rs
    # :42-92): when set, the active SEND key signs outgoing packets and
    # received key ids validate against their ACCEPT lifetimes — this is
    # what makes key rollover work.  ``clock`` supplies epoch seconds
    # (the owning loop's clock; virtual in tests).
    keychain: object = None
    clock: object = None

    def _now(self) -> float:
        if callable(self.clock):
            return self.clock()
        import time as _time

        return _time.time()

    def _send_key(self):
        if self.keychain is None:
            return None
        return self.keychain.key_lookup_send(self._now())

    def accept_params(self, key_id: int) -> "tuple[bytes, str] | None":
        """(key, algo) accepted for a received packet carrying
        ``key_id`` — None rejects (keychain.rs key_lookup_accept)."""
        if self.keychain is None:
            if key_id != self.key_id:
                return None
            return self.key, self.algo
        # Masked compare: the OSPFv2 key id is u8 on the wire and
        # tx_key_id masks — the accept side must match the same way.
        k = self.keychain.key_lookup_accept(key_id, self._now(), mask=0xFF)
        if k is None:
            return None
        return k.string, k.algo

    @property
    def tx_key_id(self) -> int:
        k = self._send_key()
        return (k.id & 0xFF) if k is not None else self.key_id

    def resolve_send(self) -> "AuthCtx | None":
        """Fixed-key context for ONE outgoing packet: key id, digest
        length, packet digest, and LLS digest must all come from the
        SAME key, so the keychain is consulted exactly once per encode.
        None when the keychain has no active send key — the packet goes
        out unauthenticated, like the reference's get_key_send → None
        (the peer's type check rejects it, which is the correct signal
        for a lifetime coverage gap, not a forged-looking digest)."""
        if self.keychain is None:
            return self
        k = self.keychain.key_lookup_send(self._now())
        if k is None:
            return None
        return AuthCtx(
            self.type, k.string, k.id & 0xFF, self.seqno, k.algo
        )

    def resolve_accept(self, key_id: int) -> "AuthCtx | None":
        """Fixed-key context for verifying ONE received packet (same
        single-consultation rule on the accept side)."""
        params = self.accept_params(key_id)
        if params is None:
            return None
        key, algo = params
        return AuthCtx(self.type, key, key_id, self.seqno, algo)

    @staticmethod
    def make_digest(key: bytes, algo: str, data: bytes) -> bytes:
        dlen, hname = AUTH_ALGOS[algo]
        if hname is None:  # RFC 2328 keyed-MD5: md5(packet || padded key)
            return hashlib.md5(data + key[:16].ljust(16, b"\x00")).digest()
        return _hmac.new(key, data, hname).digest()

    def digest(self, data: bytes) -> bytes:
        """Sign with this context's key.  Keychain contexts are resolved
        to a fixed key via resolve_send/resolve_accept BEFORE any digest
        is computed (one consultation per packet); the dynamic fallback
        here covers direct callers only."""
        k = self._send_key()
        key, algo = (k.string, k.algo) if k is not None else (
            self.key, self.algo
        )
        return self.make_digest(key, algo, data)

    @property
    def digest_len(self) -> int:
        k = self._send_key()
        return AUTH_ALGOS[k.algo if k is not None else self.algo][0]


# LLS Extended Options and Flags bits (RFC 5613 / lls.rs:115-125).
LLS_EOF_LR = 0x00000001  # LSDB resynchronization (RFC 4811)
LLS_EOF_RS = 0x00000002  # restart signal (RFC 4812)


@dataclass
class LlsBlock:
    """RFC 5613 link-local signaling data block, appended after the
    OSPF packet (reference holo-ospf/src/packet/lls.rs).

    Carried on Hello/DbDesc packets whose options set the L bit; the
    Extended Options and Flags TLV transports the LR (out-of-band LSDB
    resync capability) and RS (restart signal) bits.
    """

    eof: int | None = None  # LLS_EOF_* bits

    def encode(self, auth: "AuthCtx | None" = None) -> bytes:
        crypto = auth is not None and auth.type == AuthType.CRYPTOGRAPHIC
        w = Writer()
        w.u16(0)  # checksum (0 under cryptographic auth, §2.2)
        len_pos = len(w)
        w.u16(0)  # block length in 32-bit words (incl. header)
        if self.eof is not None:
            w.u16(1).u16(4).u32(self.eof)  # Extended Options TLV
        if crypto:
            # §2.5 Cryptographic Authentication TLV: MUST be last; the
            # digest covers the block with the length field final
            # (ospfv2/packet/lls.rs:88-120).
            dlen = auth.digest_len
            w.u16(2).u16(4 + dlen).u32(auth.seqno & 0xFFFFFFFF)
            digest_start = len(w)
            w.zeros(dlen)
            w.patch_u16(len_pos, len(w) // 4)
            out = bytearray(w.finish())
            digest = auth.digest(bytes(out[:digest_start]))
            out[digest_start:] = digest
            return bytes(out)
        w.patch_u16(len_pos, len(w) // 4)
        out = bytearray(w.finish())
        cks = ip_checksum(bytes(out))
        out[0:2] = cks.to_bytes(2, "big")
        return bytes(out)

    @classmethod
    def decode(
        cls, data: bytes, auth: "AuthCtx | None" = None
    ) -> "LlsBlock":
        """``auth`` is already key-resolved by Packet.decode (the LLS
        digest must verify with the SAME accept key as the packet)."""
        crypto = auth is not None and auth.type == AuthType.CRYPTOGRAPHIC
        if len(data) < 4:
            raise DecodeError("short LLS block")
        words = int.from_bytes(data[2:4], "big")
        blen = words * 4
        if blen < 4 or blen > len(data):
            raise DecodeError("bad LLS length")
        if not crypto and ip_checksum(data[:blen]) != 0:
            raise DecodeError("LLS checksum mismatch")
        r = Reader(data, 4, blen)
        out = cls()
        ca_verified = False
        while r.remaining() >= 4:
            tlv_start = 4 + (r.pos - 4)
            ttype = r.u16()
            tlen = r.u16()
            if tlen > r.remaining():
                raise DecodeError("bad LLS TLV length")
            body = r.sub(tlen)
            # TLVs are padded to 32-bit alignment.
            pad = (-tlen) % 4
            if pad and r.remaining() >= pad:
                r.bytes(pad)
            if ttype == 1:
                if tlen != 4:
                    raise DecodeError("bad LLS EOF TLV length")
                out.eof = body.u32()
            elif ttype == 2 and crypto:
                # CA TLV digest covers the block up to the digest field.
                body.u32()  # seqno (replay handled at the packet layer)
                dlen = tlen - 4
                if dlen != auth.digest_len:
                    raise DecodeError("bad LLS CA digest length")
                digest_off = tlv_start + 8
                want = auth.digest(data[:digest_off])
                got = data[digest_off : digest_off + dlen]
                if not _hmac.compare_digest(want, got):
                    raise DecodeError("LLS CA digest mismatch")
                ca_verified = True
            # Other unknown LLS TLVs are skipped.
        if crypto and not ca_verified:
            raise DecodeError("missing LLS CA TLV under crypto auth")
        return out


@dataclass
class Packet:
    """OSPFv2 packet: 24-byte header + typed body (RFC 2328 §A.3.1) +
    optional LLS data block (RFC 5613) when the body options set L."""

    router_id: IPv4Address
    area_id: IPv4Address
    body: object
    # auth_type/auth_data/auth_seqno are DECODE OUTPUTS (what the wire
    # carried); encode() authenticates solely from its ``auth`` argument.
    auth_type: AuthType = AuthType.NULL
    auth_data: bytes = bytes(8)
    auth_seqno: int = 0
    lls: LlsBlock | None = None

    def encode(self, auth: AuthCtx | None = None) -> bytes:
        auth = auth or AuthCtx()
        if auth.type == AuthType.CRYPTOGRAPHIC:
            # One keychain consultation per packet: key id, digest
            # length, and both digests must agree (resolve_send).
            auth = auth.resolve_send() or AuthCtx()
        w = Writer()
        w.u8(OSPF_VERSION).u8(int(self.body.TYPE)).u16(0)
        w.ipv4(self.router_id).ipv4(self.area_id)
        w.u16(0)  # checksum
        w.u16(int(auth.type))
        w.zeros(8)
        self.body.encode_body(w)
        w.patch_u16(2, len(w))
        if auth.type == AuthType.CRYPTOGRAPHIC:
            # Appendix D.4.3: checksum not computed; auth field carries
            # (0, key id, digest length, seqno); digest appended.
            w.patch_bytes(
                16,
                bytes((0, 0, auth.tx_key_id, auth.digest_len))
                + (auth.seqno & 0xFFFFFFFF).to_bytes(4, "big"),
            )
            w.bytes(auth.digest(bytes(w.buf)))
            out = w.finish()
            if self.lls is not None:
                out += self.lls.encode(auth=auth)
            return out
        cks = ip_checksum(bytes(w.buf[:16]) + bytes(w.buf[24:]))
        w.patch_u16(12, cks)
        if auth.type == AuthType.SIMPLE:
            w.patch_bytes(16, auth.key[:8].ljust(8, b"\x00"))
        out = w.finish()
        if self.lls is not None:
            out += self.lls.encode()
        return out

    @classmethod
    def decode(cls, data: bytes, auth: AuthCtx | None = None) -> "Packet":
        """Decode + authenticate.  ``auth`` is the receiving interface's
        configured context; a type/credential mismatch raises DecodeError
        (the reference drops such packets with an auth error counter)."""
        r = Reader(data)
        if r.remaining() < PKT_HDR_LEN:
            raise DecodeError("short packet")
        version = r.u8()
        if version != OSPF_VERSION:
            raise DecodeError(f"bad version {version}")
        try:
            ptype = PacketType(r.u8())
        except ValueError as e:
            raise DecodeError("unknown packet type") from e
        length = r.u16()
        if length < PKT_HDR_LEN or length > len(data):
            raise DecodeError("bad packet length")
        router_id, area_id = r.ipv4(), r.ipv4()
        r.u16()  # checksum (verified below)
        try:
            auth_type = AuthType(r.u16())
        except ValueError as e:
            raise DecodeError("unknown auth type") from e
        auth_data = r.bytes(8)
        expected = auth.type if auth is not None else AuthType.NULL
        if auth_type != expected:
            raise DecodeError(f"auth type mismatch: got {auth_type}")
        seqno = 0
        dlen = 0
        if auth_type == AuthType.CRYPTOGRAPHIC:
            rx_key_id = auth_data[2]
            dlen = auth_data[3]
            seqno = int.from_bytes(auth_data[4:8], "big")
            # Accept-side key selection, resolved ONCE for the whole
            # packet (incl. the LLS block below): the received key id
            # must name a key whose ACCEPT lifetime is active
            # (keychain.rs key_lookup_accept); fixed-key contexts only
            # accept their own id.
            eff = auth.resolve_accept(rx_key_id)
            if eff is None or eff.digest_len != dlen:
                raise DecodeError("bad crypto auth parameters")
            auth = eff
            if len(data) < length + dlen:
                raise DecodeError("missing auth digest")
            digest = auth.digest(data[:length])
            if not _hmac.compare_digest(digest, data[length : length + dlen]):
                raise DecodeError("auth digest mismatch")
        else:
            if auth_type == AuthType.SIMPLE:
                want = (auth.key[:8] if auth else b"").ljust(8, b"\x00")
                if not _hmac.compare_digest(auth_data, want):
                    raise DecodeError("bad simple password")
            if ip_checksum(data[:16] + data[24:length]) != 0:
                raise DecodeError("packet checksum mismatch")
        body = _PKT_CODECS[ptype].decode_body(Reader(data, PKT_HDR_LEN, length))
        lls = None
        if Options.L & getattr(body, "options", 0):
            crypto = auth_type == AuthType.CRYPTOGRAPHIC
            off = length + (dlen if crypto else 0)
            if len(data) > off:
                # auth was rebound to the resolved accept key above —
                # the LLS digest verifies with the SAME key.
                lls = LlsBlock.decode(data[off:], auth=auth)
        return cls(
            router_id, area_id, body, auth_type, auth_data, seqno, lls
        )
