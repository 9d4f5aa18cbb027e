"""BIER (RFC 8279/8401/9089): bitstrings, config, and table math.

Reference: holo-utils/src/bier.rs — sub-domain configuration, the
BfrId -> (set-identifier, bitstring) mapping, and the BIFT's Forwarding
Bit Mask computation (OR of all bitstrings reachable through the same
BFR neighbor), plus holo-routing/src/birt.rs for the BIRT itself.

The F-BM aggregation is the same atom-bitmask union shape the device SPF
engine uses for ECMP next-hop sets (ops/spf_engine.py).  The port's copy
of ``holo_tpu.utils.bier``; the OSPFv2 instance imports it lazily.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from ipaddress import IPv4Address

# Valid bitstring lengths (RFC 8296 §2.1.2): 64 << k for k in 0..6.
VALID_BSL = (64, 128, 256, 512, 1024, 2048, 4096)


class BierError(Exception):
    pass


@dataclass(frozen=True)
class Bitstring:
    """One (set-identifier, bitstring) pair for a BFR-id at a given BSL
    (bier.rs Bitstring::from)."""

    si: int
    bits: int  # the bitstring as an int, bit (bfr_id-1) % bsl set
    bsl: int

    @classmethod
    def from_bfr_id(cls, bfr_id: int, bsl: int) -> "Bitstring":
        if bsl not in VALID_BSL:
            raise BierError(f"invalid bitstring length {bsl}")
        if bfr_id == 0:
            raise BierError("invalid BfrId")
        si, offset = divmod(bfr_id - 1, bsl)
        return cls(si=si, bits=1 << offset, bsl=bsl)

    def union(self, other: "Bitstring") -> "Bitstring":
        if (self.si, self.bsl) != (other.si, other.bsl):
            raise BierError("bitstring si/bsl mismatch")
        return Bitstring(self.si, self.bits | other.bits, self.bsl)


@dataclass
class BierSubDomainCfg:
    """ietf-bier sub-domain config (bier.rs:179-193)."""

    sd_id: int
    bfr_id: int  # our own id in this sub-domain
    bfr_prefix: object = None  # IPv4Network /32
    bsl: int = 64
    underlay: str = "ospf"
    encaps: tuple = (64,)  # advertised bitstring lengths


@dataclass
class BierCfg:
    sub_domains: dict = field(default_factory=dict)  # (sd_id) -> cfg

    def enabled(self) -> bool:
        return bool(self.sub_domains)


@dataclass(frozen=True)
class BierInfo:
    """Per-prefix BIER advertisement data (bier.rs:132-136)."""

    sd_id: int
    bfr_id: int
    bfr_bss: tuple  # advertised bitstring lengths


@dataclass
class BirtEntry:
    """(sub-domain, bfr-id, bsl) -> next hop toward that BFER
    (bier.rs:139-144)."""

    bfr_prefix: IPv4Address
    bfr_nbr: IPv4Address
    ifindex: int | None = None
    ifname: str | None = None


class Birt:
    """BIER routing table + BIFT derivation (birt.rs:18-124)."""

    def __init__(self, bift_sync=None):
        self.entries: dict[tuple, BirtEntry] = {}  # (sd, bfr_id, bsl)
        self.bift_sync = bift_sync or (lambda bift: None)

    def nbr_add(
        self,
        sd_id: int,
        bfr_id: int,
        bfr_prefix: IPv4Address,
        bsls,
        nexthop: IPv4Address,
        ifindex: int | None = None,
        ifname: str | None = None,
    ) -> None:
        for bsl in bsls:
            self.entries[(sd_id, bfr_id, bsl)] = BirtEntry(
                bfr_prefix=bfr_prefix,
                bfr_nbr=nexthop,
                ifindex=ifindex,
                ifname=ifname,
            )
        self.recompute()

    def nbr_del(self, sd_id: int, bfr_id: int, bsl: int) -> None:
        self.entries.pop((sd_id, bfr_id, bsl), None)
        self.recompute()

    def compute_bift(self) -> dict:
        """F-BM computation: all BFERs reached through the same neighbor
        share one forwarding bitmask (birt.rs:64-114).

        Returns {(sd_id, nbr, si, bsl): (Bitstring, [(bfr_id, prefix)],
        ifname)}.
        """
        bift: dict[tuple, tuple] = {}
        for (sd_id, bfr_id, bsl), e in sorted(self.entries.items()):
            bs = Bitstring.from_bfr_id(bfr_id, bsl)
            key = (sd_id, e.bfr_nbr, bs.si, bsl)
            if key in bift:
                fbm, bfrs, ifname = bift[key]
                bift[key] = (
                    fbm.union(bs),
                    bfrs + [(bfr_id, e.bfr_prefix)],
                    ifname,
                )
            else:
                bift[key] = (bs, [(bfr_id, e.bfr_prefix)], e.ifname)
        return bift

    def recompute(self) -> None:
        self.bift_sync(self.compute_bift())
