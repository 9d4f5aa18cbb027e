"""LSDB: link-state database with install/originate/flush and aging.

Reference: holo-ospf/src/lsdb.rs (install :397-489, originate :518, flush
:665).  LSAs are stored per scope (area / AS) keyed by (type, lsid, adv_rtr);
install performs the RFC 2328 §13.2 content-change check that drives SPF
scheduling, and origination handles sequence numbers, MinLSInterval batching
and refresh.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from ipaddress import IPv4Address

from holo_tpu_torch.protocols.ospf.packet import (
    INITIAL_SEQ_NO,
    LS_REFRESH_TIME,
    MAX_AGE,
    MAX_SEQ_NO,
    Lsa,
    LsaKey,
)

MIN_LS_INTERVAL = 5.0  # §12.4: min seconds between originations of same LSA
MIN_LS_ARRIVAL = 1.0  # §13 (5)(a): min seconds between accepting copies


@dataclass
class LsaEntry:
    lsa: Lsa
    installed_at: float  # loop-clock time of install (for age computation)
    rcvd_time: float = 0.0
    # Origination bookkeeping for self-originated LSAs:
    last_originated: float | None = None

    def current_age(self, now: float) -> int:
        return min(int(self.lsa.age + (now - self.installed_at)), MAX_AGE)


@dataclass
class Lsdb:
    """One LSA scope (an area's LSDB, or the AS-scope external LSDB)."""

    entries: dict[LsaKey, LsaEntry] = field(default_factory=dict)
    # Pending (delayed) originations blocked by MinLSInterval.
    pending: dict[LsaKey, Lsa] = field(default_factory=dict)

    def get(self, key: LsaKey) -> LsaEntry | None:
        return self.entries.get(key)

    def all(self):
        return self.entries.values()

    def install(self, lsa: Lsa, now: float) -> tuple[LsaEntry, bool]:
        """Install (replacing any old copy).  Returns (entry, content_changed).

        content_changed implements the §13.2 comparison: options/body bytes
        differ, or MaxAge transition — the trigger condition for SPF
        (lsdb.rs:457-469).
        """
        old = self.entries.get(lsa.key)
        changed = True
        if old is not None:
            old_lsa = old.lsa
            changed = (
                old_lsa.options != lsa.options
                or old_lsa.is_maxage != lsa.is_maxage
                or old_lsa.raw[LsaBodyOffset:] != lsa.raw[LsaBodyOffset:]
            )
        entry = LsaEntry(lsa=lsa, installed_at=now, rcvd_time=now)
        if old is not None:
            entry.last_originated = old.last_originated
        self.entries[lsa.key] = entry
        return entry, changed

    def remove(self, key: LsaKey) -> None:
        self.entries.pop(key, None)

    def maxage_keys(self, now: float) -> list[LsaKey]:
        return [
            k for k, e in self.entries.items() if e.current_age(now) >= MAX_AGE
        ]

    def refresh_due(self, now: float, self_rid: IPv4Address) -> list[LsaEntry]:
        return [
            e
            for e in self.entries.values()
            if e.lsa.adv_rtr == self_rid
            and not e.lsa.is_maxage
            and e.current_age(now) >= LS_REFRESH_TIME
        ]


LsaBodyOffset = 20  # compare body beyond the 20-byte header (age/seq differ)


def next_seq_no(old: Lsa | None) -> int:
    if old is None:
        return INITIAL_SEQ_NO
    if old.seq_no >= MAX_SEQ_NO:
        # Sequence wrap requires premature aging first (§12.1.6); callers
        # flush then re-originate at INITIAL_SEQ_NO.
        return INITIAL_SEQ_NO
    return old.seq_no + 1
