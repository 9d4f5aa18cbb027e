"""Authentication keychains with send/accept lifetimes.

Reference: holo-utils/src/keychain.rs:42-92 — keys carry independent
send and accept lifetimes; ``key_lookup_send`` picks the first key
(ascending id) whose send lifetime is active, ``key_lookup_accept``
validates a received key id against its accept lifetime, and
``key_lookup_accept_any`` serves auth TLVs that carry no key id
(IS-IS RFC 5304).  This is what makes key rollover work: during the
overlap window the old key is still accepted while the new one is
already (or not yet) used for sending.

Times are epoch seconds on whatever clock the owner supplies (the
daemon's loop clock — virtual in tests — keeps rollover deterministic).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime, timezone


def _parse_time(val) -> float | None:
    """YANG date-and-time (or epoch number) -> epoch seconds.

    FAIL-CLOSED: a malformed date-time raises instead of silently
    becoming an unbounded lifetime — a key that was supposed to expire
    must never stay active because of a typo.  The keychain provider
    surfaces the error at commit validation time."""
    if val is None:
        return None
    if isinstance(val, (int, float)):
        return float(val)
    s = str(val)
    if s in ("always", ""):
        return None
    try:
        return float(s)  # epoch seconds (string-typed YANG leaves)
    except ValueError:
        pass
    try:
        dt = datetime.fromisoformat(s.replace("Z", "+00:00"))
    except ValueError as e:
        raise ValueError(f"invalid lifetime date-and-time {s!r}") from e
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt.timestamp()


@dataclass
class KeyLifetime:
    """Validity window; ``None`` bounds mean -inf / +inf
    (keychain.rs KeyLifetime — the default is always-active)."""

    start: float | None = None
    end: float | None = None

    def is_active(self, now: float) -> bool:
        if self.start is not None and now < self.start:
            return False
        if self.end is not None and now >= self.end:
            return False
        return True


@dataclass
class Key:
    """One keychain entry (keychain.rs Key + KeychainKey)."""

    id: int
    algo: str
    string: bytes
    send_lifetime: KeyLifetime = field(default_factory=KeyLifetime)
    accept_lifetime: KeyLifetime = field(default_factory=KeyLifetime)


class Keychain:
    """Named, ordered key set with lifetime-based lookup."""

    def __init__(self, name: str, keys: list[Key] | None = None):
        self.name = name
        # Ascending key id — the reference's BTreeMap iteration order
        # makes "first active" deterministic.
        self.keys: list[Key] = sorted(keys or [], key=lambda k: k.id)

    def key_lookup_send(self, now: float) -> Key | None:
        """First key with an active send lifetime (keychain.rs:76-82)."""
        for key in self.keys:
            if key.send_lifetime.is_active(now):
                return key
        return None

    def key_lookup_accept(
        self, key_id: int, now: float, mask: int | None = None
    ) -> Key | None:
        """The accept-active key matching this id (keychain.rs:84-92).

        ``mask`` compares MASKED ids: protocols carry narrower id fields
        on the wire (RIP u8, OSPFv3/IS-IS u16) and the sender masks at
        encode time — the accept side must compare the same way or key
        ids above the field width never authenticate."""
        for key in self.keys:
            kid = key.id if mask is None else key.id & mask
            if kid == key_id and key.accept_lifetime.is_active(now):
                return key
        return None

    def key_lookup_accept_any(self, now: float) -> Key | None:
        """First key with an active accept lifetime — for auth formats
        without a key id on the wire (keychain.rs key_lookup_accept_any,
        IS-IS RFC 5304 HMAC-MD5)."""
        for key in self.keys:
            if key.accept_lifetime.is_active(now):
                return key
        return None

    @classmethod
    def from_config(cls, name: str, conf: dict) -> "Keychain":
        """Build from the ietf-key-chain-shaped config subtree:
        ``key`` map of key-id -> {key-string, crypto-algorithm,
        lifetime/send-accept-lifetime/{start-date-time,end-date-time} |
        send-lifetime/... , accept-lifetime/...}."""
        keys = []
        for key_id_s, kconf in (conf.get("key") or {}).items():
            kid = int(kconf.get("key-id", key_id_s))
            algo = kconf.get("crypto-algorithm", "md5")
            string = (kconf.get("key-string") or "").encode()

            def _lifetime(sub) -> KeyLifetime:
                if not sub:
                    return KeyLifetime()
                return KeyLifetime(
                    start=_parse_time(sub.get("start-date-time")),
                    end=_parse_time(sub.get("end-date-time")),
                )

            lt = kconf.get("lifetime") or {}
            shared = lt.get("send-accept-lifetime")
            if shared:
                send = accept = _lifetime(shared)
            else:
                send = _lifetime(kconf.get("send-lifetime"))
                accept = _lifetime(kconf.get("accept-lifetime"))
            keys.append(
                Key(
                    id=kid,
                    algo=algo,
                    string=string,
                    send_lifetime=send,
                    accept_lifetime=accept,
                )
            )
        return cls(name, keys)
