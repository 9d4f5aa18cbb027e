"""BFD (RFC 5880/5881/5883): asynchronous-mode session FSM.

Reference: holo-bfd (SURVEY.md §2.3) — session table keyed by peer,
clients (OSPF/IS-IS/BGP) register over the ibus and receive state-change
notifications to kill adjacencies fast (§3.5 of SURVEY.md).

Scope parity with the reference plus extras:
- single-hop (RFC 5881) and multihop (RFC 5883) sessions — key tuples
  ``(ifname, dst)`` and ``("mh", src, dst)`` mirror the reference's
  SessionKey::IpSingleHop/IpMultihop (holo-utils/src/bfd.rs:29-31);
- the authentication section (RFC 5880 §4.2-4.4): the reference only
  parses and length-validates it (holo-bfd/src/packet.rs:188-231); here
  simple-password comparison and keyed MD5/SHA1 digest computation +
  verification with sequence-number windows are implemented as well;
- the echo function (RFC 5880 §6.4): echo packets loop back through the
  peer's forwarding plane; a missed echo window drops the session with
  diagnostic EchoFailed.
"""

from __future__ import annotations

import enum
import hashlib
import hmac
from dataclasses import dataclass, field
from ipaddress import IPv4Address

from holo_tpu_torch import telemetry
from holo_tpu_torch.utils.bytesbuf import DecodeError, Reader, Writer
from holo_tpu_torch.utils.ibus import TOPIC_BFD_STATE, BfdSessionReg, BfdSessionUnreg, BfdStateUpd, Ibus, IbusMsg
from holo_tpu_torch.utils.netio import NetIo, NetRxPacket
from holo_tpu_torch.utils.runtime import Actor

# Session FSM + wire observability.  A "flap" is the monitored failure
# event (UP -> DOWN): it is what triggers the RIB's FRR local repair,
# so its count joins directly against holo_rib_backup_flips_total.
_BFD_TRANSITIONS = telemetry.counter(
    "holo_bfd_transitions_total", "BFD session state transitions", ("to",)
)
_BFD_FLAPS = telemetry.counter(
    "holo_bfd_flaps_total", "BFD sessions dropping from UP to DOWN"
)
_BFD_PACKETS = telemetry.counter(
    "holo_bfd_packets_total", "BFD control packets", ("dir",)
)


class BfdState(enum.IntEnum):
    ADMIN_DOWN = 0
    DOWN = 1
    INIT = 2
    UP = 3


class BfdDiag(enum.IntEnum):
    NONE = 0
    TIME_EXPIRED = 1
    ECHO_FAILED = 2
    NEIGHBOR_DOWN = 3
    FWD_PLANE_RESET = 4
    PATH_DOWN = 5
    CONCAT_DOWN = 6
    ADMIN_DOWN = 7
    REVERSE_CONCAT_DOWN = 8


class BfdAuthType(enum.IntEnum):
    """RFC 5880 §4.1 Auth Type (holo-bfd/src/packet.rs:74-82)."""

    SIMPLE_PASSWORD = 1
    KEYED_MD5 = 2
    METICULOUS_KEYED_MD5 = 3
    KEYED_SHA1 = 4
    METICULOUS_KEYED_SHA1 = 5


_AUTH_DIGEST_LEN = {
    BfdAuthType.KEYED_MD5: (24, 16, "md5"),
    BfdAuthType.METICULOUS_KEYED_MD5: (24, 16, "md5"),
    BfdAuthType.KEYED_SHA1: (28, 20, "sha1"),
    BfdAuthType.METICULOUS_KEYED_SHA1: (28, 20, "sha1"),
}


@dataclass
class BfdAuth:
    """Authentication section (RFC 5880 §4.2-4.4)."""

    auth_type: BfdAuthType
    key_id: int = 0
    password: bytes = b""  # simple-password payload
    seq: int = 0  # keyed types: sequence number
    digest: bytes = b""  # keyed types: as decoded from the wire


@dataclass
class BfdPacket:
    """RFC 5880 §4.1 mandatory section + optional auth section."""

    state: BfdState
    diag: BfdDiag = BfdDiag.NONE
    poll: bool = False
    final: bool = False
    detect_mult: int = 3
    my_discr: int = 0
    your_discr: int = 0
    desired_min_tx: int = 1_000_000  # microseconds
    required_min_rx: int = 1_000_000
    required_min_echo_rx: int = 0
    auth: BfdAuth | None = None

    def encode(self, auth_key: bytes | None = None) -> bytes:
        w = Writer()
        w.u8((1 << 5) | int(self.diag))  # version 1
        flags = (int(self.state) << 6) | (0x20 if self.poll else 0) | (
            0x10 if self.final else 0
        )
        if self.auth is not None:
            flags |= 0x04  # A bit
        w.u8(flags)
        w.u8(self.detect_mult)
        len_pos = len(w)
        w.u8(24)  # patched below when an auth section follows
        w.u32(self.my_discr).u32(self.your_discr)
        w.u32(self.desired_min_tx).u32(self.required_min_rx)
        w.u32(self.required_min_echo_rx)
        if self.auth is not None:
            a = self.auth
            if a.auth_type == BfdAuthType.SIMPLE_PASSWORD:
                pw = a.password or (auth_key or b"")
                if not 1 <= len(pw) <= 16:
                    raise ValueError(
                        "BFD simple password must be 1-16 bytes"
                    )
                w.u8(a.auth_type).u8(3 + len(pw)).u8(a.key_id)
                w.bytes(pw)
            else:
                auth_len, dlen, algo = _AUTH_DIGEST_LEN[a.auth_type]
                w.u8(a.auth_type).u8(auth_len).u8(a.key_id).u8(0)
                w.u32(a.seq)
                digest_pos = len(w)
                w.zeros(dlen)
                buf = bytearray(w.finish())
                buf[len_pos] = 24 + auth_len
                # Digest over the whole packet with the key in place of
                # the digest field (RFC 5880 §6.7.3/6.7.4).
                key = (auth_key or b"")[:dlen].ljust(dlen, b"\x00")
                buf[digest_pos : digest_pos + dlen] = key
                digest = hashlib.new(algo, bytes(buf)).digest()
                buf[digest_pos : digest_pos + dlen] = digest
                return bytes(buf)
            buf = bytearray(w.finish())
            buf[len_pos] = len(buf)
            return bytes(buf)
        return w.finish()

    @classmethod
    def decode(cls, data: bytes) -> "BfdPacket":
        r = Reader(data)
        vd = r.u8()
        if vd >> 5 != 1:
            raise DecodeError("bad BFD version")
        flags = r.u8()
        mult = r.u8()
        length = r.u8()
        if length < 24 or length > len(data):
            raise DecodeError("bad BFD length")
        my, your = r.u32(), r.u32()
        tx, rx, erx = r.u32(), r.u32(), r.u32()
        if mult == 0 or my == 0:
            raise DecodeError("invalid BFD fields")
        auth = None
        if flags & 0x04:
            # Auth section present; length checks mirror the reference
            # (holo-bfd/src/packet.rs:188-231).
            if r.remaining() < 2:
                raise DecodeError("truncated BFD auth section")
            atype_raw = r.u8()
            alen = r.u8()
            if alen + 24 > length:
                raise DecodeError("bad BFD auth length")
            try:
                atype = BfdAuthType(atype_raw)
            except ValueError as e:
                raise DecodeError("bad BFD auth type") from e
            if atype == BfdAuthType.SIMPLE_PASSWORD:
                if alen < 4 or alen > 19:
                    raise DecodeError("bad BFD auth length")
                key_id = r.u8()
                auth = BfdAuth(
                    atype, key_id=key_id, password=r.bytes(alen - 3)
                )
            else:
                want_len, dlen, _algo = _AUTH_DIGEST_LEN[atype]
                if alen != want_len:
                    raise DecodeError("bad BFD auth length")
                key_id = r.u8()
                r.u8()  # reserved
                seq = r.u32()
                auth = BfdAuth(
                    atype, key_id=key_id, seq=seq, digest=r.bytes(dlen)
                )
        try:
            diag = BfdDiag(vd & 0x1F)
        except ValueError:
            diag = BfdDiag.NONE  # reserved diag codes: accept, ignore diag
        return cls(
            state=BfdState((flags >> 6) & 0x3),
            diag=diag,
            poll=bool(flags & 0x20),
            final=bool(flags & 0x10),
            detect_mult=mult,
            my_discr=my,
            your_discr=your,
            desired_min_tx=tx,
            required_min_rx=rx,
            required_min_echo_rx=erx,
            auth=auth,
        )

    def verify_auth(self, raw: bytes, key: bytes) -> bool:
        """Verify the packet's auth section against ``key`` (RFC 5880
        §6.7; digest verification goes beyond the reference's
        parse-only handling)."""
        a = self.auth
        if a is None:
            return False
        if a.auth_type == BfdAuthType.SIMPLE_PASSWORD:
            return hmac.compare_digest(a.password or b"", key)
        _len, dlen, algo = _AUTH_DIGEST_LEN[a.auth_type]
        # The digest sits at (declared length - dlen): derive it from the
        # packet's own length field (byte 3), not the datagram size —
        # trailing bytes in the datagram must not shift the digest window.
        declared = raw[3] if len(raw) > 3 else len(raw)
        if declared < 24 + 8 + dlen or declared > len(raw):
            return False
        buf = bytearray(raw[:declared])
        digest_pos = declared - dlen
        buf[digest_pos:] = key[:dlen].ljust(dlen, b"\x00")
        return hmac.compare_digest(
            hashlib.new(algo, bytes(buf)).digest(), a.digest
        )


@dataclass
class TxTimerMsg:
    key: tuple


@dataclass
class DetectTimerMsg:
    key: tuple


@dataclass
class EchoTxTimerMsg:
    key: tuple


@dataclass
class EchoDetectTimerMsg:
    key: tuple


# Echo packet format is sender-local per RFC 5880 §6.4; ours is a magic
# marker + the session's local discriminator.
ECHO_MAGIC = b"\xbf\xdeECHO"


@dataclass
class Session:
    key: tuple  # (ifname, dst) single-hop | ("mh", src, dst) multihop
    local_discr: int
    state: BfdState = BfdState.DOWN
    remote_discr: int = 0
    remote_min_rx: int = 1_000_000
    remote_min_tx: int = 1_000_000
    remote_detect_mult: int = 3
    remote_state: BfdState = BfdState.DOWN
    remote_min_echo_rx: int = 0
    desired_min_tx: int = 1_000_000
    required_min_rx: int = 1_000_000
    required_min_echo_rx: int = 0
    detect_mult: int = 3
    diag: BfdDiag = BfdDiag.NONE
    clients: set = field(default_factory=set)
    # Authentication (RFC 5880 §6.7); None = no auth on this session.
    auth_type: BfdAuthType | None = None
    auth_key: bytes = b""
    auth_key_id: int = 0
    _tx_seq: int = 0
    _last_rx_seq: int | None = None
    # Echo function (RFC 5880 §6.4).
    echo_interval: float | None = None  # seconds; None = echo disabled

    def is_multihop(self) -> bool:
        return self.key[0] == "mh"

    def peer_addr(self):
        return self.key[2] if self.is_multihop() else self.key[1]


class BfdInstance(Actor):
    """BFD master actor: one session table for all interfaces/peers.

    Spawned at daemon startup inside the routing provider, like the
    reference (holo-routing/src/lib.rs:261-281).
    """

    name = "bfd"

    def __init__(self, netio: NetIo, ibus: Ibus | None = None, slow_tx: float = 1.0,
                 notif_cb=None):
        self.netio = netio
        self.ibus = ibus
        self.notif_cb = notif_cb  # YANG notifications (ietf-bfd-ip-sh/mh)
        self.sessions: dict[tuple, Session] = {}
        self._next_discr = 1
        self.slow_tx = slow_tx  # tx interval until session is UP (seconds)

    # -- lifecycle

    def session_key(self, ifname: str, peer: IPv4Address) -> tuple:
        """Single-hop key (reference SessionKey::IpSingleHop)."""
        return (ifname, peer)

    @staticmethod
    def session_key_mh(src: IPv4Address, dst: IPv4Address) -> tuple:
        """Multihop key, RFC 5883 (reference SessionKey::IpMultihop)."""
        return ("mh", src, dst)

    def configure_auth(
        self,
        key: tuple,
        auth_type: BfdAuthType,
        auth_key: bytes,
        key_id: int = 1,
    ) -> None:
        s = self.sessions.get(key)
        if s is None:
            raise KeyError(f"no BFD session for {key}")
        s.auth_type = auth_type
        s.auth_key = auth_key
        s.auth_key_id = key_id

    def enable_echo(self, key: tuple, interval: float = 0.05) -> None:
        """Start the echo function on an up session (RFC 5880 §6.4);
        echo packets are only sent while the peer advertises a nonzero
        Required Min Echo RX."""
        s = self.sessions.get(key)
        if s is None or s.is_multihop():
            return  # echo is single-hop only (RFC 5883 §5)
        s.echo_interval = interval
        s.required_min_echo_rx = int(interval * 1e6)
        self._arm_echo_tx(s)

    def register(self, key: tuple, client: str, local: IPv4Address) -> Session:
        s = self.sessions.get(key)
        if s is None:
            s = Session(key=key, local_discr=self._next_discr)
            self._next_discr += 1
            s.local = local
            self.sessions[key] = s
            self._arm_tx(s, self.slow_tx)
        elif local is not None:
            s.local = local
        s.clients.add(client)
        return s

    def unregister(self, key: tuple, client: str) -> None:
        s = self.sessions.get(key)
        if s is None:
            return
        s.clients.discard(client)
        if not s.clients:
            for attr in ("_tx_timer", "_detect_timer", "_echo_tx_timer",
                         "_echo_detect_timer"):
                t = getattr(s, attr, None)
                if t is not None:
                    t.cancel()
            del self.sessions[key]

    # -- actor

    def handle(self, msg):
        if isinstance(msg, NetRxPacket):
            self._rx(msg)
        elif isinstance(msg, TxTimerMsg):
            s = self.sessions.get(msg.key)
            if s is not None:
                self._send(s)
                self._arm_tx(s, self._tx_interval(s))
        elif isinstance(msg, DetectTimerMsg):
            s = self.sessions.get(msg.key)
            if s is not None and s.state in (BfdState.INIT, BfdState.UP):
                self._transition(s, BfdState.DOWN, BfdDiag.TIME_EXPIRED)
        elif isinstance(msg, EchoTxTimerMsg):
            s = self.sessions.get(msg.key)
            if s is not None and s.echo_interval is not None:
                if s.state == BfdState.UP and s.remote_min_echo_rx:
                    self._send_echo(s)
                self._arm_echo_tx(s)
        elif isinstance(msg, EchoDetectTimerMsg):
            s = self.sessions.get(msg.key)
            if s is not None and s.state == BfdState.UP:
                self._transition(s, BfdState.DOWN, BfdDiag.ECHO_FAILED)
        elif isinstance(msg, IbusMsg):
            p = msg.payload
            if isinstance(p, BfdSessionReg):
                s = self.register(p.key, msg.sender, p.local)
                # Honor the client's requested timing parameters (take the
                # fastest/safest across clients).
                s.required_min_rx = min(s.required_min_rx, p.min_rx)
                s.desired_min_tx = min(s.desired_min_tx, p.min_tx)
                s.detect_mult = p.multiplier
            elif isinstance(p, BfdSessionUnreg):
                self.unregister(p.key, msg.sender)

    # -- FSM (RFC 5880 §6.8.6)

    def _rx(self, msg: NetRxPacket) -> None:
        if msg.data.startswith(ECHO_MAGIC):
            self._rx_echo(msg)
            return
        _BFD_PACKETS.labels(dir="rx").inc()
        try:
            pkt = BfdPacket.decode(msg.data)
        except DecodeError:
            return
        s = self.sessions.get(self.session_key(msg.ifname, msg.src))
        if s is None:
            # Multihop lookup: keyed by (local, remote) address pair.
            s = self.sessions.get(
                self.session_key_mh(msg.dst, msg.src)
            ) or next(
                (
                    t
                    for t in self.sessions.values()
                    if t.is_multihop()
                    and t.key[2] == msg.src
                    and (msg.dst is None or t.key[1] == msg.dst)
                ),
                None,
            )
        if s is None:
            return
        if pkt.your_discr != 0 and pkt.your_discr != s.local_discr:
            return
        # Authentication (RFC 5880 §6.7): sessions with auth configured
        # drop unauthenticated or badly-keyed packets; sessions without
        # drop authenticated ones (§6.7.1 bfd.AuthSeqKnown discipline).
        if s.auth_type is not None:
            if pkt.auth is None or pkt.auth.auth_type != s.auth_type:
                return
            if pkt.auth.key_id != s.auth_key_id:
                return
            if not pkt.verify_auth(msg.data, s.auth_key):
                return
            if pkt.auth.auth_type != BfdAuthType.SIMPLE_PASSWORD:
                meticulous = pkt.auth.auth_type in (
                    BfdAuthType.METICULOUS_KEYED_MD5,
                    BfdAuthType.METICULOUS_KEYED_SHA1,
                )
                last = s._last_rx_seq
                if last is not None:
                    window = 3 * s.remote_detect_mult
                    delta = (pkt.auth.seq - last) & 0xFFFFFFFF
                    if meticulous and (delta == 0 or delta > window):
                        return
                    if not meticulous and delta > window:
                        return
                s._last_rx_seq = pkt.auth.seq
        elif pkt.auth is not None:
            return
        s.remote_discr = pkt.my_discr
        s.remote_state = pkt.state
        s.remote_min_rx = pkt.required_min_rx
        s.remote_min_tx = pkt.desired_min_tx
        s.remote_detect_mult = pkt.detect_mult
        s.remote_min_echo_rx = pkt.required_min_echo_rx

        if pkt.state == BfdState.ADMIN_DOWN:
            if s.state in (BfdState.INIT, BfdState.UP):
                self._transition(s, BfdState.DOWN, BfdDiag.NEIGHBOR_DOWN)
        elif s.state == BfdState.DOWN:
            if pkt.state == BfdState.DOWN:
                self._transition(s, BfdState.INIT)
            elif pkt.state == BfdState.INIT:
                self._transition(s, BfdState.UP)
        elif s.state == BfdState.INIT:
            if pkt.state in (BfdState.INIT, BfdState.UP):
                self._transition(s, BfdState.UP)
        elif s.state == BfdState.UP:
            if pkt.state == BfdState.DOWN:
                self._transition(s, BfdState.DOWN, BfdDiag.NEIGHBOR_DOWN)
        self._arm_detect(s)

    def _transition(self, s: Session, new: BfdState, diag: BfdDiag = BfdDiag.NONE) -> None:
        if s.state == new:
            return
        _BFD_TRANSITIONS.labels(to=new.name.lower()).inc()
        if s.state == BfdState.UP and new == BfdState.DOWN:
            _BFD_FLAPS.inc()
        s.state = new
        s.diag = diag
        if new == BfdState.DOWN:
            # RFC 5880 §6.8.1: bfd.AuthSeqKnown is cleared when the
            # detection timer expires so a recovered peer's sequence
            # numbers are accepted afresh.
            s._last_rx_seq = None
        if self.notif_cb is not None:
            # Reference holo-bfd northbound/notification.rs:18-33: the
            # notification module matches the session key flavor.
            body = {
                "local-discr": s.local_discr,
                "remote-discr": s.remote_discr,
                "new-state": {
                    BfdState.UP: "up",
                    BfdState.DOWN: "down",
                    BfdState.INIT: "init",
                    BfdState.ADMIN_DOWN: "admin-down",
                }[new],
            }
            if s.key and s.key[0] == "mh":
                body["source-addr"] = str(s.key[1])
                body["dest-addr"] = str(s.key[2])
                self.notif_cb(
                    {"ietf-bfd-multihop:multihop-notification": body}
                )
            else:
                body["interface"] = s.key[0]
                body["dest-addr"] = str(s.key[1])
                self.notif_cb(
                    {"ietf-bfd-ip-sh:singlehop-notification": body}
                )
        if self.ibus is not None:
            label = {
                BfdState.UP: "up",
                BfdState.DOWN: "down",
                BfdState.INIT: "init",
                BfdState.ADMIN_DOWN: "admin-down",
            }[new]
            # Causal origin stamp: a BFD state change IS a topology
            # event — the id rides the publish into the RIB's O(1)
            # local-repair flip and any subscribed protocol's SPF.
            from holo_tpu_torch.telemetry import convergence

            eid = convergence.begin(
                convergence.TRIGGER_BFD, state=label, key=str(s.key)
            )
            with convergence.activation(eid):
                self.ibus.publish(TOPIC_BFD_STATE, BfdStateUpd(s.key, label))
        # Faster tx once the session leaves Down.
        self._arm_tx(s, self._tx_interval(s))

    def _tx_interval(self, s: Session) -> float:
        if s.state == BfdState.UP:
            return max(s.desired_min_tx, s.remote_min_rx) / 1e6
        return self.slow_tx

    def _detect_time(self, s: Session) -> float:
        """RFC 5880 §6.8.4: remote detect-mult × max(our RequiredMinRx,
        remote DesiredMinTx) — the peer may legitimately transmit slower
        than we are willing to receive."""
        return (
            s.remote_detect_mult
            * max(s.required_min_rx, s.remote_min_tx, 1)
            / 1e6
        )

    def _arm_tx(self, s: Session, delay: float) -> None:
        t = getattr(s, "_tx_timer", None)
        if t is None:
            t = self.loop.timer(self.name, lambda key=s.key: TxTimerMsg(key))
            s._tx_timer = t
        t.start(delay)

    def _arm_detect(self, s: Session) -> None:
        t = getattr(s, "_detect_timer", None)
        if t is None:
            t = self.loop.timer(self.name, lambda key=s.key: DetectTimerMsg(key))
            s._detect_timer = t
        t.start(self._detect_time(s))

    def _send(self, s: Session) -> None:
        auth = None
        if s.auth_type is not None:
            if s.auth_type != BfdAuthType.SIMPLE_PASSWORD:
                # Meticulous types increment on every packet, plain
                # keyed types occasionally (we bump per packet too —
                # permitted by §6.7.3).
                s._tx_seq = (s._tx_seq + 1) & 0xFFFFFFFF
            auth = BfdAuth(
                s.auth_type, key_id=s.auth_key_id, seq=s._tx_seq
            )
        pkt = BfdPacket(
            state=s.state,
            diag=s.diag,
            detect_mult=s.detect_mult,
            my_discr=s.local_discr,
            your_discr=s.remote_discr,
            desired_min_tx=s.desired_min_tx,
            required_min_rx=s.required_min_rx,
            required_min_echo_rx=s.required_min_echo_rx,
            auth=auth,
        )
        wire = pkt.encode(auth_key=s.auth_key or None)
        _BFD_PACKETS.labels(dir="tx").inc()
        if s.is_multihop():
            _, src, dst = s.key
            self.netio.send(None, src, dst, wire)
        else:
            ifname, peer = s.key
            self.netio.send(
                ifname, getattr(s, "local", None), peer, wire
            )

    # -- echo function (RFC 5880 §6.4)

    def _send_echo(self, s: Session) -> None:
        local = getattr(s, "local", None)
        tag = local.packed if local is not None else b"\x00" * 4
        data = ECHO_MAGIC + s.local_discr.to_bytes(4, "big") + tag
        ifname, peer = s.key
        self.netio.send(ifname, local, peer, data)
        self._arm_echo_detect(s)

    def _rx_echo(self, msg: NetRxPacket) -> None:
        body = msg.data[len(ECHO_MAGIC) :]
        discr = int.from_bytes(body[:4], "big")
        tag = body[4:8]
        mine = next(
            (
                s
                for s in self.sessions.values()
                if s.local_discr == discr
                and s.echo_interval is not None
                and getattr(s, "local", None) is not None
                and s.local.packed == tag
            ),
            None,
        )
        if mine is not None:
            # Our echo came back: the forwarding path is alive.
            t = getattr(mine, "_echo_detect_timer", None)
            if t is not None:
                t.cancel()
            return
        # Not ours: play the forwarding plane and loop it to the sender
        # (real kernels U-turn BFD echo at the IP layer).
        self.netio.send(msg.ifname, msg.dst, msg.src, msg.data)

    def _arm_echo_tx(self, s: Session) -> None:
        t = getattr(s, "_echo_tx_timer", None)
        if t is None:
            t = self.loop.timer(
                self.name, lambda key=s.key: EchoTxTimerMsg(key)
            )
            s._echo_tx_timer = t
        t.start(s.echo_interval)

    def _arm_echo_detect(self, s: Session) -> None:
        t = getattr(s, "_echo_detect_timer", None)
        if t is None:
            t = self.loop.timer(
                self.name, lambda key=s.key: EchoDetectTimerMsg(key)
            )
            s._echo_detect_timer = t
        # Only arm when idle: each returning echo cancels the timer, and
        # the next send opens a fresh window.  Re-arming on every send
        # would push the deadline forever while echoes are lost.
        if not t.armed:
            t.start(s.echo_interval * s.detect_mult)
