"""OSPF neighbor state machine (NSM, RFC 2328 §10) + DD exchange state.

Reference: holo-ospf/src/neighbor.rs.  The NSM here is table-driven; the
instance actor supplies the side effects (packet sends, timer management,
LSA list maintenance) via the transition result.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from ipaddress import IPv4Address

from holo_tpu_torch.protocols.ospf.packet import DbDescFlags, Lsa, LsaKey


class NsmState(enum.IntEnum):
    DOWN = 0
    ATTEMPT = 1
    INIT = 2
    TWO_WAY = 3
    EX_START = 4
    EXCHANGE = 5
    LOADING = 6
    FULL = 7


class NsmEvent(enum.Enum):
    HELLO_RECEIVED = "hello_received"
    START = "start"
    TWO_WAY_RECEIVED = "2way_received"
    NEGOTIATION_DONE = "negotiation_done"
    EXCHANGE_DONE = "exchange_done"
    BAD_LS_REQ = "bad_ls_req"
    LOADING_DONE = "loading_done"
    ADJ_OK = "adj_ok"
    SEQ_NUMBER_MISMATCH = "seq_mismatch"
    ONE_WAY_RECEIVED = "1way_received"
    KILL_NBR = "kill_nbr"
    INACTIVITY_TIMER = "inactivity_timer"
    LL_DOWN = "ll_down"


@dataclass
class Neighbor:
    router_id: IPv4Address
    src: IPv4Address  # neighbor interface address
    state: NsmState = NsmState.DOWN
    priority: int = 0
    dr: IPv4Address = IPv4Address(0)
    bdr: IPv4Address = IPv4Address(0)
    # OSPFv3: the neighbor's interface id from its hellos (RFC 5340
    # §4.2.1 — needed for transit links and network-LSA vertex keys).
    iface_id: int = 0
    # DD exchange (§10.8):
    master: bool = False  # True if WE are master
    dd_seq_no: int = 0
    dd_pending_flags: DbDescFlags = DbDescFlags(0)
    last_dd: tuple | None = None  # (flags, options, seq) for duplicate detect
    dd_summary: list[Lsa] = field(default_factory=list)  # headers to send
    last_sent_dd: object = None  # retransmit copy (master) / echo copy (slave)
    # Lists (§10: Link state request / retransmission lists):
    ls_request: dict[LsaKey, Lsa] = field(default_factory=dict)
    ls_rxmt: dict[LsaKey, Lsa] = field(default_factory=dict)
    # Timers owned by the instance actor:
    timers: dict = field(default_factory=dict)
    # Cryptographic auth replay protection (RFC 2328 D.3): last accepted
    # sequence number from this neighbor.
    crypto_seqno: int = -1
    # RFC 5613 LLS: extended-options flags from the peer's last hello
    # (LR = OOB resync capable, RS = restart signal), None = no block.
    lls_eof: int | None = None
    # Graceful-restart helper (RFC 3623): while now < gr_deadline the
    # inactivity timer must not kill this neighbor.
    gr_deadline: float | None = None
    gr_reason: int = 0  # Grace-LSA restart reason while helping

    def is_adjacent(self) -> bool:
        return self.state >= NsmState.EX_START

    def exchange_or_loading(self) -> bool:
        return self.state in (NsmState.EXCHANGE, NsmState.LOADING)


# NSM transition core: (state, event) -> new_state or callable deciding it.
# Actions are returned as labels the instance interprets (keeps IO out of
# the pure FSM, which the golden tests exercise directly).


@dataclass
class NsmResult:
    new_state: NsmState
    actions: list[str]


def nsm_transition(nbr: Neighbor, event: NsmEvent, adj_ok: bool = True) -> NsmResult:
    s = nbr.state
    E, S = NsmEvent, NsmState
    acts: list[str] = []

    if event == E.HELLO_RECEIVED:
        new = max(s, S.INIT)
        acts.append("restart_inactivity")
        return NsmResult(new, acts)
    if event == E.TWO_WAY_RECEIVED:
        if s == S.INIT:
            if adj_ok:
                acts += ["start_exstart"]
                return NsmResult(S.EX_START, acts)
            return NsmResult(S.TWO_WAY, acts)
        return NsmResult(s, acts)
    if event == E.ADJ_OK:
        if s == S.TWO_WAY and adj_ok:
            acts += ["start_exstart"]
            return NsmResult(S.EX_START, acts)
        if s > S.TWO_WAY and not adj_ok:
            acts += ["clear_lists"]
            return NsmResult(S.TWO_WAY, acts)
        return NsmResult(s, acts)
    if event == E.NEGOTIATION_DONE:
        acts += ["send_dd_summary"]
        return NsmResult(S.EXCHANGE, acts)
    if event == E.EXCHANGE_DONE:
        if nbr.ls_request:
            acts += ["send_ls_request"]
            return NsmResult(S.LOADING, acts)
        return NsmResult(S.FULL, acts + ["full"])
    if event == E.LOADING_DONE:
        return NsmResult(S.FULL, acts + ["full"])
    if event in (E.SEQ_NUMBER_MISMATCH, E.BAD_LS_REQ):
        if s >= S.EXCHANGE or s == S.EX_START:
            acts += ["clear_lists", "start_exstart"]
            return NsmResult(S.EX_START, acts)
        return NsmResult(s, acts)
    if event == E.ONE_WAY_RECEIVED:
        if s >= S.TWO_WAY:
            acts += ["clear_lists"]
            return NsmResult(S.INIT, acts)
        return NsmResult(s, acts)
    if event in (E.KILL_NBR, E.LL_DOWN, E.INACTIVITY_TIMER):
        acts += ["clear_lists", "stop_timers"]
        return NsmResult(S.DOWN, acts)
    return NsmResult(s, acts)
