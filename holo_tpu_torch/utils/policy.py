"""Routing policy engine: match sets, statements, apply chains.

Reference: holo-utils/src/policy.rs:139-346 (the ietf-routing-policy data
model) + holo-bgp's policy application worker.  A ``Policy`` is an ordered
list of statements; each statement has match conditions (prefix sets, tag
sets, protocol) and actions (accept/reject, set metric/tag/local-pref).

Policies evaluate against a neutral ``RouteContext`` so one engine serves
BGP import/export, redistribution filtering, and RIP/OSPF route maps.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from ipaddress import ip_network

from holo_tpu_torch.utils.ip import IpNetwork


class PolicyResult(enum.Enum):
    ACCEPT = "accept-route"
    REJECT = "reject-route"
    CONTINUE = "continue"  # no terminal action matched


@dataclass
class RouteContext:
    """Mutable route view a policy evaluates and edits.

    ``metric``/``local_pref`` are Optional so a policy's set-metric 0 is
    distinguishable from "unset".  The BGP-only fields mirror the
    reference's BgpPolicyCondition/-Action surface
    (holo-utils/src/policy.rs:259-386).
    """

    prefix: IpNetwork
    protocol: str = ""
    metric: int | None = None
    tag: int | None = None
    local_pref: int | None = None
    communities: set = field(default_factory=set)
    ext_communities: set = field(default_factory=set)
    large_communities: set = field(default_factory=set)
    as_path: tuple = ()  # flattened ASN sequence
    origin: str | None = None  # "igp" | "egp" | "incomplete"
    nexthop: str | None = None
    neighbor: str | None = None  # peer address the route came from


@dataclass
class PrefixSet:
    """Prefix match set with masklength ranges (exact | le | ge)."""

    name: str
    entries: list[tuple[IpNetwork, int | None, int | None]] = field(
        default_factory=list
    )  # (prefix, ge, le)

    def add(self, prefix, ge: int | None = None, le: int | None = None):
        self.entries.append((ip_network(prefix, strict=False), ge, le))
        return self

    def matches(self, prefix: IpNetwork) -> bool:
        for base, ge, le in self.entries:
            if prefix.version != base.version:
                continue
            if ge is None and le is None:
                if prefix == base:
                    return True
                continue
            if not base.supernet_of(prefix) and prefix != base:
                continue
            plen = prefix.prefixlen
            if ge is not None and plen < ge:
                continue
            if le is not None and plen > le:
                continue
            return True
        return False


def parse_community(value) -> int:
    """"asn:value" notation or plain int → u32 (RFC 1997 encoding)."""
    if isinstance(value, int):
        return value
    asn, _, local = str(value).partition(":")
    if local:
        return (int(asn) << 16) | int(local)
    return int(asn)


def parse_large_community(value) -> tuple:
    """"global:local1:local2" or 3-sequence → (u32, u32, u32)."""
    if isinstance(value, (tuple, list)):
        ga, l1, l2 = value
        return (int(ga), int(l1), int(l2))
    ga, l1, l2 = str(value).split(":")
    return (int(ga), int(l1), int(l2))


def parse_ext_community(value) -> bytes:
    """Extended community → its 8-byte wire value (RFC 4360).

    Accepts bytes verbatim, "rt:ASN:VAL" / "soo:ASN:VAL" notation
    (two-octet-AS route-target/route-origin), or 16 hex digits.
    """
    if isinstance(value, (bytes, bytearray)):
        if len(value) != 8:
            raise ValueError(f"ext community needs 8 bytes, got {len(value)}")
        return bytes(value)
    s = str(value)
    kind, _, rest = s.partition(":")
    if kind in ("rt", "soo") and rest:
        asn, _, local = rest.partition(":")
        sub = 0x02 if kind == "rt" else 0x03
        return (
            bytes((0x00, sub))
            + int(asn).to_bytes(2, "big")
            + int(local).to_bytes(4, "big")
        )
    hexstr = s.replace(":", "").replace(".", "")
    raw = bytes.fromhex(hexstr)
    if len(raw) != 8:
        raise ValueError(f"ext community needs 8 bytes, got {len(raw)}")
    return raw


def _cmp(have: int | None, want: dict) -> bool:
    """{"value": N, "op": "eq"|"le"|"ge"} — reference BgpEqOperator."""
    if have is None:
        return False
    value = int(want.get("value", 0))
    op = want.get("op", "eq")
    if op in ("le", "less-than-or-equal"):
        return have <= value
    if op in ("ge", "greater-than-or-equal"):
        return have >= value
    return have == value


def _match_set(wanted: set, have: set, how: str) -> bool:
    """ietf match-set-options: any | all | invert."""
    if how == "all":
        return bool(wanted) and wanted.issubset(have)
    if how == "invert":
        return not (wanted & have)
    return bool(wanted & have)


@dataclass
class Conditions:
    prefix_set: str | None = None
    tag_set: str | None = None
    protocol: str | None = None
    neighbor_set: str | None = None
    # BGP set matching (ietf-bgp-policy / reference
    # BgpPolicyCondition, holo-utils/src/policy.rs:259-310): options per
    # the ietf-routing-policy match-set-options type.
    community_set: str | None = None
    community_match: str = "any"  # "any" | "all" | "invert"
    ext_community_set: str | None = None
    ext_community_match: str = "any"
    large_community_set: str | None = None
    large_community_match: str = "any"
    as_path_set: str | None = None  # matches any member ASN on the path
    nexthop_set: str | None = None
    # Scalar comparisons: {"value": N, "op": "eq"|"le"|"ge"}.
    med: dict | None = None
    local_pref: dict | None = None
    as_path_len: dict | None = None
    community_count: dict | None = None
    origin: str | None = None  # "igp" | "egp" | "incomplete"

    def match(self, ctx: RouteContext, sets: "DefinedSets") -> bool:
        if self.prefix_set is not None:
            ps = sets.prefix_sets.get(self.prefix_set)
            if ps is None or not ps.matches(ctx.prefix):
                return False
        if self.tag_set is not None:
            tags = sets.tag_sets.get(self.tag_set, set())
            if ctx.tag not in tags:
                return False
        if self.protocol is not None and ctx.protocol != self.protocol:
            return False
        if self.neighbor_set is not None:
            addrs = sets.neighbor_sets.get(self.neighbor_set, set())
            if ctx.neighbor is None or str(ctx.neighbor) not in addrs:
                return False
        if self.community_set is not None and not _match_set(
            sets.community_sets.get(self.community_set, set()),
            ctx.communities,
            self.community_match,
        ):
            return False
        if self.ext_community_set is not None and not _match_set(
            sets.ext_community_sets.get(self.ext_community_set, set()),
            ctx.ext_communities,
            self.ext_community_match,
        ):
            return False
        if self.large_community_set is not None and not _match_set(
            sets.large_community_sets.get(self.large_community_set, set()),
            ctx.large_communities,
            self.large_community_match,
        ):
            return False
        if self.as_path_set is not None:
            asns = sets.as_path_sets.get(self.as_path_set, set())
            if not asns & set(ctx.as_path):
                return False
        if self.nexthop_set is not None:
            hops = sets.nexthop_sets.get(self.nexthop_set, set())
            if ctx.nexthop is None or str(ctx.nexthop) not in hops:
                return False
        if self.med is not None and not _cmp(ctx.metric, self.med):
            return False
        if self.local_pref is not None and not _cmp(
            ctx.local_pref, self.local_pref
        ):
            return False
        if self.as_path_len is not None and not _cmp(
            len(ctx.as_path), self.as_path_len
        ):
            return False
        if self.community_count is not None and not _cmp(
            len(ctx.communities), self.community_count
        ):
            return False
        if self.origin is not None and ctx.origin != self.origin:
            return False
        return True


def _apply_comm_edit(have: set, comms: set, method: str) -> set:
    """BgpSetCommOptions Add/Remove/Replace (policy.rs:415-420)."""
    if method == "replace":
        return set(comms)
    if method == "remove":
        return have - comms
    return have | comms


@dataclass
class Actions:
    result: PolicyResult | None = None  # terminal accept/reject
    set_metric: int | None = None
    set_tag: int | None = None
    set_local_pref: int | None = None
    # ietf-bgp-policy set-community family: inline values applied by
    # method "add" (default) / "remove" / "replace" (reference
    # BgpPolicyAction, holo-utils/src/policy.rs:361-386).
    set_communities: tuple = ()
    set_communities_method: str = "add"
    set_ext_communities: tuple = ()
    set_ext_communities_method: str = "add"
    set_large_communities: tuple = ()
    set_large_communities_method: str = "add"
    set_origin: str | None = None
    set_nexthop: str | None = None  # address or "self"
    # {"set"|"add"|"subtract": N} — reference BgpSetMed.
    set_med: dict | None = None
    # {"asn": N, "repeat": N} — reference SetAsPathPrepent.
    as_path_prepend: dict | None = None

    def apply(self, ctx: RouteContext) -> PolicyResult:
        if self.set_metric is not None:
            ctx.metric = self.set_metric
        if self.set_tag is not None:
            ctx.tag = self.set_tag
        if self.set_local_pref is not None:
            ctx.local_pref = self.set_local_pref
        if self.set_communities or self.set_communities_method == "replace":
            ctx.communities = _apply_comm_edit(
                ctx.communities,
                set(self.set_communities),
                self.set_communities_method,
            )
        if (
            self.set_ext_communities
            or self.set_ext_communities_method == "replace"
        ):
            ctx.ext_communities = _apply_comm_edit(
                ctx.ext_communities,
                set(self.set_ext_communities),
                self.set_ext_communities_method,
            )
        if (
            self.set_large_communities
            or self.set_large_communities_method == "replace"
        ):
            ctx.large_communities = _apply_comm_edit(
                ctx.large_communities,
                set(self.set_large_communities),
                self.set_large_communities_method,
            )
        if self.set_origin is not None:
            ctx.origin = self.set_origin
        if self.set_nexthop is not None:
            ctx.nexthop = self.set_nexthop
        if self.set_med is not None:
            if "set" in self.set_med:
                ctx.metric = int(self.set_med["set"])
            elif "add" in self.set_med:
                ctx.metric = (ctx.metric or 0) + int(self.set_med["add"])
            elif "subtract" in self.set_med:
                ctx.metric = max(
                    0, (ctx.metric or 0) - int(self.set_med["subtract"])
                )
        if self.as_path_prepend is not None:
            asn = int(self.as_path_prepend["asn"])
            repeat = int(self.as_path_prepend.get("repeat") or 1)
            ctx.as_path = (asn,) * repeat + tuple(ctx.as_path)
        return self.result or PolicyResult.CONTINUE


@dataclass
class Statement:
    name: str
    conditions: Conditions = field(default_factory=Conditions)
    actions: Actions = field(default_factory=Actions)


@dataclass
class Policy:
    name: str
    statements: list[Statement] = field(default_factory=list)
    default_result: PolicyResult = PolicyResult.REJECT

    def evaluate(self, ctx: RouteContext, sets: "DefinedSets") -> PolicyResult:
        """First terminal statement wins; edits accumulate along the way."""
        for stmt in self.statements:
            if stmt.conditions.match(ctx, sets):
                result = stmt.actions.apply(ctx)
                if result != PolicyResult.CONTINUE:
                    return result
        return self.default_result


@dataclass
class DefinedSets:
    """Reference MatchSets (holo-utils/src/policy.rs:139-182): shared
    prefix/neighbor/tag sets plus the BGP families."""

    prefix_sets: dict[str, PrefixSet] = field(default_factory=dict)
    tag_sets: dict[str, set[int]] = field(default_factory=dict)
    neighbor_sets: dict[str, set[str]] = field(default_factory=dict)
    # name -> set of u32 community values (ietf-bgp-policy
    # community-sets; members accept "asn:value" or raw ints).
    community_sets: dict[str, set[int]] = field(default_factory=dict)
    ext_community_sets: dict[str, set] = field(default_factory=dict)
    large_community_sets: dict[str, set] = field(default_factory=dict)
    as_path_sets: dict[str, set[int]] = field(default_factory=dict)
    nexthop_sets: dict[str, set[str]] = field(default_factory=dict)


class PolicyEngine:
    """Registry + evaluation entry point (what the ibus PolicyUpd carries)."""

    def __init__(self) -> None:
        self.sets = DefinedSets()
        self.policies: dict[str, Policy] = {}

    def load_from_config(self, conf: dict) -> None:
        """Build from the routing-policy YANG-lite subtree."""
        self.sets = DefinedSets()
        self.policies = {}
        defined = conf.get("defined-sets", {}) or {}
        for name, entry in (defined.get("prefix-set") or {}).items():
            ps = PrefixSet(name)
            for p in entry.get("prefix", []):
                ps.add(p)
            self.sets.prefix_sets[name] = ps
        for name, entry in (defined.get("tag-set") or {}).items():
            self.sets.tag_sets[name] = set(entry.get("tag", []))
        for name, entry in (defined.get("community-set") or {}).items():
            self.sets.community_sets[name] = {
                parse_community(m) for m in entry.get("member", [])
            }
        for name, entry in (defined.get("neighbor-set") or {}).items():
            self.sets.neighbor_sets[name] = {
                str(a) for a in entry.get("address", [])
            }
        for name, entry in (defined.get("ext-community-set") or {}).items():
            self.sets.ext_community_sets[name] = {
                parse_ext_community(m) for m in entry.get("member", [])
            }
        for name, entry in (defined.get("large-community-set") or {}).items():
            self.sets.large_community_sets[name] = {
                parse_large_community(m) for m in entry.get("member", [])
            }
        for name, entry in (defined.get("as-path-set") or {}).items():
            self.sets.as_path_sets[name] = {
                int(m) for m in entry.get("member", [])
            }
        for name, entry in (defined.get("next-hop-set") or {}).items():
            self.sets.nexthop_sets[name] = {
                str(a) for a in entry.get("address", [])
            }
        for name, entry in (conf.get("policy-definition") or {}).items():
            pol = Policy(name)
            for sname, s in (entry.get("statement") or {}).items():
                cond = s.get("conditions", {}) or {}
                act = s.get("actions", {}) or {}
                result = None
                if act.get("policy-result") == "accept-route":
                    result = PolicyResult.ACCEPT
                elif act.get("policy-result") == "reject-route":
                    result = PolicyResult.REJECT
                set_comm = act.get("set-community") or {}
                set_ext = act.get("set-ext-community") or {}
                set_large = act.get("set-large-community") or {}
                pol.statements.append(
                    Statement(
                        sname,
                        Conditions(
                            prefix_set=cond.get("match-prefix-set"),
                            tag_set=cond.get("match-tag-set"),
                            neighbor_set=cond.get("match-neighbor-set"),
                            community_set=cond.get("match-community-set"),
                            community_match=cond.get(
                                "community-match-options", "any"
                            ),
                            ext_community_set=cond.get(
                                "match-ext-community-set"
                            ),
                            ext_community_match=cond.get(
                                "ext-community-match-options", "any"
                            ),
                            large_community_set=cond.get(
                                "match-large-community-set"
                            ),
                            large_community_match=cond.get(
                                "large-community-match-options", "any"
                            ),
                            as_path_set=cond.get("match-as-path-set"),
                            nexthop_set=cond.get("match-next-hop-set"),
                            med=cond.get("med"),
                            local_pref=cond.get("local-pref"),
                            as_path_len=cond.get("as-path-length"),
                            community_count=cond.get("community-count"),
                            origin=cond.get("origin-eq"),
                        ),
                        Actions(
                            result=result,
                            set_metric=act.get("set-metric"),
                            set_tag=act.get("set-tag"),
                            set_local_pref=act.get("set-local-pref"),
                            set_communities=tuple(
                                parse_community(m)
                                for m in set_comm.get("communities", [])
                            ),
                            set_communities_method=set_comm.get(
                                "method", "add"
                            ),
                            set_ext_communities=tuple(
                                parse_ext_community(m)
                                for m in set_ext.get("communities", [])
                            ),
                            set_ext_communities_method=set_ext.get(
                                "method", "add"
                            ),
                            set_large_communities=tuple(
                                parse_large_community(m)
                                for m in set_large.get("communities", [])
                            ),
                            set_large_communities_method=set_large.get(
                                "method", "add"
                            ),
                            set_origin=act.get("set-route-origin"),
                            set_nexthop=act.get("set-next-hop"),
                            set_med=act.get("set-med"),
                            as_path_prepend=act.get("set-as-path-prepend"),
                        ),
                    )
                )
            self.policies[name] = pol

    def apply(self, policy_name: str, ctx: RouteContext) -> PolicyResult:
        pol = self.policies.get(policy_name)
        if pol is None:
            return PolicyResult.ACCEPT  # no policy = accept untouched
        return pol.evaluate(ctx, self.sets)
