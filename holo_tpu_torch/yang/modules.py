"""Schema module definitions mirroring the IETF models the reference
implements (holo-yang/modules/ietf/*): ietf-interfaces, ietf-routing with
per-protocol subtrees, ietf-system, ietf-key-chain, ietf-routing-policy.

These are our own declarative definitions shaped to the same northbound
paths; full YANG-text parsing is a later layer (see package docstring).
"""

from __future__ import annotations

from holo_tpu_torch.yang.schema import C, L, Leaf, LeafList, Schema


def _leaf(name, type="string", **kw):
    return Leaf(name, type, **kw)


def interfaces_module():
    return C(
        "interfaces",
        L(
            "interface",
            "name",
            _leaf("name"),
            _leaf("description"),
            _leaf("type", "enum", enum=("ethernet", "loopback", "vlan", "macvlan")),
            _leaf("enabled", "boolean", default=True),
            _leaf("mtu", "uint16", default=1500),
            # 802.1Q subinterface config (reference holo-interface
            # encapsulation/dot1q-vlan + parent-interface,
            # northbound/configuration.rs:122-131): a "vlan"-typed
            # interface with both leaves is created via netlink.
            _leaf("parent-interface"),
            _leaf("vlan-id", "uint16"),
            LeafList("address", "ifaddr"),  # host addr + prefix length
        ),
    )


def system_module():
    return C(
        "system",
        _leaf("hostname"),
        _leaf("contact"),
        _leaf("location"),
    )


def keychains_module():
    return C(
        "key-chains",
        L(
            "key-chain",
            "name",
            _leaf("name"),
            L(
                "key",
                "key-id",
                _leaf("key-id", "uint32"),
                _leaf("key-string"),
                _leaf("crypto-algorithm", "enum",
                      enum=("md5", "hmac-sha-1", "hmac-sha-256", "hmac-sha-384",
                            "hmac-sha-512")),
                # ietf-key-chain lifetimes (RFC 8177): independent send
                # and accept windows make key rollover lossless
                # (reference holo-utils/src/keychain.rs:42-92).
                C(
                    "send-lifetime",
                    _leaf("start-date-time"),
                    _leaf("end-date-time"),
                ),
                C(
                    "accept-lifetime",
                    _leaf("start-date-time"),
                    _leaf("end-date-time"),
                ),
                C(
                    "lifetime",
                    C(
                        "send-accept-lifetime",
                        _leaf("start-date-time"),
                        _leaf("end-date-time"),
                    ),
                ),
            ),
        ),
    )


def routing_policy_module():
    # BGP augmentations mirror the reference's BgpMatchSets /
    # BgpPolicyCondition / BgpPolicyAction surface
    # (holo-utils/src/policy.rs:139-386).
    match_options = ("any", "all", "invert")

    def _cmp_cond(name):
        return C(name, _leaf("value", "uint32"),
                 _leaf("op", "enum", enum=("eq", "le", "ge")))

    def _set_comm(name):
        return C(
            name,
            _leaf("method", "enum", enum=("add", "remove", "replace")),
            LeafList("communities", "string"),
        )

    return C(
        "routing-policy",
        C(
            "defined-sets",
            L("prefix-set", "name", _leaf("name"), LeafList("prefix", "prefix")),
            L("tag-set", "name", _leaf("name"), LeafList("tag", "uint32")),
            L("neighbor-set", "name", _leaf("name"),
              LeafList("address", "string")),
            L("community-set", "name", _leaf("name"),
              LeafList("member", "string")),
            L("ext-community-set", "name", _leaf("name"),
              LeafList("member", "string")),
            L("large-community-set", "name", _leaf("name"),
              LeafList("member", "string")),
            L("as-path-set", "name", _leaf("name"),
              LeafList("member", "uint32")),
            L("next-hop-set", "name", _leaf("name"),
              LeafList("address", "string")),
        ),
        L(
            "policy-definition",
            "name",
            _leaf("name"),
            L(
                "statement",
                "name",
                _leaf("name"),
                C(
                    "conditions",
                    _leaf("match-prefix-set"),
                    _leaf("match-tag-set"),
                    _leaf("match-neighbor-set"),
                    _leaf("match-community-set"),
                    _leaf("community-match-options", "enum",
                          enum=match_options),
                    _leaf("match-ext-community-set"),
                    _leaf("ext-community-match-options", "enum",
                          enum=match_options),
                    _leaf("match-large-community-set"),
                    _leaf("large-community-match-options", "enum",
                          enum=match_options),
                    _leaf("match-as-path-set"),
                    _leaf("match-next-hop-set"),
                    _cmp_cond("med"),
                    _cmp_cond("local-pref"),
                    _cmp_cond("as-path-length"),
                    _cmp_cond("community-count"),
                    _leaf("origin-eq", "enum",
                          enum=("igp", "egp", "incomplete")),
                ),
                C(
                    "actions",
                    _leaf("policy-result", "enum",
                          enum=("accept-route", "reject-route")),
                    _leaf("set-metric", "uint32"),
                    _leaf("set-tag", "uint32"),
                    _leaf("set-local-pref", "uint32"),
                    _set_comm("set-community"),
                    _set_comm("set-ext-community"),
                    _set_comm("set-large-community"),
                    _leaf("set-route-origin", "enum",
                          enum=("igp", "egp", "incomplete")),
                    _leaf("set-next-hop", "string"),
                    C("set-med",
                      _leaf("set", "uint32"),
                      _leaf("add", "uint32"),
                      _leaf("subtract", "uint32")),
                    C("set-as-path-prepend",
                      _leaf("asn", "uint32"),
                      _leaf("repeat", "uint8")),
                ),
            ),
        ),
    )


def _spf_control():
    return C(
        "spf-control",
        _leaf("paths", "uint16", default=16),
        C(
            "ietf-spf-delay",
            _leaf("initial-delay", "uint32", default=50),
            _leaf("short-delay", "uint32", default=200),
            _leaf("long-delay", "uint32", default=5000),
            _leaf("hold-down", "uint32", default=10000),
            _leaf("time-to-learn", "uint32", default=500),
        ),
        _leaf("backend", "enum", enum=("scalar", "tpu"), default="scalar"),
    )


def _fast_reroute():
    """ietf-ospf/isis fast-reroute container + holo's remote-lfa /
    ti-lfa / engine extension leaves — the shape the routing provider's
    ``_frr_config`` consumes (providers.py).  No defaulted leaves: an
    untouched container stays absent, which means FRR disabled."""
    return C(
        "fast-reroute",
        _leaf("lfa", "boolean"),  # RFC 5286 (absent = true when set)
        _leaf("remote-lfa", "boolean"),  # RFC 7490
        _leaf("ti-lfa", "boolean"),  # requires SR
        _leaf("engine", "enum", enum=("scalar", "tpu")),
    )


def _ospf_subtree(name):
    return C(
        name,
        _leaf("router-id", "ip"),
        _leaf("enabled", "boolean", default=True),
        LeafList("redistribute", "string"),  # protocols to inject as type-5
        _spf_control(),
        _fast_reroute(),
        L(
            "area",
            "area-id",
            _leaf("area-id"),
            _leaf("area-type", "enum", enum=("normal", "stub", "nssa"),
                  default="normal"),
            _leaf("default-cost", "uint32", default=1),
            L(
                "interface",
                "name",
                _leaf("name"),
                _leaf("interface-type", "enum",
                      enum=("broadcast", "point-to-point"), default="broadcast"),
                _leaf("cost", "uint16", default=10),
                _leaf("hello-interval", "uint16", default=10),
                _leaf("dead-interval", "uint32", default=40),
                _leaf("retransmit-interval", "uint16", default=5),
                _leaf("priority", "uint8", default=1),
                _leaf("passive", "boolean", default=False),
                _leaf("bfd", "boolean", default=False),
                C(
                    "authentication",
                    _leaf("key-chain"),
                    _leaf("type", "enum",
                          enum=("none", "simple", "md5"), default="none"),
                    _leaf("key"),
                    # OSPFv3 (RFC 7166) inline-key parameters: the SA id
                    # carried in the authentication trailer + HMAC
                    # algorithm.  Ignored by OSPFv2.
                    _leaf("sa-id", "uint16", default=1),
                    _leaf("crypto-algorithm", "enum",
                          enum=("sha1", "sha256", "sha384", "sha512"),
                          default="sha256"),
                ),
            ),
        ),
    )


def _rip_subtree(name):
    return C(
        name,
        _leaf("enabled", "boolean", default=True),
        _leaf("update-interval", "uint16", default=30),
        _leaf("invalid-interval", "uint16", default=180),
        _leaf("flush-interval", "uint16", default=240),
        L("interface", "name", _leaf("name"),
          _leaf("cost", "uint8", default=1),
          _leaf("split-horizon", "enum",
                enum=("disabled", "simple", "poison-reverse"),
                default="poison-reverse"),
          # ietf-rip per-interface authentication (reference holo-rip
          # configuration.rs:309-339: key + crypto-algorithm); the
          # key-chain option resolves keys by lifetime.  RIPng (RFC
          # 2080) has no in-protocol auth — validate() rejects it there.
          C("authentication",
            _leaf("key"),
            _leaf("key-id", "uint32", default=1),
            _leaf("type", "enum", enum=("password", "md5"),
                  default="md5"),
            _leaf("key-chain"))),
    )


def _bgp_subtree():
    return C(
        "bgp",
        _leaf("as", "uint32"),
        _leaf("router-id", "ip"),
        # Real TCP sessions vs the in-memory test fabric.
        _leaf("transport", "enum", enum=("fabric", "tcp"), default="fabric"),
        _leaf("port", "uint16", default=179),
        L(
            "neighbor",
            "address",
            _leaf("address", "ip"),
            _leaf("peer-as", "uint32"),
            _leaf("hold-time", "uint16", default=90),
            _leaf("connect-retry-interval", "uint16", default=30),
            _leaf("import-policy"),
            _leaf("export-policy"),
            _leaf("authentication-key"),  # TCP-MD5 (RFC 2385)
            # GTSM (RFC 5082): expected hop budget; unset = disabled.
            _leaf("ttl-security", "uint8"),
            _leaf("tcp-mss", "uint16"),  # reference network.rs set_mss
        ),
        L(
            "network",
            "prefix",
            _leaf("prefix", "prefix"),  # locally originated route
        ),
    )


def _bfd_subtree():
    return C(
        "bfd",
        L(
            "session",
            "dest-addr",
            _leaf("dest-addr", "ip"),
            _leaf("source-addr", "ip"),
            _leaf("local-multiplier", "uint8", default=3),
            _leaf("desired-min-tx-interval", "uint32", default=1000000),
            _leaf("required-min-rx-interval", "uint32", default=1000000),
        ),
    )


def _vrrp_subtree():
    return C(
        "vrrp",
        L(
            "instance",
            "vrid",
            _leaf("vrid", "uint8"),
            _leaf("interface"),
            _leaf("version", "enum", enum=("2", "3"), default="3"),
            _leaf("priority", "uint8", default=100),
            _leaf("advertise-interval", "uint16", default=1),
            LeafList("virtual-address", "ip"),
        ),
    )


def _static_subtree():
    return C(
        "static-routes",
        L(
            "route",
            "prefix",
            _leaf("prefix", "prefix"),
            _leaf("next-hop", "ip"),
            _leaf("interface"),
            _leaf("metric", "uint32", default=0),
        ),
    )


def routing_module():
    """ietf-routing shaped: control-plane-protocols hosting each protocol."""
    return C(
        "routing",
        _leaf("router-id", "ip"),
        C(
            "control-plane-protocols",
            _ospf_subtree("ospfv2"),
            _ospf_subtree("ospfv3"),
            C("isis",
              _leaf("enabled", "boolean", default=True),
              _leaf("system-id"),
              _leaf("level", "enum", enum=("level-1", "level-2", "level-all"),
                    default="level-all"),
              _spf_control(),
              _fast_reroute(),
              # Instance-level LSP/SNP authentication (reference
              # holo-isis northbound configuration.rs:531-597: key-chain
              # OR inline key + key-id + crypto-algorithm).
              C("authentication",
                _leaf("key-chain"),
                _leaf("key"),
                _leaf("key-id", "uint32", default=1),
                _leaf("crypto-algorithm", "enum",
                      enum=("hmac-md5", "hmac-sha1", "hmac-sha256"),
                      default="hmac-md5")),
              L("interface", "name", _leaf("name"),
                _leaf("interface-type", "enum",
                      enum=("broadcast", "point-to-point"), default="broadcast"),
                _leaf("metric", "uint32", default=10),
                # Per-circuit hello authentication (reference
                # configuration.rs hello_auth paths).
                C("hello-authentication",
                  _leaf("key-chain"),
                  _leaf("key"),
                  _leaf("key-id", "uint32", default=1),
                  _leaf("crypto-algorithm", "enum",
                        enum=("hmac-md5", "hmac-sha1", "hmac-sha256"),
                        default="hmac-md5")))),
            _rip_subtree("ripv2"),
            _rip_subtree("ripng"),
            _bgp_subtree(),
            _bfd_subtree(),
            _vrrp_subtree(),
            C("igmp",
              L("interface", "name", _leaf("name"),
                _leaf("version", "uint8", default=2),
                _leaf("query-interval", "uint16", default=125))),
            C("ldp",
              _leaf("enabled", "boolean", default=True),
              _leaf("lsr-id"),
              _leaf("label-distribution-control", "enum",
                    enum=("independent", "ordered"),
                    default="independent"),
              L("interface", "name", _leaf("name"),
                _leaf("hello-interval", "uint16", default=5))),
            _static_subtree(),
        ),
    )


def full_schema() -> Schema:
    s = Schema()
    s.mount(interfaces_module())
    s.mount(system_module())
    s.mount(keychains_module())
    s.mount(routing_policy_module())
    s.mount(routing_module())
    return s
