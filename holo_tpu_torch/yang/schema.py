"""Schema node model: containers, lists, leaves with typed values.

Equivalent role to libyang's compiled schema (holo-yang); deliberately
small: the features the northbound engine needs — path resolution, type
checking, defaults, mandatory enforcement — not full YANG.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Callable


class SchemaError(Exception):
    pass


@dataclass
class Leaf:
    name: str
    type: str = "string"  # string|uint8|uint16|uint32|int32|boolean|ip|prefix|enum
    default: Any = None
    mandatory: bool = False
    enum: tuple[str, ...] = ()
    config: bool = True

    def check(self, value: Any) -> Any:
        t = self.type
        try:
            if t == "string":
                return str(value)
            if t in ("uint8", "uint16", "uint32", "int32"):
                v = int(value)
                lims = {
                    "uint8": (0, 0xFF),
                    "uint16": (0, 0xFFFF),
                    "uint32": (0, 0xFFFFFFFF),
                    "int32": (-(1 << 31), (1 << 31) - 1),
                }[t]
                if not lims[0] <= v <= lims[1]:
                    raise SchemaError(f"{self.name}: {v} out of range for {t}")
                return v
            if t == "boolean":
                if isinstance(value, bool):
                    return value
                return {"true": True, "false": False}[str(value).lower()]
            if t == "ip":
                from ipaddress import ip_address

                return ip_address(value)
            if t == "prefix":
                from ipaddress import ip_network

                return ip_network(value, strict=False)
            if t == "ifaddr":
                # interface address: host ip + prefix length preserved
                from ipaddress import ip_interface

                return ip_interface(value)
            if t == "enum":
                v = str(value)
                if v not in self.enum:
                    raise SchemaError(f"{self.name}: {v!r} not in {self.enum}")
                return v
        except SchemaError:
            raise
        except Exception as e:
            raise SchemaError(f"{self.name}: bad {t} value {value!r}: {e}") from e
        raise SchemaError(f"{self.name}: unknown type {t}")


@dataclass
class LeafList:
    name: str
    type: str = "string"
    config: bool = True

    def check(self, values) -> list:
        leaf = Leaf(self.name, self.type)
        return [leaf.check(v) for v in values]


@dataclass
class List:
    name: str
    key: str  # single key leaf name (compound keys via tuple-string later)
    children: dict[str, Any] = field(default_factory=dict)
    config: bool = True

    def child(self, name: str):
        c = self.children.get(name)
        if c is None:
            raise SchemaError(f"list {self.name}: no child {name!r}")
        return c


@dataclass
class Container:
    name: str
    children: dict[str, Any] = field(default_factory=dict)
    presence: bool = False
    config: bool = True

    def child(self, name: str):
        c = self.children.get(name)
        if c is None:
            raise SchemaError(f"container {self.name}: no child {name!r}")
        return c


def C(name: str, *children, presence=False, config=True) -> Container:
    return Container(name, {c.name: c for c in children}, presence, config)


def L(name: str, key: str, *children, config=True) -> List:
    return List(name, key, {c.name: c for c in children}, config)


_SEG = re.compile(r"([^/\[]+)(?:\[(?:[^=\]]+=)?([^\]]+)\])?")


@dataclass
class Schema:
    """A forest of top-level containers, addressable by slash paths."""

    roots: dict[str, Container] = field(default_factory=dict)

    def mount(self, root: Container) -> None:
        self.roots[root.name] = root

    def resolve(self, path: str):
        """Resolve 'a/b[key]/c' to the schema node (ignoring key values)."""
        segs = parse_path(path)
        if not segs:
            raise SchemaError("empty path")
        name0, _ = segs[0]
        node = self.roots.get(name0)
        if node is None:
            raise SchemaError(f"no module root {name0!r}")
        for name, _key in segs[1:]:
            if isinstance(node, (Container, List)):
                node = node.child(name)
            else:
                raise SchemaError(f"cannot descend into leaf at {name}")
        return node


def parse_path(path: str) -> list[tuple[str, str | None]]:
    """'a/b[k=v]/c' -> [('a', None), ('b', 'v'), ('c', None)].

    Splitting is bracket-aware: list keys may themselves contain slashes
    (e.g. ``static-routes/route[10.0.0.0/16]``).
    """
    segs: list[str] = []
    depth = 0
    cur: list[str] = []
    for ch in path.strip("/"):
        if ch == "/" and depth == 0:
            if cur:
                segs.append("".join(cur))
                cur = []
            continue
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        cur.append(ch)
    if cur:
        segs.append("".join(cur))
    out: list[tuple[str, str | None]] = []
    for seg in segs:
        m = _SEG.fullmatch(seg)
        if not m:
            raise SchemaError(f"bad path segment {seg!r}")
        out.append((m.group(1), m.group(2)))
    return out
