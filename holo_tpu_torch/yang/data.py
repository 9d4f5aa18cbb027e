"""Instance data trees + structural diff.

The transaction engine diffs running vs candidate trees into an ordered
change list (equivalent of libyang's DataDiff driving
changes_from_diff, holo-daemon/src/northbound/core.rs:408-425).
"""

from __future__ import annotations

import copy
import enum
import json
from dataclasses import dataclass
from typing import Any

from holo_tpu_torch.yang.schema import (
    Container,
    Leaf,
    LeafList,
    List,
    Schema,
    SchemaError,
    parse_path,
)


class DiffKind(enum.Enum):
    CREATE = "create"
    MODIFY = "modify"
    DELETE = "delete"


@dataclass(frozen=True)
class DiffOp:
    kind: DiffKind
    path: str  # canonical slash path with [key] segments
    value: Any = None


class DataTree:
    """Schema-validated nested-dict instance tree.

    Layout: containers -> dict, lists -> dict key-value -> entry dict,
    leaves -> scalar, leaf-lists -> list.
    """

    def __init__(self, schema: Schema, root: dict | None = None):
        self.schema = schema
        self.root: dict = root if root is not None else {}

    def copy(self) -> "DataTree":
        return DataTree(self.schema, copy.deepcopy(self.root))

    # -- editing

    def set(self, path: str, value: Any = None) -> None:
        """Set a leaf (value given) or create a container/list entry."""
        segs = parse_path(path)
        node, data = self._descend(segs[:-1], create=True)
        name, key = segs[-1]
        child = self._schema_child(node, name)
        if isinstance(child, Leaf):
            data[name] = child.check(value)
        elif isinstance(child, LeafList):
            data[name] = child.check(value if isinstance(value, list) else [value])
        elif isinstance(child, List):
            if key is None:
                raise SchemaError(f"list {name} requires [key]")
            entry = data.setdefault(name, {}).setdefault(key, {})
            key_leaf = child.child(child.key)
            entry[child.key] = key_leaf.check(key)
        elif isinstance(child, Container):
            data.setdefault(name, {})
        else:
            raise SchemaError(f"cannot set {path}")

    def delete(self, path: str) -> None:
        segs = parse_path(path)
        try:
            node, data = self._descend(segs[:-1], create=False)
        except KeyError:
            return
        name, key = segs[-1]
        child = self._schema_child(node, name)
        if isinstance(child, List) and key is not None:
            entries = data.get(name)
            if entries is not None:
                entries.pop(key, None)
                if not entries:
                    data.pop(name, None)
        else:
            data.pop(name, None)

    def get(self, path: str, default=None):
        segs = parse_path(path)
        try:
            _, data = self._descend(segs[:-1], create=False)
        except KeyError:
            return default
        name, key = segs[-1]
        val = data.get(name, default)
        if key is not None and isinstance(val, dict):
            return val.get(key, default)
        return val

    def _schema_child(self, node, name):
        if isinstance(node, (Container, List)):
            return node.child(name)
        raise SchemaError(f"cannot descend into {node}")

    def _descend(self, segs, create: bool):
        """Walk to the parent of the target, returning (schema_node, dict)."""
        if not segs:
            # top level: pseudo-container holding module roots
            class _Root:
                def child(_self, name):
                    c = self.schema.roots.get(name)
                    if c is None:
                        raise SchemaError(f"no module root {name!r}")
                    return c

            return _Root(), self.root
        name0, key0 = segs[0]
        node = self.schema.roots.get(name0)
        if node is None:
            raise SchemaError(f"no module root {name0!r}")
        data = self.root.setdefault(name0, {}) if create else self.root[name0]
        segs = segs[1:]
        cur_key = key0
        for name, key in segs:
            child = node.child(name)
            if isinstance(child, List):
                if key is None:
                    raise SchemaError(f"list {name} requires [key]")
                entries = data.setdefault(name, {}) if create else data[name]
                if create:
                    entry = entries.setdefault(key, {})
                    entry.setdefault(child.key, child.child(child.key).check(key))
                else:
                    entry = entries[key]
                node, data = child, entry
            elif isinstance(child, Container):
                data = data.setdefault(name, {}) if create else data[name]
                node = child
            else:
                raise SchemaError(f"cannot descend through leaf {name}")
        return node, data

    # -- serialization (ietf-json-shaped)

    def to_json(self) -> str:
        def enc(o):
            return str(o)

        return json.dumps(self.root, default=enc, sort_keys=True, indent=2)

    @classmethod
    def from_json(cls, schema: Schema, text: str) -> "DataTree":
        tree = cls(schema)
        raw = json.loads(text) if text.strip() else {}
        tree._load(raw)
        return tree

    def _load(self, raw: dict) -> None:
        """Validate a raw nested dict into the tree (used by from_json)."""

        def walk(snode, rdata, out):
            for name, val in rdata.items():
                child = snode.child(name)
                if isinstance(child, Leaf):
                    out[name] = child.check(val)
                elif isinstance(child, LeafList):
                    out[name] = child.check(val)
                elif isinstance(child, Container):
                    out[name] = {}
                    walk(child, val, out[name])
                elif isinstance(child, List):
                    out[name] = {}
                    for key, entry in val.items():
                        e = out[name].setdefault(key, {})
                        walk(child, entry, e)
                        e.setdefault(child.key, child.child(child.key).check(key))

        for root_name, val in raw.items():
            root = self.schema.roots.get(root_name)
            if root is None:
                raise SchemaError(f"no module root {root_name!r}")
            self.root[root_name] = {}
            walk(root, val, self.root[root_name])


def diff_trees(old: DataTree, new: DataTree) -> list[DiffOp]:
    """Ordered structural diff (creates parent-first, deletes child-first)."""
    ops: list[DiffOp] = []

    def walk(snode, opath, odata, ndata):
        names = list(dict.fromkeys(list(odata.keys()) + list(ndata.keys())))
        for name in names:
            child = snode.child(name)
            p = f"{opath}/{name}" if opath else name
            in_old, in_new = name in odata, name in ndata
            if isinstance(child, Leaf):
                if in_old and not in_new:
                    ops.append(DiffOp(DiffKind.DELETE, p, odata[name]))
                elif not in_old and in_new:
                    ops.append(DiffOp(DiffKind.CREATE, p, ndata[name]))
                elif odata[name] != ndata[name]:
                    ops.append(DiffOp(DiffKind.MODIFY, p, ndata[name]))
            elif isinstance(child, LeafList):
                if odata.get(name) != ndata.get(name):
                    kind = (
                        DiffKind.DELETE
                        if not in_new
                        else (DiffKind.CREATE if not in_old else DiffKind.MODIFY)
                    )
                    ops.append(DiffOp(kind, p, ndata.get(name)))
            elif isinstance(child, Container):
                if in_old and not in_new:
                    walk(child, p, odata[name], {})
                    ops.append(DiffOp(DiffKind.DELETE, p))
                elif not in_old and in_new:
                    ops.append(DiffOp(DiffKind.CREATE, p))
                    walk(child, p, {}, ndata[name])
                else:
                    walk(child, p, odata[name], ndata[name])
            elif isinstance(child, List):
                okeys = odata.get(name, {}) if in_old else {}
                nkeys = ndata.get(name, {}) if in_new else {}
                for key in dict.fromkeys(list(okeys.keys()) + list(nkeys.keys())):
                    ep = f"{p}[{key}]"
                    if key in okeys and key not in nkeys:
                        walk(child, ep, okeys[key], {})
                        ops.append(DiffOp(DiffKind.DELETE, ep))
                    elif key not in okeys and key in nkeys:
                        ops.append(DiffOp(DiffKind.CREATE, ep))
                        walk(child, ep, {}, nkeys[key])
                    else:
                        walk(child, ep, okeys[key], nkeys[key])

    class _Root:
        def child(_self, name):
            c = old.schema.roots.get(name)
            if c is None:
                raise SchemaError(f"no module root {name!r}")
            return c

    walk(_Root(), "", old.root, new.root)
    return ops
