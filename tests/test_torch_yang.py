"""The port's YANG data model (``holo_tpu_torch.yang``) against
``holo_tpu.yang`` on the CPU.

- ``full_schema`` is equal node for node (kind, and every field of every
  leaf, leaf-list, list and container);
- seeded configuration scripts (every node of the schema reachable, values
  drawn per leaf type) build equal ``DataTree``s through ``set``: equal
  ``get`` of every path set, equal ``to_json`` text, each package's
  ``from_json`` reads the other's text, and ``diff_trees`` between two
  seeded trees gives equal operations;
- ``to_xml`` text and ``to_lyb`` bytes of the plain trees are equal, and
  each package decodes the other's.

Tolerance: exact (text, bytes, and values as strings).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from holo_tpu.yang import data as jdata
from holo_tpu.yang import modules as jmodules
from holo_tpu.yang import schema as jschema
from holo_tpu.yang import serde as jserde
from holo_tpu_torch.yang import data as tdata
from holo_tpu_torch.yang import modules as tmodules
from holo_tpu_torch.yang import schema as tschema
from holo_tpu_torch.yang import serde as tserde

SEEDS = range(6)
PACKAGES = {"jax": (jschema, jdata, jmodules, jserde),
            "port": (tschema, tdata, tmodules, tserde)}


def _node_dict(node) -> dict:
    """A schema node as plain data: its class name and fields, children
    recursively."""
    out = {"kind": type(node).__name__}
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if f.name == "children":
            v = {name: _node_dict(c) for name, c in v.items()}
        out[f.name] = v
    return out


def test_full_schema_is_equal_node_for_node():
    got = {n: _node_dict(c) for n, c in tmodules.full_schema().roots.items()}
    want = {n: _node_dict(c) for n, c in jmodules.full_schema().roots.items()}
    assert got == want
    assert {"interfaces", "routing", "key-chains", "routing-policy", "system"} <= set(got)


def _value(rng, node) -> object:
    """A JSON-plain value valid for a leaf (or one entry of a leaf-list)."""
    t = node.type
    if t == "enum":
        return str(rng.choice(node.enum))
    if t == "boolean":
        return bool(rng.integers(0, 2))
    if t in ("uint8", "uint16", "uint32", "int32"):
        hi = {"uint8": 255, "uint16": 65535, "uint32": 2**32 - 1, "int32": 2**31 - 1}[t]
        return int(rng.integers(0, min(hi, 10**6) + 1))
    if t == "ip":
        return f"10.{rng.integers(0, 256)}.{rng.integers(0, 256)}.{rng.integers(1, 255)}"
    if t == "prefix":
        return f"10.{rng.integers(0, 256)}.{rng.integers(0, 256)}.0/24"
    if t == "ifaddr":
        return f"10.{rng.integers(0, 256)}.{rng.integers(0, 256)}.{rng.integers(1, 255)}/24"
    return f"s{rng.integers(0, 1000)}"


def _script(schema, seed: int) -> list[tuple[str, object]]:
    """(path, value) edits that set leaves all over the schema: each child
    of a container taken with probability 0.85, lists with one or two
    entries keyed by a value of the key leaf's type."""
    rng = np.random.default_rng(seed)
    out: list[tuple[str, object]] = []

    def walk(node, path):
        for name, child in node.children.items():
            p = f"{path}/{name}" if path else name
            if rng.random() > 0.85:
                continue
            kind = type(child).__name__
            if kind == "Leaf":
                out.append((p, _value(rng, child)))
            elif kind == "LeafList":
                out.append((p, [_value(rng, child) for _ in range(int(rng.integers(1, 4)))]))
            elif kind == "List":
                for _ in range(int(rng.integers(1, 3))):
                    key = str(_value(rng, child.children[child.key]))
                    walk(type("Entry", (), {"children": {
                        n: c for n, c in child.children.items() if n != child.key}}),
                         f"{p}[{key}]")
            else:
                walk(child, p)

    for name, root in schema.roots.items():
        walk(root, name)
    return out


def _build(pkg: str, seed: int):
    schema_mod, data_mod, modules_mod, _ = PACKAGES[pkg]
    schema = modules_mod.full_schema()
    tree = data_mod.DataTree(schema)
    script = _script(schema, seed)
    for path, value in script:
        tree.set(path, value)
    return tree, script


def _plain(pkg: str, tree) -> dict:
    serde = PACKAGES[pkg][3]
    return json.loads(json.dumps(
        {name: serde.config_to_plain(tree.schema.roots.get(name), val)
         for name, val in tree.root.items()}, default=str))


@pytest.mark.parametrize("seed", SEEDS)
def test_datatree_set_get_and_json_are_equal(seed):
    port, script = _build("port", seed)
    jax, jscript = _build("jax", seed)
    assert script == jscript and len(script) > 10
    for path, _ in script:
        assert str(port.get(path)) == str(jax.get(path)), path
    text = port.to_json()
    assert text == jax.to_json()
    # Each package reads the other's text back to the same tree.
    assert tdata.DataTree.from_json(port.schema, jax.to_json()).to_json() == text
    assert jdata.DataTree.from_json(jax.schema, text).to_json() == text


@pytest.mark.parametrize("seed", SEEDS)
def test_diff_trees_is_equal(seed):
    def ops(pkg):
        a, _ = _build(pkg, seed)
        b, _ = _build(pkg, seed + 100)
        data_mod = PACKAGES[pkg][1]
        return [(op.kind.value, op.path, str(op.value)) for op in data_mod.diff_trees(a, b)]

    got = ops("port")
    assert got == ops("jax")
    assert len(got) > 10 and {"create", "delete"} <= {k for k, _, _ in got}


@pytest.mark.parametrize("seed", SEEDS)
def test_xml_text_and_lyb_bytes_are_equal(seed):
    port = _plain("port", _build("port", seed)[0])
    jax = _plain("jax", _build("jax", seed)[0])
    assert port == jax
    xml = tserde.to_xml(port, "config")
    assert xml == jserde.to_xml(jax, "config")
    lyb = tserde.to_lyb(port)
    assert lyb == jserde.to_lyb(jax) and len(lyb) > 100
    assert tserde.from_xml(xml) == jserde.from_xml(xml)
    assert tserde.from_lyb(lyb) == jserde.from_lyb(lyb) == port
