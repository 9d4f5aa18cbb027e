"""Alternate data-tree encodings: XML and a compact binary (LYB-lite).

The reference's gRPC client negotiates JSON / XML / LYB for GetRequest
payloads (holo/proto + holo-yang/src/serde/).  JSON is our native tree
form; this module adds:

- :func:`to_xml` / :func:`from_xml` — YANG-XML-shaped encoding: one
  element per node, repeated elements for list entries and leaf-lists
  (namespace declarations are omitted — the YANG-lite schema is
  single-namespace-per-mount, like the daemon's module set);
- :func:`to_lyb` / :func:`from_lyb` — a deterministic length-prefixed
  binary encoding of the same structure.  This is OUR compact format in
  the role libyang's LYB plays for the reference (the on-the-wire bytes
  are not libyang-compatible).
"""

from __future__ import annotations

import json
import re
import struct
from xml.etree import ElementTree as ET

_XML_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_.-]*$")


def _scalar_str(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def _node_to_xml(parent: ET.Element, name: str, value) -> None:
    if not _XML_NAME.match(str(name)):
        # Ad-hoc state maps key entries by values (prefixes, addresses)
        # that are not legal element names: emit a keyed entry element.
        el = ET.SubElement(parent, "entry", key=str(name))
        if isinstance(value, dict):
            for cname, cval in sorted(value.items(), key=lambda kv: str(kv[0])):
                _node_to_xml(el, cname, cval)
        else:
            el.text = _scalar_str(value)
        return
    if isinstance(value, dict):
        el = ET.SubElement(parent, name)
        for cname, cval in sorted(value.items(), key=lambda kv: str(kv[0])):
            _node_to_xml(el, cname, cval)
    elif isinstance(value, list):
        for item in value:
            if isinstance(item, dict):
                el = ET.SubElement(parent, name)
                for cname, cval in sorted(item.items()):
                    _node_to_xml(el, cname, cval)
            else:
                ET.SubElement(parent, name).text = _scalar_str(item)
    else:
        ET.SubElement(parent, name).text = _scalar_str(value)


def to_xml(root: dict, root_tag: str = "data") -> str:
    """Nested dict/list tree -> XML text.

    Dicts are containers, lists repeat their element (YANG-XML list
    semantics).  CONFIG trees store lists as {key: entry} maps — run
    them through :func:`config_to_plain` first so keyed maps become
    key-leaf-carrying entry lists (otherwise key values would end up as
    element names, which is not well-formed for IPs/prefixes)."""
    top = ET.Element(root_tag)
    for name, value in sorted(root.items()):
        _node_to_xml(top, name, value)
    ET.indent(top)
    return ET.tostring(top, encoding="unicode")


def config_to_plain(schema_node, value):
    """Schema-aware normalization of a DataTree fragment: every keyed
    list map {key: entry} becomes a list of entries with the key leaf
    re-injected, recursively.  ``schema_node`` is the yang.schema node
    the fragment sits at (a Schema root Container, List, or None for
    unmodeled/ad-hoc state, which passes through untouched)."""
    from holo_tpu_torch.yang.schema import Container, List

    if isinstance(schema_node, List) and isinstance(value, dict):
        out = []
        for key, entry in sorted(value.items(), key=lambda kv: str(kv[0])):
            if not isinstance(entry, dict):
                entry = {}
            plain = {
                cname: config_to_plain(
                    schema_node.children.get(cname), cval
                )
                for cname, cval in entry.items()
            }
            plain.setdefault(schema_node.key, _scalar_str(key))
            out.append(plain)
        return out
    if isinstance(schema_node, (Container, List)) and isinstance(value, dict):
        return {
            cname: config_to_plain(schema_node.children.get(cname), cval)
            for cname, cval in value.items()
        }
    return value


def _xml_to_value(el: ET.Element):
    children = list(el)
    if not children:
        return el.text or ""
    out: dict = {}
    for c in children:
        v = _xml_to_value(c)
        tag = c.get("key") if c.tag == "entry" else c.tag
        if tag in out:
            prev = out[tag]
            if not isinstance(prev, list):
                out[tag] = [prev]
            out[tag].append(v)
        else:
            out[tag] = v
    return out


def from_xml(text: str) -> dict:
    """XML text -> plain nested dict (lists where elements repeat)."""
    top = ET.fromstring(text)
    out: dict = {}
    for c in top:
        v = _xml_to_value(c)
        if c.tag in out:
            prev = out[c.tag]
            if not isinstance(prev, list):
                out[c.tag] = [prev]
            out[c.tag].append(v)
        else:
            out[c.tag] = v
    return out


# ===== LYB-lite =====

_T_DICT, _T_LIST, _T_STR, _T_INT, _T_BOOL, _T_NONE = range(6)


def _w_bytes(out: bytearray, b: bytes) -> None:
    out += struct.pack(">I", len(b)) + b


def _encode(out: bytearray, v) -> None:
    if isinstance(v, dict):
        out.append(_T_DICT)
        out += struct.pack(">I", len(v))
        for k in sorted(v, key=str):
            _w_bytes(out, str(k).encode())
            _encode(out, v[k])
    elif isinstance(v, (list, tuple)):
        out.append(_T_LIST)
        out += struct.pack(">I", len(v))
        for item in v:
            _encode(out, item)
    elif isinstance(v, bool):
        out.append(_T_BOOL)
        out.append(1 if v else 0)
    elif isinstance(v, int):
        out.append(_T_INT)
        out += struct.pack(">q", v)
    elif v is None:
        out.append(_T_NONE)
    else:
        out.append(_T_STR)
        _w_bytes(out, str(v).encode())


def to_lyb(root: dict) -> bytes:
    out = bytearray(b"HLYB\x01")
    _encode(out, root)
    return bytes(out)


def _decode(buf: bytes, pos: int):
    t = buf[pos]
    pos += 1
    if t == _T_DICT:
        (n,) = struct.unpack_from(">I", buf, pos)
        pos += 4
        out = {}
        for _ in range(n):
            (klen,) = struct.unpack_from(">I", buf, pos)
            pos += 4
            k = buf[pos : pos + klen].decode()
            pos += klen
            out[k], pos = _decode(buf, pos)
        return out, pos
    if t == _T_LIST:
        (n,) = struct.unpack_from(">I", buf, pos)
        pos += 4
        items = []
        for _ in range(n):
            v, pos = _decode(buf, pos)
            items.append(v)
        return items, pos
    if t == _T_STR:
        (n,) = struct.unpack_from(">I", buf, pos)
        pos += 4
        return buf[pos : pos + n].decode(), pos + n
    if t == _T_INT:
        (v,) = struct.unpack_from(">q", buf, pos)
        return v, pos + 8
    if t == _T_BOOL:
        return bool(buf[pos]), pos + 1
    if t == _T_NONE:
        return None, pos
    raise ValueError(f"bad LYB tag {t}")


def from_lyb(data: bytes) -> dict:
    if data[:5] != b"HLYB\x01":
        raise ValueError("not an HLYB v1 payload")
    out, _pos = _decode(data, 5)
    return out
