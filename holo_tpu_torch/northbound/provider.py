"""Provider-side interface: config callbacks keyed by schema path.

Reference: holo-northbound/src/configuration.rs (Prepare/Abort/Apply
:33-43, CallbacksBuilder :70, validation :90), state.rs, rpc.rs.
"""

from __future__ import annotations

import enum
import fnmatch
from dataclasses import dataclass, field
from typing import Any, Callable

from holo_tpu_torch.yang.data import DiffOp


class CommitPhase(enum.Enum):
    PREPARE = "prepare"
    ABORT = "abort"
    APPLY = "apply"


class CommitError(Exception):
    """Raised by a provider in Prepare to veto a transaction."""


@dataclass
class Callbacks:
    """Path-pattern keyed callbacks.  Patterns use fnmatch over canonical
    paths with list keys stripped to '*': e.g.
    ``routing/control-plane-protocols/ospfv2/area[*]/interface[*]/cost``."""

    config: dict[str, Callable] = field(default_factory=dict)
    rpcs: dict[str, Callable] = field(default_factory=dict)
    state: dict[str, Callable] = field(default_factory=dict)

    def match_config(self, path: str) -> Callable | None:
        norm = _normalize(path)
        cb = self.config.get(norm)
        if cb is not None:
            return cb
        for pat, cb in self.config.items():
            if fnmatch.fnmatch(norm, pat):
                return cb
        return None


def _normalize(path: str) -> str:
    """Replace concrete list keys with '*': a/b[x]/c -> a/b[*]/c."""
    out = []
    depth = 0
    for ch in path:
        if ch == "[":
            depth += 1
            out.append("[*")
        elif ch == "]":
            depth -= 1
            out.append("]")
        elif depth == 0:
            out.append(ch)
    return "".join(out)


class Provider:
    """A northbound provider (base system component or protocol master).

    Lifecycle per transaction: validate(new_tree) on all providers; then
    Prepare fan-out (CommitError vetoes); Apply or Abort.  Providers see
    only the changes matching their subtree prefix.
    """

    name = "provider"
    subtree_prefixes: tuple[str, ...] = ()

    def callbacks(self) -> Callbacks:
        return Callbacks()

    def validate(self, new_tree) -> None:
        """Raise CommitError to reject the candidate."""

    def filter_changes(self, changes: list[DiffOp]) -> list[DiffOp]:
        if not self.subtree_prefixes:
            return changes
        return [
            c
            for c in changes
            if any(c.path.startswith(p) for p in self.subtree_prefixes)
        ]

    def commit(self, phase: CommitPhase, old_tree, new_tree, changes: list[DiffOp]) -> None:
        """Default: dispatch each change to a matching config callback."""
        cbs = self.callbacks()
        for change in changes:
            cb = cbs.match_config(change.path)
            if cb is not None:
                cb(phase, change, old_tree, new_tree)

    def get_state(self, path: str | None = None) -> dict:
        """Operational state subtree (merged into GetState responses)."""
        return {}

    def rpc(self, name: str, input: dict) -> dict:
        raise KeyError(f"unknown rpc {name}")
