"""Northbound core: the two-phase-commit transaction engine.

Reference: holo-daemon/src/northbound/core.rs — create_transaction
(:393-491), per-provider commit fan-out (:495-539), confirmed-commit
rollback timer (:70-98,633-651), rollback log (:317-338, db.rs).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path

from holo_tpu_torch.northbound.provider import CommitError, CommitPhase, Provider
from holo_tpu_torch.yang.data import DataTree, diff_trees


@dataclass
class Transaction:
    id: int
    timestamp: float
    comment: str
    changes_json: str
    config_json: str  # full running config AFTER this transaction


class Northbound:
    """Owns the running config and serializes transactions across providers."""

    def __init__(self, schema, providers: list[Provider], db_path: Path | None = None):
        self.schema = schema
        self.providers = providers
        self.running = DataTree(schema)
        self.txn_log: list[Transaction] = []
        self._next_txn_id = 1
        self.db_path = db_path
        self._confirmed_pending: tuple[float, str] | None = None  # (deadline, prev cfg)
        if db_path is not None and db_path.exists():
            self._load_db()

    # -- transactions

    def commit(
        self,
        candidate: DataTree,
        comment: str = "",
        confirmed_timeout: float | None = None,
        now: float | None = None,
    ) -> Transaction:
        """Validate + two-phase commit the candidate config.

        Raises CommitError if any provider vetoes in validate/Prepare; the
        Abort fan-out restores provider state in that case.
        """
        now = time.time() if now is None else now
        for p in self.providers:
            p.validate(candidate)
        changes = diff_trees(self.running, candidate)
        if not changes:
            return self._record(comment, changes, now)

        prepared: list[tuple[Provider, list]] = []
        try:
            for p in self.providers:
                pch = p.filter_changes(changes)
                if pch:
                    p.commit(CommitPhase.PREPARE, self.running, candidate, pch)
                    prepared.append((p, pch))
        except CommitError:
            for p, pch in prepared:
                p.commit(CommitPhase.ABORT, self.running, candidate, pch)
            raise

        old_running = self.running
        for p, pch in prepared:
            p.commit(CommitPhase.APPLY, old_running, candidate, pch)
        self.running = candidate.copy()

        if confirmed_timeout is not None:
            self._confirmed_pending = (now + confirmed_timeout, old_running.to_json())
        return self._record(comment, changes, now)

    def confirm(self) -> None:
        """Confirm a pending confirmed-commit (cancels auto-rollback)."""
        self._confirmed_pending = None

    def check_confirmed_timeout(self, now: float) -> bool:
        """Roll back if a confirmed commit expired.  Returns True if rolled."""
        if self._confirmed_pending is None:
            return False
        deadline, prev_json = self._confirmed_pending
        if now < deadline:
            return False
        self._confirmed_pending = None
        prev = DataTree.from_json(self.schema, prev_json)
        self.commit(prev, comment="confirmed-commit rollback", now=now)
        return True

    def rollback(self, txn_id: int) -> Transaction:
        """Restore the configuration recorded by transaction ``txn_id``."""
        for txn in self.txn_log:
            if txn.id == txn_id:
                target = DataTree.from_json(self.schema, txn.config_json)
                return self.commit(target, comment=f"rollback to #{txn_id}")
        raise KeyError(f"no transaction {txn_id}")

    def get_transaction(self, txn_id: int) -> Transaction:
        for txn in self.txn_log:
            if txn.id == txn_id:
                return txn
        raise KeyError(f"no transaction {txn_id}")

    def _record(self, comment, changes, now) -> Transaction:
        txn = Transaction(
            id=self._next_txn_id,
            timestamp=now,
            comment=comment,
            changes_json=json.dumps(
                [
                    {"op": c.kind.value, "path": c.path, "value": str(c.value)}
                    for c in changes
                ]
            ),
            config_json=self.running.to_json(),
        )
        self._next_txn_id += 1
        self.txn_log.append(txn)
        self._save_db()
        return txn

    # -- operational state

    def get_state(self, path: str | None = None) -> dict:
        out: dict = {}
        for p in self.providers:
            sub = p.get_state(path)
            _deep_merge(out, sub)
        return out

    # -- persistence (pickledb equivalent: a JSON file)

    def _save_db(self) -> None:
        if self.db_path is None:
            return
        data = {
            "next_txn_id": self._next_txn_id,
            "transactions": [
                {
                    "id": t.id,
                    "timestamp": t.timestamp,
                    "comment": t.comment,
                    "changes": t.changes_json,
                    "config": t.config_json,
                }
                for t in self.txn_log[-32:]
            ],
        }
        self.db_path.write_text(json.dumps(data))

    def _load_db(self) -> None:
        data = json.loads(self.db_path.read_text())
        self._next_txn_id = data.get("next_txn_id", 1)
        self.txn_log = [
            Transaction(
                id=t["id"],
                timestamp=t["timestamp"],
                comment=t["comment"],
                changes_json=t["changes"],
                config_json=t["config"],
            )
            for t in data.get("transactions", [])
        ]


def _deep_merge(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v
