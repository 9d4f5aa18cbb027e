"""Non-volatile key/value store (daemon durable state).

Equivalent of the reference's pickledb instance (holo-daemon/src/main.rs:148-157):
a small JSON file holding state that must survive daemon restarts — the
OSPF auth seqno reservation ceiling (the restart-safe analog of the
reference's boot-count seeding, holo-ospf/src/instance.rs:231,257-258),
boot counters (operational state), graceful-restart info, and anything
else a protocol registers.  Writes are atomic (tmp + fsync + rename) and
flushed on every put, mirroring pickledb's AutoDump policy.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path

log = logging.getLogger("holo_tpu_torch.nvstore")


class NvStore:
    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        self._data: dict = {}
        if self.path.exists():
            try:
                self._data = json.loads(self.path.read_text())
            except (OSError, ValueError):
                # Starting empty silently would reuse auth seqnos and strand
                # adjacencies until dead-interval expiry — make it loud.
                log.warning(
                    "non-volatile store %s unreadable: durable state "
                    "(auth seqno ceilings, boot counts) has been RESET",
                    self.path,
                )

    def get(self, key: str, default=None):
        return self._data.get(key, default)

    def put(self, key: str, value) -> None:
        self._data[key] = value
        self._flush()

    def incr(self, key: str) -> int:
        """Atomically bump an integer counter; returns the new value."""
        val = int(self._data.get(key, 0)) + 1
        self.put(key, val)
        return val

    def _flush(self) -> None:
        tmp = self.path.with_suffix(self.path.suffix + ".tmp")
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(tmp, "w") as f:
            f.write(json.dumps(self._data))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        # Durability of the rename itself: fsync the directory, or a crash
        # can revert to the old file and re-issue an already-used boot count.
        dirfd = os.open(self.path.parent, os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
