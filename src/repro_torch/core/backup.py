"""CURP backup replica: ordered, durable log of executed operations.

CURP does not change the backup mechanism (§3.6): this is standard
primary-backup log replication.  Entries are (op, result) in master execution
order; restoring a master = replaying the log into a fresh state machine
(which also rebuilds the RIFL completion records, since ops carry rpc_ids and
results ride along — the parenthetical in §3.3).

Zombie defense (§4.7): backups track the master epoch published by the
configuration manager and reject sync RPCs from deposed masters.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

from .types import BackupSyncReq, BackupSyncResp, Op


@dataclass
class LogEntry:
    op: Op
    result: Any


class Backup:
    def __init__(self, backup_id: int) -> None:
        self.backup_id = backup_id
        self.log: List[LogEntry] = []
        self.current_epoch = 0
        # Out-of-order segments (network reordering between independent sync
        # RPCs): held durably, applied once the gap fills.  get_log() exposes
        # only the contiguous prefix.
        self._pending: dict[int, Tuple[Any, ...]] = {}
        self.stats = {"syncs": 0, "entries": 0, "rejected_epoch": 0,
                      "buffered": 0}

    def set_epoch(self, epoch: int) -> None:
        """Configuration manager bumps the epoch when a new master takes over;
        sync RPCs from older epochs (zombies) are rejected afterwards."""
        self.current_epoch = max(self.current_epoch, epoch)

    def handle_sync(self, req: BackupSyncReq) -> BackupSyncResp:
        if req.epoch < self.current_epoch:
            self.stats["rejected_epoch"] += 1
            return BackupSyncResp(ok=False, synced_through=len(self.log))
        self.current_epoch = req.epoch
        if req.from_index > len(self.log):
            # Gap: an earlier segment is still in flight (reordering).  Hold
            # this one durably and apply once contiguous.
            self._pending[req.from_index] = req.entries
            self.stats["buffered"] += 1
            return BackupSyncResp(ok=True, synced_through=len(self.log))
        # Idempotent append (retries may resend a suffix we already hold).
        new = req.entries[len(self.log) - req.from_index:]
        for op, result in new:
            self.log.append(LogEntry(op, result))
        # Drain any buffered segments that are now contiguous.
        while True:
            for start in list(self._pending):
                if start <= len(self.log):
                    ents = self._pending.pop(start)
                    for op, result in ents[len(self.log) - start:]:
                        self.log.append(LogEntry(op, result))
                    break
            else:
                break
        self.stats["syncs"] += 1
        self.stats["entries"] += len(new)
        return BackupSyncResp(ok=True, synced_through=len(self.log))

    def get_log(self) -> Tuple[LogEntry, ...]:
        return tuple(self.log)

    def __len__(self) -> int:
        return len(self.log)
