"""The NoSQL state machine that CURP replicates (§4).

A single substrate stands in for both evaluation targets of the paper
(RAMCloud and Redis): a key->value map where values are strings, counters, or
hashmaps.  ``execute`` is deterministic, so backup replay and witness replay
reproduce master state exactly.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from .types import Op, OpType


# --- CRDT merge-op value semantics (repro.core.merge) -----------------------
# These three pure functions ARE the merge semantics: the store executes
# them, and sim.linearizability imports THEM (not re-implementations) so the
# checker's legality model cannot drift from the state machine.  Each is
# order-insensitive over concurrent applications of its own class, which is
# what makes the widened witness admissions linearizable.

def merge_sadd(cur: Any, member: Any) -> frozenset:
    """Set-union add.  A non-set prior value is superseded (SADD || SET is
    a lattice CONFLICT, so the overwrite is only reachable sequentially)."""
    base = cur if isinstance(cur, frozenset) else frozenset()
    return base | {member}


def merge_append(cur: Any, chunk: Any) -> Tuple[Any, ...]:
    """Append under the CANONICAL sorted-chunks value: the stored value is
    the sorted tuple of appended chunks, so any serialization of concurrent
    appends — and any witness-replay order — converges bit-identically."""
    if isinstance(cur, tuple):
        base = cur
    elif cur is None:
        base = ()
    else:
        base = (cur,)
    return tuple(sorted(base + (chunk,), key=repr))


def merge_max(cur: Any, n: Any) -> Any:
    """Bounded max: commutative and idempotent over numeric values; a
    non-numeric prior value is superseded (sequential-only, as above)."""
    if isinstance(cur, (int, float)) and isinstance(n, (int, float)):
        return max(cur, n)
    return n


@dataclass
class VersionedValue:
    value: Any
    version: int = 0
    # Timestamp of last update; masters compare against last-sync timestamp to
    # decide "is this object unsynced?" when not log-structured (§4.3).
    last_update: float = 0.0


class KVStore:
    """Deterministic key-value state machine.

    Mini-transaction state (repro.core.txn) lives INSIDE the store: prepared
    intents and their key locks are installed/dropped by executing the
    TXN_PREPARE / TXN_COMMIT / TXN_ABORT ops, so backup-log restore and
    witness replay rebuild them for free — a recovered master re-surfaces
    every undecided intent without any side-channel state.
    """

    def __init__(self) -> None:
        self._data: Dict[Any, VersionedValue] = {}
        # txn_id -> (TxnSpec, TxnPart): this store's prepared intents.
        self._intents: Dict[Tuple[int, int], Tuple[Any, Any]] = {}
        # key -> txn_id holding the intent lock on it.
        self._locks: Dict[Any, Tuple[int, int]] = {}

    # -- mutation -----------------------------------------------------------
    def execute(self, op: Op, now: float = 0.0) -> Any:
        t = op.op_type
        if t == OpType.TXN:
            # Single-shard atomic read-set + write-set: reads are taken
            # BEFORE the writes land (mini-transaction compare/read rule).
            spec, shard_id = op.args
            part = spec.part_on(shard_id)
            reads = tuple(self.get(k) for k in part.read_keys)
            for key, value in part.write_kvs:
                self._set(key, value, now)
            return ("COMMITTED", reads)
        if t == OpType.TXN_PREPARE:
            spec, shard_id = op.args
            part = spec.part_on(shard_id)
            self._intents[spec.txn_id] = (spec, part)
            for k in part.keys:
                self._locks[k] = spec.txn_id
            # Read values are stable until the decision: the locks block
            # every overlapping writer, so a prepare retry re-reads the
            # same values.
            reads = tuple(self.get(k) for k in part.read_keys)
            return ("PREPARED", reads)
        if t == OpType.TXN_COMMIT:
            spec, shard_id = op.args
            part = spec.part_on(shard_id)
            self._drop_intent(spec.txn_id, part)
            for key, value in part.write_kvs:
                self._set(key, value, now)
            return "COMMITTED"
        if t == OpType.TXN_ABORT:
            spec, shard_id = op.args
            part = spec.part_on(shard_id)
            self._drop_intent(spec.txn_id, part)
            return "ABORTED"
        if t == OpType.MIGRATE_IN:
            # Slot-handover absorb (repro.core.migration): install the moved
            # key/value snapshot.  args = (kvs, rifl_records); the records
            # are master-side state (Master._install_migrated), not store
            # state.  Idempotent — a crash-resumed handover re-sends the
            # full snapshot.
            for key, value in op.args[0]:
                self._set(key, value, now)
            return "OK"
        if t == OpType.MIGRATE_OUT:
            # Donor side of the handover: durably drop the moved keys (the
            # receiver owns them now; backups replay this on restore so a
            # recovered donor never resurrects them).
            n = 0
            for key in op.keys:
                if key in self._data:
                    del self._data[key]
                    n += 1
            return n
        if t == OpType.SET:
            (key,) = op.keys
            (value,) = op.args
            self._set(key, value, now)
            return "OK"
        if t == OpType.DEL:
            (key,) = op.keys
            existed = key in self._data
            self._data.pop(key, None)
            return int(existed)
        if t == OpType.INCR:
            (key,) = op.keys
            delta = op.args[0] if op.args else 1
            cur = self._data.get(key)
            base = cur.value if cur is not None and isinstance(cur.value, int) else 0
            new = base + delta
            self._set(key, new, now)
            return new
        if t == OpType.HMSET:
            (key,) = op.keys
            fields: Tuple[Tuple[Any, Any], ...] = op.args[0]
            cur = self._data.get(key)
            h = dict(cur.value) if cur is not None and isinstance(cur.value, dict) else {}
            for f, v in fields:
                h[f] = v
            self._set(key, h, now)
            return "OK"
        if t == OpType.SADD:
            (key,) = op.keys
            (member,) = op.args
            self._set(key, merge_sadd(self.get(key), member), now)
            return "OK"
        if t == OpType.APPEND:
            (key,) = op.keys
            (chunk,) = op.args
            self._set(key, merge_append(self.get(key), chunk), now)
            return "OK"
        if t == OpType.MAX:
            (key,) = op.keys
            (n,) = op.args
            self._set(key, merge_max(self.get(key), n), now)
            return "OK"
        if t == OpType.MSET:
            for key, value in zip(op.keys, op.args):
                self._set(key, value, now)
            return "OK"
        if t == OpType.GET:
            (key,) = op.keys
            cur = self._data.get(key)
            return None if cur is None else cur.value
        if t == OpType.NOOP:
            return None
        raise ValueError(f"unknown op type {t}")

    def _set(self, key: Any, value: Any, now: float) -> None:
        cur = self._data.get(key)
        if cur is None:
            self._data[key] = VersionedValue(value, 1, now)
        else:
            cur.value = value
            cur.version += 1
            cur.last_update = now

    # -- transaction intents (repro.core.txn) --------------------------------
    def _drop_intent(self, txn_id: Tuple[int, int], part) -> None:
        self._intents.pop(txn_id, None)
        for k in part.keys:
            if self._locks.get(k) == txn_id:
                del self._locks[k]

    def txn_intent(self, txn_id: Tuple[int, int]):
        """The (spec, part) of a prepared-but-undecided intent, or None."""
        return self._intents.get(txn_id)

    def txn_intents(self) -> Dict[Tuple[int, int], Tuple[Any, Any]]:
        return dict(self._intents)

    def txn_lock_conflict(self, keys, txn_id=None):
        """The spec of a FOREIGN transaction holding an intent lock on any of
        these keys (None if unlocked or locked only by ``txn_id``)."""
        for k in keys:
            owner = self._locks.get(k)
            if owner is not None and owner != txn_id:
                return self._intents[owner][0]
        return None

    # -- introspection ------------------------------------------------------
    def keys(self):
        """All live keys (migration scans these to find a slot's residents)."""
        return list(self._data.keys())

    def get(self, key: Any) -> Any:
        cur = self._data.get(key)
        return None if cur is None else cur.value

    def last_update_time(self, key: Any) -> Optional[float]:
        cur = self._data.get(key)
        return None if cur is None else cur.last_update

    def snapshot(self) -> Dict[Any, VersionedValue]:
        import copy

        return copy.deepcopy(self._data)

    def load_snapshot(self, snap: Dict[Any, VersionedValue]) -> None:
        import copy

        self._data = copy.deepcopy(snap)

    def __len__(self) -> int:
        return len(self._data)
