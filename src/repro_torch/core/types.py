"""Core protocol types for CURP (Consistent Unordered Replication Protocol).

Everything here is transport-agnostic: the discrete-event simulator (repro.sim)
and the local in-process harness (repro.core.local) both drive these same
dataclasses through the same state machines.

Key hashing follows the paper (§4.2): commutativity checks compare 64-bit
hashes of primary keys, not full keys.  We use splitmix64, the same avalanche
mixer validated in the gang kernels (repro_torch/kernels/csrc/keyhash.cuh).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple

MASK64 = (1 << 64) - 1

# RPC identity per RIFL: (client_id, per-client monotonically increasing seq).
RpcId = Tuple[int, int]


def splitmix64(x: int) -> int:
    """SplitMix64 finalizer: a cheap, well-avalanched 64-bit mixer."""
    x = (x + 0x9E3779B97F4A7C15) & MASK64
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return (z ^ (z >> 31)) & MASK64


def keyhash(key: Any) -> int:
    """64-bit primary-key hash used for all commutativity checks."""
    if isinstance(key, int):
        return splitmix64(key)
    if isinstance(key, str):
        key = key.encode()
    h = 0xCBF29CE484222325  # FNV-1a over the bytes, then splitmix finish.
    for b in key:
        h = ((h ^ b) * 0x100000001B3) & MASK64
    return splitmix64(h)


class OpType(enum.Enum):
    SET = "SET"
    GET = "GET"
    INCR = "INCR"
    HMSET = "HMSET"       # hashmap member set (Redis-style, Fig. 10)
    MSET = "MSET"         # multi-key atomic set (exercises multi-key witness path)
    DEL = "DEL"
    NOOP = "NOOP"
    # CRDT-flavoured merge ops (repro.core.merge): commute with themselves
    # by construction, so the widened witness check admits concurrent
    # same-key pairs on the 1-RTT fast path.
    SADD = "SADD"         # set-add (union merge)
    APPEND = "APPEND"     # append (canonical sorted-chunks merge)
    MAX = "MAX"           # bounded max (idempotent, commutative)
    # Mini-transaction subsystem (repro.core.txn): single-shard atomic
    # read+write op, and the per-shard legs of the RIFL-identified 2PC.
    TXN = "TXN"                   # single-shard read-set + write-set, 1 RTT
    TXN_PREPARE = "TXN_PREPARE"   # participant: install intent + lock keys
    TXN_COMMIT = "TXN_COMMIT"     # participant: apply write-set, drop intent
    TXN_ABORT = "TXN_ABORT"       # participant: drop intent (or tombstone)
    # Live reconfiguration (repro.core.migration): slot-handover transfer
    # legs.  Issued only by the MigrationManager, never by clients; they ride
    # the masters' ordinary log + backup-sync machinery so a moved slot's
    # data (and its RIFL completion records) survive either side crashing.
    MIGRATE_IN = "MIGRATE_IN"     # receiver: absorb (kvs, rifl records)
    MIGRATE_OUT = "MIGRATE_OUT"   # donor: durably drop the moved keys


# Which ops are updates (need durability) vs reads.
UPDATE_OPS = {OpType.SET, OpType.INCR, OpType.HMSET, OpType.MSET, OpType.DEL,
              OpType.SADD, OpType.APPEND, OpType.MAX,
              OpType.TXN, OpType.TXN_PREPARE, OpType.TXN_COMMIT,
              OpType.TXN_ABORT, OpType.MIGRATE_IN, OpType.MIGRATE_OUT}

# The 2PC leg ops (never issued by clients directly; the coordinator in
# repro.core.txn drives them).
TXN_OPS = {OpType.TXN_PREPARE, OpType.TXN_COMMIT, OpType.TXN_ABORT}


@dataclass(frozen=True)
class Op:
    """A client operation = the unit of replication.

    ``keys`` is the full affected key set (one entry for single-key ops).
    ``args`` carries values (SET payload, HMSET field/value, ...).
    """
    op_type: OpType
    keys: Tuple[Any, ...]
    args: Tuple[Any, ...] = ()
    rpc_id: RpcId = (0, 0)

    @property
    def is_update(self) -> bool:
        return self.op_type in UPDATE_OPS

    def key_hashes(self) -> Tuple[int, ...]:
        # Memoized: the hot paths (witness records, window checks, gc entry
        # building) re-ask several times per op; keys are frozen.
        khs = self.__dict__.get("_khs")
        if khs is None:
            khs = tuple(keyhash(k) for k in self.keys)
            object.__setattr__(self, "_khs", khs)
        return khs

    def hash_classes(self) -> Tuple[Tuple[int, int], ...]:
        """Memoized ``(key_hash, merge-class)`` pairs (repro.core.merge).

        This is the commutativity identity of the op: what witnesses record,
        masters refcount in the unsynced window, and gc entries enumerate.
        ``key_hashes()`` stays the ROUTING identity (one hash per key);
        HMSET's derived per-field FIELD pairs appear only here."""
        hcs = self.__dict__.get("_hcs")
        if hcs is None:
            from .merge import op_hash_classes   # lazy: merge imports types

            hcs = tuple(op_hash_classes(self))
            object.__setattr__(self, "_hcs", hcs)
        return hcs


class RecordStatus(enum.Enum):
    ACCEPTED = "ACCEPTED"
    REJECTED = "REJECTED"


class WitnessMode(enum.Enum):
    NORMAL = "NORMAL"
    RECOVERY = "RECOVERY"   # irreversible after getRecoveryData (§4.1)
    ENDED = "ENDED"


@dataclass
class ExecResult:
    """Master's reply to an update/read RPC."""
    value: Any
    synced: bool            # True => master synced before replying (§3.2.3 tag)
    ok: bool = True
    error: Optional[str] = None   # e.g. "WRONG_WITNESS_VERSION", "NOT_OWNER"


@dataclass
class CompletionRecord:
    """RIFL completion record: durable (rpc_id -> result) pair."""
    rpc_id: RpcId
    result: Any
    synced: bool = False    # replicated to backups yet?


# ---------------------------------------------------------------------------
# RPC message payloads (Fig. 4 of the paper + the client<->master RPCs).
# The simulator wraps these in envelopes with src/dst/time.
# ---------------------------------------------------------------------------

@dataclass
class UpdateReq:
    op: Op
    witness_list_version: int
    client_acks: Tuple[Tuple[int, int], ...] = ()  # RIFL piggybacked acks


@dataclass
class UpdateResp:
    rpc_id: RpcId
    result: ExecResult


@dataclass
class ReadReq:
    op: Op


@dataclass
class ReadResp:
    rpc_id: RpcId
    result: ExecResult


@dataclass
class SyncReq:
    """Client asks master to flush unsynced ops (slow path)."""
    rpc_id: RpcId           # the op the client is trying to make durable


@dataclass
class SyncResp:
    rpc_id: RpcId
    ok: bool


@dataclass
class RecordReq:
    """CLIENT -> WITNESS (Fig. 4): record(masterID, keyHashes, rpcId, request)."""
    master_id: int
    key_hashes: Tuple[int, ...]
    rpc_id: RpcId
    request: Op


@dataclass
class RecordResp:
    rpc_id: RpcId
    status: RecordStatus


@dataclass
class GcReq:
    """MASTER -> WITNESS: gc(list of {keyHash, rpcId})."""
    entries: Tuple[Tuple[int, RpcId], ...]


@dataclass
class GcResp:
    stale_requests: Tuple[Op, ...]   # suspected uncollected garbage (§4.5)


@dataclass
class GetRecoveryDataReq:
    master_id: int


@dataclass
class GetRecoveryDataResp:
    requests: Tuple[Op, ...]


@dataclass
class StartWitnessReq:
    master_id: int


@dataclass
class EndWitnessReq:
    pass


@dataclass
class BackupSyncReq:
    """MASTER -> BACKUP: ordered log segment [from_index, from_index+len)."""
    master_id: int
    epoch: int               # master epoch; backups reject stale masters (§4.7)
    from_index: int
    entries: Tuple[Any, ...]  # (op, result) pairs, order = master execution order


@dataclass
class BackupSyncResp:
    ok: bool
    synced_through: int


@dataclass
class ClusterConfig:
    """Published by the configuration manager (§3.6)."""
    master_id: int
    epoch: int
    backup_ids: Tuple[int, ...]
    witness_ids: Tuple[int, ...]
    witness_list_version: int
