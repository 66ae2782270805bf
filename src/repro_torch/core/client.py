"""CURP client-side completion logic (§3.2.1).

The decision rule is small and pure, so both harnesses (the in-process
LocalCluster and the discrete-event simulator) share it:

  * master replied with ``synced=True``           -> COMPLETE (conflict path,
      2 RTTs total; no witness accepts needed)
  * master replied fast AND all f witnesses ACCEPTED -> COMPLETE (1 RTT)
  * master replied fast but >=1 witness rejected  -> NEED_SYNC: issue a sync
      RPC to the master; once acked                -> COMPLETE (2-3 RTTs)
  * master error (stale witness list / not owner) -> REFETCH config and retry
"""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

from .types import ExecResult, Op, OpType, RecordStatus, RpcId


class Decision(enum.Enum):
    COMPLETE = "COMPLETE"
    NEED_SYNC = "NEED_SYNC"
    REFETCH_CONFIG = "REFETCH_CONFIG"


def decide(
    result: ExecResult, witness_statuses: Sequence[RecordStatus]
) -> Decision:
    if not result.ok:
        return Decision.REFETCH_CONFIG
    if result.synced:
        return Decision.COMPLETE
    if all(s is RecordStatus.ACCEPTED for s in witness_statuses):
        return Decision.COMPLETE
    return Decision.NEED_SYNC


def decide_multi(
    parts: Sequence[Tuple[ExecResult, Sequence[RecordStatus]]]
) -> Decision:
    """Client completion rule for a multi-shard op (one sub-op per shard).

    COMPLETE means the client owes no further RPCs: every shard's sub-op is
    durable, either via that shard's full witness accept set (1 RTT) or
    because that shard's master tagged its result synced (the master already
    paid the sync before replying — 2 RTTs on that shard, but nothing left
    for the client to do).  A stale config at any shard forces a refetch;
    otherwise NEED_SYNC means the client must issue explicit sync RPCs — but
    only to the shards whose own ``decide`` returned NEED_SYNC.  Note
    COMPLETE is about completion, not latency: the op counts as 1-RTT only
    if additionally every shard's verdict was fast (see ShardedCluster.mset).
    """
    return combine_decisions(decide(result, statuses)
                             for result, statuses in parts)


def combine_decisions(decisions) -> Decision:
    """Fold per-shard ``decide`` outcomes into the op-level decision (the
    single source of truth for both decide_multi and harnesses that already
    hold the per-shard decisions)."""
    decisions = list(decisions)
    if any(d is Decision.REFETCH_CONFIG for d in decisions):
        return Decision.REFETCH_CONFIG
    if all(d is Decision.COMPLETE for d in decisions):
        return Decision.COMPLETE
    return Decision.NEED_SYNC


def decide_commit(votes, n_parts: int) -> bool:
    """Coordinator-side 2PC decision rule (repro.core.txn): COMMIT iff every
    participant leg voted yes — a vote is granted only once that leg's
    prepare is durable (all-witness accept or synced), so this is the same
    completion discipline as ``decide``, lifted to transaction legs.  A
    short vote set (coordinator died mid-prepare-round) can never commit.
    """
    votes = list(votes)
    return len(votes) == n_parts and all(v.granted for v in votes)


@dataclass
class ClientSession:
    """Per-client RIFL identity: rpc_id allocation + ack tracking."""
    client_id: int
    _seq: itertools.count = field(default_factory=lambda: itertools.count(1))
    first_incomplete: int = 1
    _completed: set = field(default_factory=set)

    def next_rpc_id(self) -> RpcId:
        return (self.client_id, next(self._seq))

    def mark_completed(self, rpc_id: RpcId) -> None:
        self._completed.add(rpc_id[1])
        while self.first_incomplete in self._completed:
            self._completed.discard(self.first_incomplete)
            self.first_incomplete += 1

    def abandon(self, rpc_id: RpcId) -> None:
        """Release an allocated identity that was NEVER transmitted to any
        master or witness (e.g. the op drew a SlotMoving redirect at the
        routing stage).  Without this the ack frontier would stall at the
        abandoned seq forever, pinning every later completion record at
        every master.  MUST NOT be called for an op that may have reached a
        master: advancing the frontier past a live op's seq would let its
        completion record be deleted before the client saw the result."""
        self.mark_completed(rpc_id)

    def acks(self) -> Tuple[Tuple[int, int], ...]:
        """Piggybacked RIFL ack: 'I have seen results for all seq < N'."""
        return ((self.client_id, self.first_incomplete),)

    # convenience constructors -------------------------------------------------
    def op_set(self, key, value) -> Op:
        return Op(OpType.SET, (key,), (value,), self.next_rpc_id())

    def op_get(self, key) -> Op:
        return Op(OpType.GET, (key,), (), self.next_rpc_id())

    def op_incr(self, key, delta: int = 1) -> Op:
        return Op(OpType.INCR, (key,), (delta,), self.next_rpc_id())

    def op_hmset(self, key, fields) -> Op:
        return Op(OpType.HMSET, (key,), (tuple(fields),), self.next_rpc_id())

    def op_mset(self, kvs) -> Op:
        keys = tuple(k for k, _ in kvs)
        vals = tuple(v for _, v in kvs)
        return Op(OpType.MSET, keys, vals, self.next_rpc_id())

    def op_del(self, key) -> Op:
        return Op(OpType.DEL, (key,), (), self.next_rpc_id())

    def op_sadd(self, key, member) -> Op:
        return Op(OpType.SADD, (key,), (member,), self.next_rpc_id())

    def op_append(self, key, chunk) -> Op:
        return Op(OpType.APPEND, (key,), (chunk,), self.next_rpc_id())

    def op_max(self, key, n) -> Op:
        return Op(OpType.MAX, (key,), (n,), self.next_rpc_id())
