"""RIFL: Reusable Infrastructure For Linearizability (Lee et al., SOSP'15).

Exactly-once RPC semantics: masters keep a durable *completion record*
(rpc_id -> result) per update; duplicate invocations skip execution and return
the saved result.  CURP needs the two §4.8 modifications:

1. Client acks piggybacked on requests normally let the master delete
   completion records — but acks must be IGNORED while replaying from a
   witness, because witness replay arrives in arbitrary order.
2. A client lease may only expire after all of that client's operations have
   been synced to backups (the master must sync before honoring expiry).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Optional, Tuple

from .telemetry import get_registry
from .types import CompletionRecord, RpcId


class RiflTable:
    def __init__(self) -> None:
        # client_id -> {seq -> CompletionRecord}
        self._records: Dict[int, Dict[int, CompletionRecord]] = {}
        # client_id -> first seq NOT yet acked (records below are deletable)
        self._acked_below: Dict[int, int] = {}
        self._expired_clients: set[int] = set()
        # §4.8 (1): during witness replay, acks must not delete records.
        self.replay_mode: bool = False
        self.stats = {"dup_hits": 0}
        self._m_dup_hits = get_registry().counter("rifl.dup_hits")

    # -- duplicate detection -------------------------------------------------
    def check_duplicate(self, rpc_id: RpcId) -> Optional[CompletionRecord]:
        """Returns the completion record if this RPC already executed."""
        client_id, seq = rpc_id
        rec = self._records.get(client_id, {}).get(seq)
        if rec is not None:
            self.stats["dup_hits"] += 1
            self._m_dup_hits.inc()
            return rec
        if client_id in self._expired_clients:
            # Expired client: all records gone; request must be ignored, not
            # re-executed (the paper requires sync-before-expiry so that this
            # can never lose a completed op).
            self.stats["dup_hits"] += 1
            self._m_dup_hits.inc()
            return CompletionRecord(rpc_id, None, synced=True)
        if seq < self._acked_below.get(client_id, 0):
            # Acked => client saw the result; duplicates are ignored.
            self.stats["dup_hits"] += 1
            self._m_dup_hits.inc()
            return CompletionRecord(rpc_id, None, synced=True)
        return None

    def record_completion(self, rpc_id: RpcId, result: Any, synced: bool) -> None:
        client_id, seq = rpc_id
        self._records.setdefault(client_id, {})[seq] = CompletionRecord(
            rpc_id, result, synced
        )

    def mark_synced_through(self, rpc_ids: Iterable[RpcId]) -> None:
        for client_id, seq in rpc_ids:
            rec = self._records.get(client_id, {}).get(seq)
            if rec is not None:
                rec.synced = True

    # -- garbage collection ---------------------------------------------------
    def apply_client_acks(self, acks: Iterable[Tuple[int, int]]) -> None:
        """acks = [(client_id, first_incomplete_seq)]: delete records below.

        No-op in replay mode (§4.8 modification 1).
        """
        if self.replay_mode:
            return
        for client_id, below in acks:
            cur = self._acked_below.get(client_id, 0)
            if below > cur:
                self._acked_below[client_id] = below
                recs = self._records.get(client_id)
                if recs:
                    for seq in [s for s in recs if s < below]:
                        del recs[seq]

    def expire_client(self, client_id: int, all_synced: bool) -> bool:
        """§4.8 modification 2: only allowed once the client's ops are synced."""
        if not all_synced:
            return False
        self._records.pop(client_id, None)
        self._expired_clients.add(client_id)
        return True

    def acked_frontier(self, client_id: int) -> int:
        """The applied ack frontier for one client: every seq below it has a
        client-acknowledged completion (records there are deletable).  The
        watchdog journals this per execution — the frontier regressing, or
        an op executing below it, is an exactly-once violation."""
        return self._acked_below.get(client_id, 0)

    # -- durability plumbing ---------------------------------------------------
    def unsynced_rpc_ids(self) -> Tuple[RpcId, ...]:
        out = []
        for client_id, recs in self._records.items():
            for seq, rec in recs.items():
                if not rec.synced:
                    out.append((client_id, seq))
        return tuple(out)

    def all_synced_for(self, client_id: int) -> bool:
        recs = self._records.get(client_id, {})
        return all(r.synced for r in recs.values())

    def snapshot(self):
        import copy

        return copy.deepcopy(
            (self._records, self._acked_below, self._expired_clients)
        )

    def load_snapshot(self, snap) -> None:
        import copy

        self._records, self._acked_below, self._expired_clients = copy.deepcopy(snap)
