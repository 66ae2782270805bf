"""CURP on consensus (§A.2): 1-RTT updates for strong-leader consensus.

Model: 2f+1 replicas; each replica embeds a witness component.  The leader
speculatively executes and replies before committing to a majority; a client
completes in 1 RTT iff a SUPERQUORUM of f + ceil(f/2) + 1 witnesses accepted
its record.  On leader change, the new leader gathers witness data from any
f+1 replicas and replays exactly the requests recorded by a majority of that
quorum (>= ceil(f/2)+1): the superquorum write-side guarantees every completed
-but-uncommitted op appears that often, and no two non-commutative ops both
can (each witness enforces commutativity independently).

This is a protocol study (unit-tested for the quorum math + replay safety),
not a full Raft: log replication/commit is abstracted to direct calls, like
the rest of repro_torch.core, while the CURP-specific logic is complete.
"""
from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .rifl import RiflTable
from .store import KVStore
from .types import Op, RecordStatus
from .witness import Witness


def superquorum(f: int) -> int:
    return f + math.ceil(f / 2) + 1


def replay_threshold(f: int) -> int:
    return math.ceil(f / 2) + 1


@dataclass
class Replica:
    replica_id: int
    term: int = 0
    log: List[Tuple[Op, object]] = field(default_factory=list)
    commit_index: int = 0
    witness: Witness = field(default_factory=lambda: Witness(256, 4))

    def __post_init__(self) -> None:
        self.witness.start(self.replica_id)


class ConsensusCluster:
    """2f+1 replicas, one strong leader, CURP witnesses embedded."""

    def __init__(self, f: int = 2, commit_batch: int = 16) -> None:
        self.f = f
        self.n = 2 * f + 1
        self.commit_batch = commit_batch
        self.replicas = [Replica(i) for i in range(self.n)]
        self.leader_idx = 0
        self.term = 0
        self.store = KVStore()           # leader's speculative state machine
        self.rifl = RiflTable()
        self.crashed: set[int] = set()

    @property
    def leader(self) -> Replica:
        return self.replicas[self.leader_idx]

    def live(self) -> List[Replica]:
        return [r for r in self.replicas if r.replica_id not in self.crashed]

    # ------------------------------------------------------------- client path
    def update(self, op: Op) -> Tuple[object, bool]:
        """Returns (result, completed_in_1rtt).

        The leader speculatively executes; the client records to all live
        witnesses with the current term (§A.2 zombie-leader fence) and
        completes in 1 RTT on a superquorum of accepts.  Otherwise the client
        asks the leader to commit to a majority first (2 RTTs).
        """
        dup = self.rifl.check_duplicate(op.rpc_id)
        if dup is not None:
            return dup.result, False
        result = self.store.execute(op)
        self.rifl.record_completion(op.rpc_id, result, synced=False)
        self.leader.log.append((op, result))

        accepts = 0
        for r in self.live():
            # Term fence: witnesses embedded in replicas reject stale terms.
            if r.term > self.term:
                continue
            if (
                r.witness.record(r.replica_id, op.key_hashes(), op.rpc_id, op)
                is RecordStatus.ACCEPTED
            ):
                accepts += 1
        if accepts >= superquorum(self.f):
            if len(self.leader.log) - self.leader.commit_index >= self.commit_batch:
                self.commit()
            return result, True
        # Slow path: commit through a majority before replying.
        self.commit()
        return result, False

    # ----------------------------------------------------------------- commit
    def commit(self) -> None:
        """Replicate the leader log to a majority; advance commit_index; gc."""
        through = len(self.leader.log)
        acked = 1
        for r in self.live():
            if r is self.leader:
                continue
            r.log = list(self.leader.log)
            acked += 1
        if acked >= self.f + 1:
            newly = self.leader.log[self.leader.commit_index:through]
            for r in self.live():
                r.commit_index = max(r.commit_index, through)
            gc_entries = tuple(
                (kh, op.rpc_id) for op, _ in newly for kh in op.key_hashes()
            )
            self.rifl.mark_synced_through(op.rpc_id for op, _ in newly)
            for r in self.live():
                r.witness.gc(gc_entries)

    # ---------------------------------------------------------- leader change
    def crash(self, replica_id: int) -> None:
        self.crashed.add(replica_id)

    def change_leader(self) -> Dict[str, int]:
        """Elect the live replica with the longest committed log; replay
        witness records that appear >= ceil(f/2)+1 times in a quorum of f+1
        witnesses (§A.2)."""
        live = self.live()
        assert len(live) >= self.f + 1, "need a quorum to elect"
        self.term += 1
        new_leader = max(live, key=lambda r: r.commit_index)
        self.leader_idx = self.replicas.index(new_leader)

        # Rebuild state machine from the committed log only (speculative
        # suffix of a crashed old leader is NOT trusted).
        self.store = KVStore()
        self.rifl = RiflTable()
        committed = new_leader.log[: new_leader.commit_index]
        for op, result in committed:
            self.store.execute(op)
            self.rifl.record_completion(op.rpc_id, result, synced=True)
        new_leader.log = list(committed)
        new_leader.commit_index = len(committed)

        # Gather witness data from a quorum of f+1 live replicas.
        quorum = live[: self.f + 1]
        counter: Counter = Counter()
        requests: Dict = {}
        for r in quorum:
            for op in r.witness.get_recovery_data(r.replica_id):
                counter[op.rpc_id] += 1
                requests[op.rpc_id] = op
        threshold = replay_threshold(self.f)
        replayed = 0
        for rpc_id, cnt in counter.items():
            if cnt >= threshold and self.rifl.check_duplicate(rpc_id) is None:
                op = requests[rpc_id]
                result = self.store.execute(op)
                self.rifl.record_completion(op.rpc_id, result, synced=False)
                new_leader.log.append((op, result))
                replayed += 1
        self.commit()

        # Fresh witnesses for the new term.
        for r in live:
            r.term = self.term
            r.witness = Witness(r.witness.n_sets, r.witness.n_ways)
            r.witness.start(r.replica_id)
        return {"replayed": replayed, "term": self.term,
                "committed": new_leader.commit_index}
