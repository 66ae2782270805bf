"""CURP-Serve session store.

Sessions are the keys: per-session state updates commute across sessions
(disjoint primary keys), so CURP's fast path applies to almost every decode
commit — two concurrent updates hit the same key only if the same session is
decoded twice within one unsynced window, which the driver never does.

Built directly on the protocol objects (ShardedCluster): every session commit
is a real CURP update (witness records + speculative master + batched backup
syncs), and crash recovery rebuilds the session map via backup restore +
witness replay.  With ``n_shards > 1`` sessions are partitioned across
independent master groups by session-id hash (the KeyRouter over the
``session:{id}`` key), so commit load spreads across masters and a single
master crash only replays that shard's witnesses.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core import (
    ClusterRecoveryReport,
    ShardedClientSession,
    ShardedCluster,
    TxnOutcome,
    TxnStatus,
    WitnessGeometry,
)
from ..core.telemetry import span


@dataclass
class SessionState:
    session_id: str
    tokens: List[int]
    done: bool = False


class CurpSessionStore:
    def __init__(self, f: int = 3, sync_batch: int = 50, seed: int = 0,
                 n_shards: int = 1,
                 geometry: Optional[WitnessGeometry] = None,
                 witness_backend: str = "python",
                 n_slots: int = 256, device: str = "cuda") -> None:
        # Sessions are hot keys by construction (one update per token), so we
        # enable the paper's §4.4 preemptive-sync heuristic: the master syncs
        # right after responding to an update of a recently-updated key,
        # keeping the NEXT commit of that session on the 1-RTT fast path.
        # ``device`` places the device backend's witness gang (the CUDA gang
        # kernels on "cuda", which raises without a card; their plain
        # versions on "cpu"); the Python backend never touches it.
        self.n_shards = n_shards
        self.cluster = ShardedCluster(
            n_shards=n_shards, f=f, sync_batch=sync_batch, seed=seed,
            hot_key_window=1e12, geometry=geometry,
            witness_backend=witness_backend, n_slots=n_slots, device=device,
        )
        self.client: ShardedClientSession = self.cluster.new_client()
        self.fast_commits = 0
        self.slow_commits = 0
        # Counted store-side so the numbers survive master failovers (the
        # per-shard Master.stats reset when recovery installs a new master).
        self._commits_by_shard: Dict[int, int] = {
            s: 0 for s in range(n_shards)
        }
        # Session placement is slot-map routing; memoize it per ROUTER
        # VERSION — a live slot migration bumps the version, invalidating
        # cached placements exactly like a client config refetch (§3.6).
        self._shard_cache: Dict[str, Tuple[int, int]] = {}

    @staticmethod
    def _key(session_id: str) -> str:
        return f"session:{session_id}"

    def shard_of(self, session_id: str) -> int:
        """Which master group owns this session (slot-map routing, cached
        per router version so live migrations invalidate the cache)."""
        version = self.cluster.router.version
        hit = self._shard_cache.get(session_id)
        if hit is not None and hit[0] == version:
            return hit[1]
        shard = self.cluster.shard_of(self._key(session_id))
        self._shard_cache[session_id] = (version, shard)
        return shard

    def _count_commit(self, session_id: str) -> None:
        shard = self.shard_of(session_id)
        self._commits_by_shard[shard] = \
            self._commits_by_shard.get(shard, 0) + 1

    # -- live reconfiguration ---------------------------------------------------
    def migrate_sessions(self, slots, dst_shard: int):
        """Live-move the sessions living in ``slots`` to another master
        group (repro_torch.core.migration): commits keep flowing on untouched
        slots throughout; the moved sessions' RIFL records travel with
        them."""
        return self.cluster.migrate_slots(slots, dst_shard)

    def add_shard(self) -> int:
        """Grow the serving store by one (initially empty) master group."""
        sid = self.cluster.add_shard()
        self.n_shards = self.cluster.n_shards
        self._commits_by_shard.setdefault(sid, 0)
        return sid

    def rebalance(self, max_moves: int = 64):
        """Hot-shard auto-split: shed the hottest sessions' slots off the
        hottest master group (per-slot op counters -> plan_rebalance)."""
        return self.cluster.rebalance(max_moves=max_moves)

    # -- write path -------------------------------------------------------------
    def commit(self, s: SessionState) -> None:
        """Durably commit a session snapshot (1 RTT on the fast path): a
        batch of one, so both paths share op construction and accounting."""
        self.commit_batch([s])

    def commit_batch(self, states: Sequence[SessionState]) -> None:
        """Durably commit a whole decode step's sessions in one batched CURP
        round: ops grouped per shard, each shard's witnesses record the batch
        in a single invocation (one kernel dispatch on the device backend),
        per-session fast/slow accounting preserved.  Distinct sessions have
        distinct keys, so a multi-session batch stays on the 1-RTT path."""
        if not states:
            return
        with span("serve.commit.encode"):
            ops = [
                self.client.op_set(
                    self._key(s.session_id),
                    json.dumps({"tokens": s.tokens, "done": s.done}),
                )
                for s in states
            ]
        outs = self.cluster.update_batch(self.client, ops)
        for s, out in zip(states, outs):
            self._count_commit(s.session_id)
            if out.fast_path:
                self.fast_commits += 1
            else:
                self.slow_commits += 1

    def txn(self, states: Sequence[SessionState]) -> TxnOutcome:
        """Atomically commit a GROUP of sessions (all-or-nothing across
        shards) via the mini-transaction subsystem (repro_torch.core.txn).

        ``commit_batch`` gives per-session durability — a crash mid-batch
        can persist some sessions of a linked group and not others.  This
        path makes the group atomic: sessions on one shard short-circuit to
        the same 1-RTT fast path as ``commit``; a cross-shard group pays
        one RIFL-identified 2PC (prepare round + decide round).
        """
        if not states:
            return TxnOutcome(status=TxnStatus.COMMITTED, reads={},
                              rtts=0, fast_path=True, n_shards=0)
        writes = [
            (self._key(s.session_id),
             json.dumps({"tokens": s.tokens, "done": s.done}))
            for s in states
        ]
        out = self.cluster.txn(self.client, writes)
        for s in states:
            self._count_commit(s.session_id)
            if out.fast_path:
                self.fast_commits += 1
            else:
                self.slow_commits += 1
        return out

    # -- read path ----------------------------------------------------------------
    def load(self, session_id: str) -> Optional[SessionState]:
        out = self.cluster.read(
            self.client, self.client.op_get(self._key(session_id))
        )
        if out.value is None:
            return None
        d = json.loads(out.value)
        return SessionState(session_id, d["tokens"], d["done"])

    # -- failures -------------------------------------------------------------------
    def crash_and_recover(self) -> ClusterRecoveryReport:
        """Total serving-node loss: every shard's master dies and recovers
        (each from its own backups + one of its own witnesses)."""
        return self.cluster.crash_all()

    def crash_shard(self, shard_id: int):
        """Partial failure: one master group dies; sessions on other shards
        keep their unsynced windows and witnesses untouched."""
        return self.cluster.crash_master(shard_id)

    # -- stats -----------------------------------------------------------------------
    def per_shard_commits(self) -> List[int]:
        return [self._commits_by_shard.get(s, 0)
                for s in range(len(self.cluster.shards))]
