"""LocalCluster: an in-process, instantly-delivered CURP cluster.

This harness exists for deterministic protocol testing and for the examples:
every RPC is a function call, but the *protocol steps are the real ones* —
witness records, speculative execution, batched syncs, gc, recovery, witness
reconfiguration.  Timing behaviour (latency/throughput) lives in repro.sim.

Shard model: the protocol drive loop lives in repro.core.shard.ShardGroup —
one master plus its own witness group and backups.  LocalCluster is exactly
one ShardGroup (the single-master harness the unit tests exercise);
ShardedCluster (same module) is N of them behind a KeyRouter, which is how
the paper deploys CURP on a partitioned store (§4, Fig. 3).

Fault injection knobs let tests exercise the interesting interleavings:
  * ``witness_drop(witness_idx)``: client's record RPC to that witness is lost.
  * ``crash_master(lose_unsynced=True)``: master dies; unsynced state is gone;
    recovery runs per §3.3 onto a fresh master.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Tuple

from .client import ClientSession
from .config import ConfigManager
from .recovery import RecoveryReport
from .shard import HistoryRecorder, ShardGroup
from .types import Op


@dataclass
class OpOutcome:
    value: Any
    rtts: int                 # logical round-trips the client experienced
    fast_path: bool           # completed via 1-RTT witness path
    synced_path: bool         # master tagged result synced (conflict)
    witness_accepts: int


class LocalCluster:
    """Single-master CURP harness: a thin shell over one ShardGroup."""

    def __init__(
        self,
        f: int = 3,
        sync_batch: int = 50,
        witness_sets: int = 1024,
        witness_ways: int = 4,
        hot_key_window: float = 0.0,
        seed: int = 0,
        auto_sync: bool = True,
        geometry=None,
        witness_backend: str = "python",
        device: str = "cuda",
    ) -> None:
        self.f = f
        self.rng = random.Random(seed)
        self.config = ConfigManager()
        self._next_node_id = 0
        self._record = HistoryRecorder()
        self.history = self._record.history   # linearizability-checkable log
        self.group = ShardGroup(
            shard_id=0, config=self.config, alloc_id=self._node_id,
            f=f, sync_batch=sync_batch, witness_sets=witness_sets,
            witness_ways=witness_ways, hot_key_window=hot_key_window,
            auto_sync=auto_sync, record=self._record, geometry=geometry,
            witness_backend=witness_backend, device=device,
        )

    def _node_id(self) -> int:
        self._next_node_id += 1
        return self._next_node_id

    # ------------------------------------------------- group state passthrough
    @property
    def master(self):
        return self.group.master

    @property
    def backups(self):
        return self.group.backups

    @property
    def witnesses(self):
        return self.group.witnesses

    @property
    def auto_sync(self) -> bool:
        return self.group.auto_sync

    @auto_sync.setter
    def auto_sync(self, v: bool) -> None:
        self.group.auto_sync = v

    # ------------------------------------------------------------------ faults
    def witness_drop(self, witness_idx: int, dropped: bool = True) -> None:
        self.group.witness_drop(witness_idx, dropped)

    # ----------------------------------------------------------------- client
    def new_client(self) -> ClientSession:
        return ClientSession(client_id=self._node_id())

    def update(self, session: ClientSession, op: Op, now: float = 0.0) -> OpOutcome:
        """Full CURP update: update RPC + parallel witness records."""
        return self.group.update(session, op, now)

    def update_batch(self, session: ClientSession, ops, now: float = 0.0):
        """Batched updates: one master round + one record invocation per
        witness for the whole batch (see ShardGroup.update_batch)."""
        return self.group.update_batch(session, ops, now)

    def read(self, session: ClientSession, op: Op, now: float = 0.0) -> OpOutcome:
        return self.group.read(session, op, now)

    def read_from_backup(
        self, session: ClientSession, op: Op, backup_idx: int = 0,
        witness_idx: int = 0,
    ) -> Tuple[Any, bool]:
        """§A.1 consistent read from a (local) backup: check commutativity with
        a (local) witness first.  Returns (value, served_by_backup)."""
        return self.group.read_from_backup(session, op, backup_idx, witness_idx)

    # ------------------------------------------------------------------ syncs
    def _drain_syncs(self) -> None:
        self.group._drain_syncs()

    def sync_now(self) -> None:
        self.group.sync_now()

    # --------------------------------------------------------------- recovery
    def crash_master(self) -> RecoveryReport:
        """Kill the master (unsynced state is lost) and recover a new one from
        backups + one witness (§3.3)."""
        return self.group.crash_master()

    def replace_witness(self, witness_idx: int) -> None:
        """§3.6 case 2: decommission a witness, install a fresh one, bump the
        WitnessListVersion; master syncs before the new config goes live."""
        self.group.replace_witness(witness_idx)
