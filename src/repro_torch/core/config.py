"""Cluster configuration manager (§3.6) + witness table geometry.

Owns the authoritative mapping master -> (epoch, backups, witnesses,
WitnessListVersion).  Clients cache configs; masters reject updates carrying a
stale WitnessListVersion, which forces clients to refetch — this is the §3.6
mechanism that makes witness reconfiguration safe.

``WitnessGeometry`` is the single knob for the witness table shape (S sets x
W ways, §4.2/§B.1), threaded from ServeConfig through ShardedCluster down to
the gang kernels (repro_torch.kernels) so every layer agrees on capacity
and on the device table's footprint.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

from .types import ClusterConfig


@dataclass(frozen=True)
class WitnessGeometry:
    """Witness table shape: ``n_sets`` x ``n_ways`` keyhash slots (§4.2).

    The paper's default is 1024x4 (§B.1: 4096 slots, 4-way associativity —
    direct-mapped tables start conflicting after ~80 inserts).  ``n_sets``
    must be a power of two: the device kernels pick the probed set with
    ``lo & (n_sets - 1)``.
    """
    n_sets: int = 1024
    n_ways: int = 4

    def __post_init__(self) -> None:
        if self.n_sets < 1 or self.n_sets & (self.n_sets - 1):
            raise ValueError(f"n_sets must be a power of two, got {self.n_sets}")
        if self.n_ways < 1:
            raise ValueError(f"n_ways must be >= 1, got {self.n_ways}")

    @property
    def slots(self) -> int:
        return self.n_sets * self.n_ways

    @property
    def vmem_bytes(self) -> int:
        """Device footprint of one table: keys_hi + keys_lo (uint32) + occ
        (int32), the whole-table figure the kernels keep VMEM-resident."""
        return 3 * 4 * self.slots


class HeartbeatDetector:
    """ConfigManager-side failure detector: timeout-count heartbeats.

    Masters send a heartbeat every ``interval`` time units over the same
    (lossy, jittery) transport as everything else; the detector declares a
    shard's master suspect once no beat has arrived for ``miss_threshold``
    consecutive intervals.  The threshold trades detection latency against
    false positives under jitter/drops — with drop probability p the false-
    suspect probability per check is ~p^miss_threshold.

    Pure state machine (caller supplies ``now``), so the discrete-event sim
    drives it deterministically.  ``check`` returns each newly suspected
    shard exactly once; ``reset`` re-arms a shard after its failover
    completes (the new master's beats then keep it alive).
    """

    def __init__(self, interval: float, miss_threshold: int = 5) -> None:
        self.interval = interval
        self.miss_threshold = miss_threshold
        self._last: Dict[int, float] = {}
        self._suspected: set = set()
        self.detections: Dict[int, float] = {}  # shard -> detection time

    def beat(self, shard_id: int, now: float) -> None:
        if shard_id not in self._suspected:
            self._last[shard_id] = now

    def watch(self, shard_id: int, now: float) -> None:
        """Start (or restart) monitoring a shard, treating ``now`` as a beat."""
        self._suspected.discard(shard_id)
        self._last[shard_id] = now

    def check(self, now: float):
        """Return shards newly declared suspect as of ``now``."""
        newly = []
        deadline = self.miss_threshold * self.interval
        for shard_id, last in self._last.items():
            if shard_id in self._suspected:
                continue
            if now - last >= deadline:
                self._suspected.add(shard_id)
                self.detections[shard_id] = now
                newly.append(shard_id)
        return newly

    def suspected(self, shard_id: int) -> bool:
        return shard_id in self._suspected


class ConfigManager:
    def __init__(self) -> None:
        self._configs: Dict[int, ClusterConfig] = {}  # shard_id -> config

    def publish(self, shard_id: int, config: ClusterConfig) -> None:
        self._configs[shard_id] = config

    def fetch(self, shard_id: int = 0) -> ClusterConfig:
        return self._configs[shard_id]

    def epoch(self, shard_id: int = 0) -> int:
        """Per-shard epoch: each shard fails over independently, so epochs
        advance per shard — a master crash on shard k fences only shard k's
        zombies and leaves every other shard's epoch untouched."""
        return self._configs[shard_id].epoch

    def epochs(self) -> Dict[int, int]:
        return {sid: cfg.epoch for sid, cfg in self._configs.items()}

    def replace_witness(
        self, shard_id: int, dead_witness: int, new_witness: int
    ) -> ClusterConfig:
        """Decommission a crashed witness, install a new one, bump the
        WitnessListVersion (§3.6 case 2).  The master must sync to backups and
        acknowledge before the new config is considered live; callers drive
        that handshake."""
        cfg = self._configs[shard_id]
        wl = tuple(new_witness if w == dead_witness else w for w in cfg.witness_ids)
        cfg = replace(
            cfg, witness_ids=wl, witness_list_version=cfg.witness_list_version + 1
        )
        self._configs[shard_id] = cfg
        return cfg

    def migration_fence(self, shard_id: int) -> ClusterConfig:
        """§3.6 slot handover: bump epoch AND WitnessListVersion on one side
        of a migration.  The WitnessListVersion bump fences in-flight records
        — an update that recorded at the old witness set before the handover
        is refused by the master (WRONG_WITNESS_VERSION) and the client
        refetches, re-routing to the new owner; the epoch bump fences any
        zombie pre-handover master at the backups.  Callers must push the
        new epoch/version into the live master and its backups (the
        MigrationManager drives that handshake)."""
        cfg = self._configs[shard_id]
        cfg = replace(
            cfg,
            epoch=cfg.epoch + 1,
            witness_list_version=cfg.witness_list_version + 1,
        )
        self._configs[shard_id] = cfg
        return cfg

    def fail_over(
        self,
        shard_id: int,
        new_master_id: int,
        new_witness_ids: Tuple[int, ...],
    ) -> ClusterConfig:
        """Master crash: bump epoch (fences zombies at backups), assign fresh
        witnesses, bump WitnessListVersion."""
        cfg = self._configs[shard_id]
        cfg = replace(
            cfg,
            master_id=new_master_id,
            epoch=cfg.epoch + 1,
            witness_ids=new_witness_ids,
            witness_list_version=cfg.witness_list_version + 1,
        )
        self._configs[shard_id] = cfg
        return cfg
