"""repro_torch.core — CURP: Consistent Unordered Replication Protocol.

The protocol modules are copies of the JAX package's pure-Python ones (the
port imports nothing of ``repro``); ``device_witness`` and ``fastbatch``
hold the witness gang and the fused cluster batch over torch tensors, on
the CUDA gang kernels of ``repro_torch.kernels``.  ``ShardedCluster``,
``ShardGroup`` and ``LocalCluster`` take ``device=`` ("cuda" by default)
for the device witness backend.  ``consensus`` and ``overload`` are not
copied yet.
"""
from .backup import Backup, LogEntry
from .client import (
    ClientSession,
    Decision,
    combine_decisions,
    decide,
    decide_commit,
    decide_multi,
)
from .config import ConfigManager, HeartbeatDetector, WitnessGeometry
from .device_witness import DeviceWitness, WitnessGang, gc_many
from .fastbatch import DeviceRing, FusedBatchDriver
from .local import LocalCluster, OpOutcome
from .master import DUP, ERROR, FAST, SYNCED, Master
from .migration import (
    MigrationManager,
    MigrationReport,
    SlotMigration,
    SlotMoving,
    plan_rebalance,
)
from .recovery import RecoveryReport, recover_master
from .rifl import RiflTable
from .shard import (
    N_SLOTS,
    ClusterRecoveryReport,
    KeyRouter,
    ShardedClientSession,
    ShardedCluster,
    ShardGroup,
    SlotRouter,
    mix2x32,
)
from .store import KVStore
from .txn import (
    CoordinatorCrash,
    TxnCoordinator,
    TxnOutcome,
    TxnPart,
    TxnPending,
    TxnSpec,
    TxnStatus,
    resolve_pending,
    resolve_txn,
)
from .types import (
    ClusterConfig,
    ExecResult,
    Op,
    OpType,
    RecordStatus,
    RpcId,
    WitnessMode,
    keyhash,
    splitmix64,
)
from .witness import Witness

__all__ = [
    "Backup", "LogEntry", "ClientSession", "Decision", "decide",
    "decide_multi", "decide_commit", "combine_decisions",
    "ConfigManager", "HeartbeatDetector", "WitnessGeometry", "DeviceWitness",
    "WitnessGang", "gc_many", "DeviceRing", "FusedBatchDriver",
    "LocalCluster", "OpOutcome", "Master", "FAST", "SYNCED", "DUP", "ERROR",
    "RecoveryReport", "recover_master", "RiflTable", "KVStore",
    "ClusterRecoveryReport", "KeyRouter", "SlotRouter", "N_SLOTS",
    "ShardedClientSession", "ShardedCluster", "ShardGroup", "mix2x32",
    "MigrationManager", "MigrationReport", "SlotMigration", "SlotMoving",
    "plan_rebalance",
    "CoordinatorCrash", "TxnCoordinator", "TxnOutcome", "TxnPart",
    "TxnPending", "TxnSpec", "TxnStatus", "resolve_pending", "resolve_txn",
    "ClusterConfig", "ExecResult", "Op", "OpType", "RecordStatus", "RpcId",
    "WitnessMode", "keyhash", "splitmix64", "Witness",
]
