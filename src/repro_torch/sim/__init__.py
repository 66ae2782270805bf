"""repro_torch.sim — discrete-event simulation of CURP clusters.

Timing model calibrated to the paper's RAMCloud/Redis numbers (see params.py
for the napkin math); protocol logic is repro_torch.core, unchanged.  Sharded
scenarios (multi-master, per-shard witnesses) run via run_sharded_scenario.
"""
from .curp_sim import (
    TXN_CRASH_STAGES,
    BatchedRunResult,
    MigrationScenarioResult,
    OpenLoopDriver,
    OpenLoopResult,
    ScenarioResult,
    ShardedScenarioResult,
    ShardedSimCluster,
    SimCluster,
    SimCoordinator,
    SimTxnClient,
    TimedTxnResult,
    TxnScenarioResult,
    run_batched_throughput,
    run_migration_scenario,
    run_openloop_scenario,
    run_scenario,
    run_sharded_scenario,
    run_timed_txn_scenario,
    run_txn_crash_scenario,
)
from .linearizability import (
    WindowedChecker,
    check_linearizable,
    check_linearizable_strict,
    check_linearizable_windowed,
)
from .network import Network, Node, Sim
from .params import DEFAULT, SimParams
from .watchdog import (
    CHAOS_MONITOR,
    Breach,
    ChaosConfig,
    Watchdog,
    replay,
    run_intent_leak_scenario,
    run_watched_scenario,
)
from .workload import (
    BatchedWorkload,
    HotKeyWorkload,
    OpenLoopWorkload,
    ShardSkewedWorkload,
    TxnWorkload,
    UniformWriteWorkload,
    YcsbWorkload,
    ZipfianGenerator,
)

__all__ = [
    "BatchedRunResult", "ScenarioResult", "ShardedScenarioResult",
    "ShardedSimCluster", "SimCluster", "run_batched_throughput",
    "run_scenario", "run_sharded_scenario",
    "TXN_CRASH_STAGES", "TxnScenarioResult", "run_txn_crash_scenario",
    "MigrationScenarioResult", "run_migration_scenario",
    "SimTxnClient", "TimedTxnResult", "run_timed_txn_scenario",
    "OpenLoopDriver", "OpenLoopResult", "SimCoordinator",
    "run_openloop_scenario",
    "check_linearizable", "check_linearizable_strict",
    "check_linearizable_windowed", "WindowedChecker",
    "CHAOS_MONITOR", "Breach", "ChaosConfig", "Watchdog",
    "replay", "run_intent_leak_scenario", "run_watched_scenario",
    "Network", "Node", "Sim", "DEFAULT", "SimParams",
    "BatchedWorkload", "HotKeyWorkload", "OpenLoopWorkload",
    "ShardSkewedWorkload", "TxnWorkload",
    "UniformWriteWorkload", "YcsbWorkload", "ZipfianGenerator",
]
