"""repro_torch.kernels — the kernels of the CURP hot path.

CUDA C++ sources for sm_90a in ``csrc/`` (built with nvcc at first use, see
``build.py``), their plain PyTorch versions in ``ref.py``, and the public
ops in ``ops.py``, which launch the kernels on CUDA tensors and run the
plain versions on CPU tensors: the gang ops of the device witness backend,
the single-table fast-path ops, and the single-table transaction probe, gc
and sequential record, as in ``repro.kernels``.
"""
from .ops import (
    DEFAULT_N_SLOTS,
    KERNELS,
    FastPathResult,
    GangFastPathResult,
    GangRecordResult,
    TxnProbeResult,
    conflict_scan,
    default_slot_map,
    dispatch_count,
    fastpath_batch,
    gang_fastpath_batch,
    gang_gc,
    gang_record,
    gang_record_groups,
    keyhash2x32,
    launch_counts,
    reset_dispatch_count,
    reset_launch_counts,
    shard_route,
    txn_probe,
    witness_gc,
    witness_record,
    witness_record_seq,
)
from .ref import (
    N_REASON_CODES,
    GangTable,
    WitnessTable,
    conflict_matrix_np,
    gang_from_numpy,
    gang_to_numpy,
    matrix_rows,
    np_keyhash2x32,
    ring_from_numpy,
    ring_to_numpy,
    witness_table_from_numpy,
    witness_table_to_numpy,
)

__all__ = [
    "DEFAULT_N_SLOTS", "KERNELS", "FastPathResult", "GangFastPathResult",
    "GangRecordResult", "GangTable", "N_REASON_CODES", "WitnessTable",
    "conflict_matrix_np", "conflict_scan", "default_slot_map",
    "dispatch_count", "fastpath_batch", "gang_fastpath_batch",
    "gang_from_numpy", "gang_gc", "gang_record", "gang_record_groups",
    "gang_to_numpy", "keyhash2x32", "launch_counts", "matrix_rows",
    "np_keyhash2x32", "reset_dispatch_count", "reset_launch_counts",
    "ring_from_numpy", "ring_to_numpy", "shard_route", "TxnProbeResult",
    "txn_probe", "witness_gc", "witness_record", "witness_record_seq",
    "witness_table_from_numpy", "witness_table_to_numpy",
]
