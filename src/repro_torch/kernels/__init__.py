"""repro_torch.kernels — the kernels of the CURP hot path.

CUDA C++ sources for sm_90a in ``csrc/`` (built with nvcc at first use, see
``build.py``), their plain PyTorch versions in ``ref.py``, and the public
ops in ``ops.py``, which launch the kernels on CUDA tensors and run the
plain versions on CPU tensors: the gang ops of the device witness backend
and the single-table fast-path ops, as in ``repro.kernels``.
"""
from .ops import (
    DEFAULT_N_SLOTS,
    KERNELS,
    FastPathResult,
    GangFastPathResult,
    GangRecordResult,
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
    witness_record,
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
    "ring_from_numpy", "ring_to_numpy", "shard_route", "witness_record",
    "witness_table_from_numpy", "witness_table_to_numpy",
]
