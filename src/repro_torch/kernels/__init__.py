"""repro_torch.kernels — the gang kernels of the CURP hot path.

CUDA C++ sources for sm_90a in ``csrc/`` (built with nvcc at first use, see
``build.py``), their plain PyTorch versions in ``ref.py``, and the public
ops in ``ops.py``, which launch the kernels on CUDA tensors and run the
plain versions on CPU tensors.
"""
from .ops import (
    KERNELS,
    GangFastPathResult,
    GangRecordResult,
    dispatch_count,
    gang_fastpath_batch,
    gang_gc,
    gang_record,
    gang_record_groups,
    launch_counts,
    reset_dispatch_count,
    reset_launch_counts,
)
from .ref import (
    N_REASON_CODES,
    GangTable,
    conflict_matrix_np,
    gang_from_numpy,
    gang_to_numpy,
    keyhash2x32,
    matrix_rows,
    np_keyhash2x32,
    ring_from_numpy,
    ring_to_numpy,
)

__all__ = [
    "KERNELS", "GangFastPathResult", "GangRecordResult", "GangTable",
    "N_REASON_CODES", "conflict_matrix_np", "dispatch_count",
    "gang_fastpath_batch", "gang_from_numpy", "gang_gc", "gang_record",
    "gang_record_groups", "gang_to_numpy", "keyhash2x32", "launch_counts",
    "matrix_rows", "np_keyhash2x32", "reset_dispatch_count",
    "reset_launch_counts", "ring_from_numpy", "ring_to_numpy",
]
