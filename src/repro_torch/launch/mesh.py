"""Device meshes and the card's roofline constants.

The torch port of ``repro.launch.mesh``: functions, never module-level
meshes, so importing this module makes no process group and touches no
CUDA state.  The production shapes keep the reference's axis names: a
single pod is 16 x 16 ``("data", "model")``, two pods 2 x 16 x 16 with a
leading ``"pod"`` data-parallel axis.  A mesh needs a default process
group of the mesh's size (``torch.distributed.init_process_group``: NCCL
on cards, gloo on CPUs, or the fake group the dry run uses).
"""
from __future__ import annotations

from typing import Sequence


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_from(shape, axes, device_type=device_type)


def make_mesh_from(shape: Sequence[int], axes: Sequence[str],
                   device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default process
    group's ranks, in rank order (test meshes and small dry runs)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


# NVIDIA H100 SXM5 (700 W) roofline denominators, from NVIDIA's H100 data
# sheet: dense bf16 tensor-core rate, HBM3 bandwidth, NVLink 4 bandwidth
# (900 GB/s bidirectional, 450 GB/s each way per GPU) and HBM3 capacity.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s per GPU
HBM_BW = 3.35e12                # bytes/s per GPU
ICI_BW = 450e9                  # NVLink bytes/s per GPU, one direction
HBM_BYTES = 80e9                # bytes per GPU
