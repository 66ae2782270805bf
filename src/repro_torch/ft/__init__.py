"""repro_torch.ft — CURP-FT training on torch (the port of ``repro.ft``):
step journals on f witnesses, full-state syncs to f backups, bit-exact
recovery."""
from .checkpoint import BackupReplica, restore_into
from .elastic import MeshPlan, StragglerPolicy, plan_elastic_remesh
from .journal import FileWitness, StepOp
from .runner import FTConfig, FaultTolerantTrainer

__all__ = [
    "BackupReplica", "restore_into", "MeshPlan", "StragglerPolicy",
    "plan_elastic_remesh", "FileWitness", "StepOp", "FTConfig",
    "FaultTolerantTrainer",
]
