"""repro_torch.launch — step builders, the launchers (``train``, with
``--distributed`` under torchrun, and ``serve``), device meshes
(``mesh``), the sharding rules on DTensor (``sharding``) and the dry run
(``dryrun``, ``hlo_analysis``): the port of ``repro.launch``.  The mesh,
sharding and dry-run modules are imported by name, not here."""
from .steps import make_prefill_step, make_serve_step, make_train_step

__all__ = ["make_train_step", "make_prefill_step", "make_serve_step"]
