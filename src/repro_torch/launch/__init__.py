"""repro_torch.launch — step builders and the single-process launchers (the
port of ``repro.launch``'s steps, ``train`` and ``serve``; its meshes,
sharding rules and dry-run come with the multi-card slice)."""
from .steps import make_prefill_step, make_serve_step, make_train_step

__all__ = ["make_train_step", "make_prefill_step", "make_serve_step"]
