"""repro_torch.optim — AdamW and int8 gradient compression on torch (the
port of ``repro.optim``)."""
from .adamw import AdamWConfig, adamw_update, global_norm, init_opt_state, lr_at
from .compression import compress_grads, roundtrip_leaf

__all__ = [
    "AdamWConfig", "adamw_update", "global_norm", "init_opt_state", "lr_at",
    "compress_grads", "roundtrip_leaf",
]
