"""repro_torch.models — the unified architecture zoo on torch (the port of
``repro.models``; plain torch ops, no hand-written kernel)."""
from .config import ModelConfig, reduced
from .transformer import (
    Transformer,
    cache_tensors,
    decode_step,
    forward,
    init_decode_cache,
    init_params,
    loss_fn,
    prefill,
    segments,
)

__all__ = [
    "ModelConfig", "reduced", "cache_tensors", "decode_step", "forward", "init_decode_cache",
    "init_params", "loss_fn", "prefill", "segments", "Transformer",
]
