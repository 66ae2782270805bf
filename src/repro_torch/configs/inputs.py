"""Input stand-ins for every (arch x shape) cell: tensors on the ``meta``
device (shapes and dtypes, no allocation) or concrete tensors for smoke
tests, drawn from numpy exactly as the JAX package draws them, so both
packages get the same batch from the same seed.

For [audio]/[vlm] archs the modality frontend is a STUB per the assignment:
specs provide precomputed frame/patch embeddings (+ M-RoPE position ids for
qwen2-vl).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.transformer import init_decode_cache, resolve_device, torch_dtype
from .shapes import ShapeSpec


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(
    cfg: ModelConfig, shape: ShapeSpec, *, with_labels: bool,
) -> Dict[str, torch.Tensor]:
    """Shape-and-dtype stand-ins (``meta`` tensors) for the model-input
    batch."""
    B = shape.global_batch
    S = 1 if shape.kind == "decode" else shape.seq_len
    specs: Dict[str, Any] = {}
    if cfg.frontend == "token":
        specs["tokens"] = _meta((B, S), torch.int32)
    else:
        fd = cfg.frontend_dim or cfg.d_model
        specs["embeds"] = _meta((B, S, fd), torch_dtype(cfg.dtype))
    if cfg.pos == "mrope":
        specs["positions"] = _meta((3, B, S), torch.int32)
    if with_labels:
        specs["labels"] = _meta((B, S), torch.int32)
    return specs


def cache_specs(cfg: ModelConfig, shape: ShapeSpec):
    """The decode cache of a serve_step cell on ``meta`` (no allocation)."""
    return init_decode_cache(cfg, shape.global_batch, shape.seq_len,
                             device="meta")


def concrete_batch(
    cfg: ModelConfig, shape_kind: str, batch: int, seq: int, seed: int = 0,
    *, with_labels: bool = True, device="cuda",
) -> Dict[str, torch.Tensor]:
    """Concrete random batch for smoke tests / examples (small shapes)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    S = 1 if shape_kind == "decode" else seq
    out: Dict[str, Any] = {}

    def put(a, dtype):
        return torch.as_tensor(a).to(device=device, dtype=dtype)

    if cfg.frontend == "token":
        out["tokens"] = put(rng.integers(0, cfg.vocab, (batch, S)),
                            torch.int32)
    else:
        fd = cfg.frontend_dim or cfg.d_model
        out["embeds"] = put(rng.normal(0, 1, (batch, S, fd)),
                            torch_dtype(cfg.dtype))
    if cfg.pos == "mrope":
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (3, batch, S))
        out["positions"] = put(pos.copy(), torch.int32)
    if with_labels and shape_kind != "decode":
        out["labels"] = put(rng.integers(0, cfg.vocab, (batch, S)),
                            torch.int32)
    return out
