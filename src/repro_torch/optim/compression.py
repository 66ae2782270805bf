"""int8 gradient compression with per-block scales + error feedback.

The torch port of ``repro.optim.compression``: blocks of 256, a scale of
``max|x| / 127 + 1e-12`` per block, ``torch.round`` (half to even, as
``jnp.round``) and int8 codes; error feedback is kept in f32.  The same f32
inputs give the reference's codes and dequantized bits.  Gradients are a
mapping name -> tensor.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch

BLOCK = 256


def _quantize_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = g.to(torch.float32).reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad,))])
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_leaf(q: torch.Tensor, scale: torch.Tensor,
                     shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def compress_grads(
    grads: Mapping[str, torch.Tensor],
    error_feedback: Optional[Mapping[str, torch.Tensor]] = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Returns (dequantized-after-wire grads, new error feedback)."""
    if error_feedback is not None:
        grads = {k: g.to(torch.float32) + error_feedback[k]
                 for k, g in grads.items()}
    deq, ef = {}, {}
    for k, g in grads.items():
        q, s = _quantize_leaf(g)
        d = _dequantize_leaf(q, s, g.shape)
        deq[k] = d.to(g.dtype)
        ef[k] = g.to(torch.float32) - d
    return deq, ef


def roundtrip_leaf(g: torch.Tensor) -> torch.Tensor:
    """Quantize->dequantize one leaf (what the wire sees)."""
    q, s = _quantize_leaf(g)
    return _dequantize_leaf(q, s, g.shape).to(g.dtype)
