"""Carry the JAX package's parameters into the port.

The reference keeps one pytree of arrays, each layer's parameters stacked
on axis 0 (its ``init_params`` builds them with ``jax.vmap`` so that
``lax.scan`` can walk the layers).  The port keeps one module per layer, so
``params_from_jax`` unstacks them: ``layers/attn/wq[i]`` becomes
``blocks.{i}.attn.wq``.  Every other leaf keeps its path with dots.  With
``tie_embeddings`` neither side holds a head: both read ``embed.T``.
``opt_state_from_jax`` carries the optimizer state across the same way
(its moments are trees shaped like the parameters).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .config import ModelConfig


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes' bf16: same bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _flatten(tree: Mapping[str, Any], prefix: str, out: Dict[str, Any]):
    for name, v in tree.items():
        path = f"{prefix}{name}"
        if isinstance(v, Mapping):
            _flatten(v, path + ".", out)
        else:
            out[path] = v


def params_from_jax(cfg: ModelConfig,
                    params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference's parameter pytree (nested dicts of numpy arrays) as
    the port's state dict (CPU tensors, same dtypes); load it with
    ``Transformer.from_state_dict(cfg, state, device)``."""
    flat: Dict[str, Any] = {}
    _flatten({k: v for k, v in params_np.items() if k != "layers"}, "", flat)
    state = {k: _tensor(v) for k, v in flat.items()}
    layers: Dict[str, Any] = {}
    _flatten(params_np["layers"], "", layers)
    for path, stacked in layers.items():
        stacked = np.asarray(stacked)
        if stacked.shape[0] != cfg.n_layers:
            raise ValueError(f"layers.{path}: {stacked.shape[0]} layers "
                             f"stacked, the config has {cfg.n_layers}")
        for i in range(cfg.n_layers):
            state[f"blocks.{i}.{path}"] = _tensor(stacked[i])
    return state


def opt_state_from_jax(cfg: ModelConfig,
                       opt_np: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference's AdamW state (``{"m": tree, "v": tree, "step":
    int32}`` of numpy arrays) as the port's (``{"m": {name: tensor}, "v":
    {name: tensor}, "step": int32 tensor}``, CPU tensors, same dtypes)."""
    return {
        "m": params_from_jax(cfg, opt_np["m"]),
        "v": params_from_jax(cfg, opt_np["v"]),
        "step": _tensor(np.asarray(opt_np["step"], np.int32)),
    }
