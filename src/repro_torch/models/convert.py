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

from typing import Any, Callable, Dict, Mapping

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


def unstack_layers(cfg: ModelConfig, tree: Mapping[str, Any],
                   top: Callable[[Any], Any],
                   layer: Callable[[Any, int], Any]) -> Dict[str, Any]:
    """A tree in the reference's nesting (``tree["layers"]`` stacked over
    the layers) as a dict by the port's state-dict names: ``top(leaf)`` for
    every leaf outside ``layers``, ``layer(leaf, i)`` as
    ``blocks.{i}.<path>`` for each layer ``i`` of a stacked one.  The
    weights (``params_from_jax``) and the sharding specs
    (``launch.sharding.state_specs``) cross by this one walk."""
    flat: Dict[str, Any] = {}
    _flatten({k: v for k, v in tree.items() if k != "layers"}, "", flat)
    state = {k: top(v) for k, v in flat.items()}
    layers: Dict[str, Any] = {}
    _flatten(tree["layers"], "", layers)
    for path, stacked in layers.items():
        for i in range(cfg.n_layers):
            state[f"blocks.{i}.{path}"] = layer(stacked, i)
    return state


def params_from_jax(cfg: ModelConfig,
                    params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference's parameter pytree (nested dicts of numpy arrays) as
    the port's state dict (CPU tensors, same dtypes); load it with
    ``Transformer.from_state_dict(cfg, state, device)``."""
    def layer(stacked, i):
        stacked = np.asarray(stacked)
        if stacked.shape[0] != cfg.n_layers:
            raise ValueError(f"layers: {stacked.shape[0]} layers stacked, "
                             f"the config has {cfg.n_layers}")
        return _tensor(stacked[i])

    return unstack_layers(cfg, params_np, _tensor, layer)


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
