"""AdamW with dtype-configurable moments + cosine LR schedule + global-norm
clip.

The torch port of ``repro.optim.adamw``, with the reference's arithmetic in
the reference's order and types: f32 moments (or ``moment_dtype``), bias
corrections ``1 - b**step`` in f32, decay added to the update
(``delta = mhat / (sqrt(vhat) + eps) + wd * p``, not ``p *= 1 - lr * wd``
as ``torch.optim.AdamW`` does before its step) and a global-norm clip.

Parameters are a module's named parameters (or any mapping name ->
tensor); the state is ``{"m": {name: tensor}, "v": {name: tensor},
"step": int32 tensor}``, so a checkpoint of it carries the step.
``adamw_update`` writes the parameters and moments in place under
``torch.no_grad()`` (the reference returns new pytrees; the port saves the
copies) and returns them as the reference does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Tuple, Union

import torch
from torch import nn

from ..models.transformer import resolve_device, torch_dtype

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"   # "bfloat16" for memory-bound giants
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _named_tensors(params: Params) -> Dict[str, torch.Tensor]:
    """name -> tensor of a module's parameters (or of a mapping as given)."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_opt_state(params: Params, cfg: AdamWConfig,
                   device="cuda") -> Dict[str, Any]:
    """Zero moments beside ``params`` on ``device`` (which must be where the
    parameters live; "cuda" raises without a card)."""
    device = resolve_device(device)
    dt = torch_dtype(cfg.moment_dtype)
    named = _named_tensors(params)
    for name, p in named.items():
        if p.device.type != device.type:
            raise ValueError(f"parameter {name} lives on {p.device}, the "
                             f"optimizer state is asked for on {device}")
    return {
        "m": {k: torch.zeros(p.shape, dtype=dt, device=device)
              for k, p in named.items()},
        "v": {k: torch.zeros(p.shape, dtype=dt, device=device)
              for k, p in named.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``; f32 from the
    int32 step, as the reference computes it."""
    s = step.to(torch.float32)
    warm = s / max(1.0, cfg.warmup_steps)
    prog = torch.clamp(
        (s - cfg.warmup_steps) / max(1.0, cfg.total_steps - cfg.warmup_steps),
        0.0, 1.0,
    )
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.minimum(warm, cos)


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    leaves = list(tree.values())
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32)))
                          for t in leaves))


@torch.no_grad()
def adamw_update(
    params: Params, grads: Mapping[str, torch.Tensor],
    opt_state: Dict[str, Any], cfg: AdamWConfig,
) -> Tuple[Params, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  ``grads`` maps each parameter's name to
    its gradient (in the parameter's dtype, as ``jax.grad`` gives it)."""
    named = _named_tensors(params)
    if grads.keys() != named.keys():
        raise ValueError("grads and params name different tensors: "
                         f"{sorted(set(grads) ^ set(named))[:4]}")
    step = opt_state["step"] + 1
    gnorm = global_norm({k: grads[k] for k in named})
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    s = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, s)
    bc2 = 1 - torch.pow(b2, s)
    mdt = torch_dtype(cfg.moment_dtype)
    for k, p in named.items():
        g32 = grads[k].to(torch.float32) * scale
        m32 = opt_state["m"][k].to(torch.float32) * b1 + g32 * (1 - b1)
        v32 = (opt_state["v"][k].to(torch.float32) * b2
               + torch.square(g32) * (1 - b2))
        mhat = m32 / bc1
        vhat = v32 / bc2
        p32 = p.to(torch.float32)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))
        opt_state["m"][k].copy_(m32.to(mdt))
        opt_state["v"][k].copy_(v32.to(mdt))
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
