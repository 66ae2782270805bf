"""Step builders: train_step / prefill_step / serve_step for any arch config.

The torch port of ``repro.launch.steps``: these are the functions the
launchers run.  The train step is ``loss_fn`` -> backward -> AdamW, the
gradients in each parameter's dtype (as ``jax.grad`` gives them), the
update in place; it returns the reference's metrics.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models.config import ModelConfig
from ..models.shardctx import gathered
from ..models.transformer import Transformer, decode_step, forward, loss_fn
from ..optim import AdamWConfig, adamw_update


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig):
    def train_step(params: Transformer, opt_state: Dict, batch: Dict
                   ) -> Tuple[Transformer, Dict, Dict[str, torch.Tensor]]:
        named = dict(params.named_parameters())
        with torch.enable_grad():
            loss, aux = loss_fn(cfg, params, batch)
            # a parameter the loss does not reach (an audio model's token
            # embedding) gets zeros, as jax.grad gives it
            grads = torch.autograd.grad(loss, list(named.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        new_p, new_o, om = adamw_update(params, dict(zip(named, grads)),
                                        opt_state, opt_cfg)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in aux.items()}, **om}
        return new_p, new_o, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    @torch.no_grad()
    def prefill_step(params: Transformer, batch: Dict) -> torch.Tensor:
        logits, _ = forward(cfg, params, batch)
        return logits[:, -1, :].to(torch.float32)

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params: Transformer, batch: Dict, cache: Dict):
        logits, new_cache = decode_step(cfg, params, batch, cache)
        # tokens come out replicated: a vocab-sharded DTensor's logits are
        # gathered first (the identity on one device)
        next_tok = torch.argmax(gathered(logits), dim=-1).to(torch.int32)
        return next_tok, new_cache

    return serve_step
