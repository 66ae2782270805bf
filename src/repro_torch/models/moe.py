"""Mixture-of-Experts layer: top-k softmax routing, optional shared experts
(Qwen-MoE style), dense one-hot dispatch or capacity-bounded dispatch.

The torch port of ``repro.models.moe``.  Load-balancing aux loss follows
Switch Transformer (fraction-of-tokens x mean-router-prob per expert).  The
reference's expert-parallel ``moe_mlp_shardmap`` needs a device mesh and
comes with the launch slice; on one card ``moe_forward`` takes the capacity
or the dense dispatch exactly as the reference does with no rules
installed.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import MLP, Init
from .shardctx import constrain


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, init: Init) -> None:
        super().__init__()
        d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        self.router = init.normal((d, e), d ** -0.5)
        self.w_gate = init.normal((e, d, ff), d ** -0.5)
        self.w_up = init.normal((e, d, ff), d ** -0.5)
        self.w_down = init.normal((e, ff, d), ff ** -0.5)
        if cfg.n_shared_experts:
            self.shared = MLP(cfg, init, d_ff=cfg.shared_d_ff)


def _route(cfg: ModelConfig, p: MoE, x: torch.Tensor):
    logits = (x @ p.router).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)   # renormalize
    return probs, top_p, top_i


def _shared(cfg: ModelConfig, p: MoE, x: torch.Tensor, out: torch.Tensor):
    if cfg.n_shared_experts:
        sp = p.shared
        sg = F.silu(x @ sp.w_gate) * (x @ sp.w_up)
        out = out + sg @ sp.w_down
    return out


def moe_mlp(
    cfg: ModelConfig, p: MoE, x: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense dispatch.  x: [B, S, D] -> (out [B, S, D], aux_loss scalar)."""
    E = cfg.n_experts
    probs, top_p, top_i = _route(cfg, p, x)                   # [B,S,K]

    # combine [B,S,E] = sum_k onehot(top_i_k) * top_p_k
    onehot = F.one_hot(top_i, E).to(x.dtype)                  # [B,S,K,E]
    combine = torch.einsum("bske,bsk->bse", onehot, top_p.to(x.dtype))

    # Expert computation on the full token set (dense einsum over E).
    g = torch.einsum("bsd,edf->bsef", x, p.w_gate)
    u = torch.einsum("bsd,edf->bsef", x, p.w_up)
    h = constrain(F.silu(g) * u, "moe")
    y = torch.einsum("bsef,efd->bsed", h, p.w_down)
    out = _shared(cfg, p, x, torch.einsum("bsed,bse->bsd", y, combine))

    # Switch-style load-balance loss.
    frac_tokens = torch.mean(
        torch.sum(F.one_hot(top_i, E).float(), dim=2), dim=(0, 1))  # [E]
    frac_probs = torch.mean(probs, dim=(0, 1))                # [E]
    aux = torch.sum(frac_tokens * frac_probs) * E
    return out, aux


def moe_mlp_capacity(
    cfg: ModelConfig, p: MoE, x: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-bounded gather/scatter dispatch (GShard-style).

    Tokens scatter into per-expert buffers of capacity
    C = ceil(K * N * cf / E), rounded up to 64 (overflow drops); experts run
    batched GEMMs over their buffers; results gather back weighted by router
    probs.  Top-k experts per token are distinct, so a token's slot in
    expert e is the exclusive-over-tokens running count of e."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = B * S
    xf = x.reshape(N, D)
    probs, top_p, top_i = _route(cfg, p, xf)                  # [N, K]

    C = int(max(1, round(K * N * cfg.moe_capacity_factor / E)))
    C = -(-C // 64) * 64   # round up, as the reference keeps it
    tok_onehot = F.one_hot(top_i, E).sum(dim=1)               # [N,E]
    base = torch.cumsum(tok_onehot, dim=0) - tok_onehot       # exclusive
    slot = torch.gather(base, 1, top_i)                       # [N, K]
    keep = slot < C

    flat_e = torch.where(keep, top_i, 0).reshape(-1)          # [N*K]
    flat_s = torch.where(keep, slot, 0).reshape(-1)
    flat_w = torch.where(keep, top_p, 0.0).reshape(-1)
    src = xf.repeat_interleave(K, dim=0)                      # [N*K, D]
    src = torch.where(keep.reshape(-1)[:, None], src, 0)

    buf = torch.zeros((E, C, D), dtype=x.dtype, device=x.device)
    buf.index_put_((flat_e, flat_s), src.to(x.dtype), accumulate=True)
    buf = constrain(buf, "moe_buf")
    g = torch.einsum("ecd,edf->ecf", buf, p.w_gate)
    u = torch.einsum("ecd,edf->ecf", buf, p.w_up)
    h = constrain(F.silu(g) * u, "moe_hidden")
    y = torch.einsum("ecf,efd->ecd", h, p.w_down)
    gathered = y[flat_e, flat_s]                              # [N*K, D]
    outf = torch.zeros((N, D), dtype=torch.float32, device=x.device)
    tok_idx = torch.arange(N, device=x.device).repeat_interleave(K)
    outf.index_add_(0, tok_idx, gathered.float() * flat_w[:, None])
    out = _shared(cfg, p, x, outf.reshape(B, S, D).to(x.dtype))

    frac_tokens = torch.mean(tok_onehot.float(), dim=0)
    frac_probs = torch.mean(probs, dim=0)
    aux = torch.sum(frac_tokens * frac_probs) * E
    return out, aux


def moe_forward(cfg: ModelConfig, p: MoE, x: torch.Tensor):
    if cfg.moe_dispatch == "capacity":
        return moe_mlp_capacity(cfg, p, x)
    return moe_mlp(cfg, p, x)
