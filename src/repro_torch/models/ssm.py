"""Mamba2 / SSD (state-space duality, arXiv:2405.21060) — chunked training
scan + single-token recurrent decode.

The torch port of ``repro.models.ssm``: the "minimal SSD" algorithm (paper
Listing 1), intra-chunk quadratic (duality with masked attention) plus the
inter-chunk recurrent state pass, as a Python loop over chunks where the
reference scans.  softplus, ``exp(dt * A)`` and the decay sums stay in f32
as the reference keeps them.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.ops import ssm_state_update_cuda
from .config import ModelConfig
from .layers import Init
from .shardctx import constrain, merge_dims


def cumsum_last(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis in log2(q) shifted adds (a
    Hillis-Steele scan).  Elementwise adds only, so it rounds the same way
    on every run and device; ``torch.cumsum`` of floats on CUDA makes no
    such promise and raises under ``torch.use_deterministic_algorithms``,
    which bit-exact training replay needs."""
    q, k = x.shape[-1], 1
    while k < q:
        x = torch.cat([x[..., :k], x[..., k:] + x[..., :-k]], dim=-1)
        k *= 2
    return x


def segsum(x: torch.Tensor) -> torch.Tensor:
    """[..., q] -> [..., q, q] lower-triangular segment sums."""
    q = x.shape[-1]
    cs = cumsum_last(x)
    d = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(q, device=x.device)
    mask = i[:, None] >= i[None, :]
    return torch.where(mask, d, -math.inf)


def ssd_chunked(
    X: torch.Tensor,      # [B, L, H, P]   (already multiplied by dt)
    A: torch.Tensor,      # [B, L, H]      (dt * A, negative)
    Bm: torch.Tensor,     # [B, L, G, N]
    Cm: torch.Tensor,     # [B, L, G, N]
    chunk: int,
    init_state: Optional[torch.Tensor] = None,   # [B, H, P, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (Y [B, L, H, P], final_state [B, H, P, N])."""
    b, l, h, p = X.shape
    g, n = Bm.shape[2], Bm.shape[3]
    assert l % chunk == 0, (l, chunk)
    c = l // chunk
    rep = h // g
    X = X.reshape(b, c, chunk, h, p)
    A = A.reshape(b, c, chunk, h).permute(0, 3, 1, 2)        # [b,h,c,q]
    Bm = Bm.reshape(b, c, chunk, g, n).repeat_interleave(rep, dim=3)
    Cm = Cm.reshape(b, c, chunk, g, n).repeat_interleave(rep, dim=3)

    A = A.float()
    A_cs = cumsum_last(A)                                    # [b,h,c,q]

    # 1. intra-chunk (diagonal blocks): quadratic "attention" form
    L = torch.exp(segsum(A))                                 # [b,h,c,q,q]
    Y_diag = torch.einsum(
        "bcshn,bczhn,bhcsz,bczhp->bcshp",
        Cm, Bm, L.to(Cm.dtype), X,
    )

    # 2. chunk-final states
    decay_states = torch.exp(A_cs[..., -1:] - A_cs)          # [b,h,c,q]
    states = torch.einsum(
        "bczhn,bhcz,bczhp->bchpn", Bm,
        decay_states.to(Bm.dtype), X,
    )                                                        # [b,c,h,p,n]

    # 3. inter-chunk recurrence over chunk-final states
    if init_state is None:
        init_state = torch.zeros((b, h, p, n), dtype=states.dtype,
                                 device=states.device)
    chunk_decay = torch.exp(A_cs[..., -1])                   # [b,h,c]
    states = constrain(states, "ssm_states")
    carry, prev = init_state, []
    for ci in range(c):
        prev.append(carry)                                   # the PRE-state
        dec = chunk_decay[:, :, ci]                          # [b,h]
        carry = carry * dec[..., None, None].to(carry.dtype) + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                   # [b,c,h,p,n]

    # 4. state -> output within each chunk
    state_decay = torch.exp(A_cs)                            # [b,h,c,q]
    Y_off = torch.einsum(
        "bcshn,bchpn,bhcs->bcshp",
        Cm, prev_states, state_decay.to(Cm.dtype),
    )
    Y = (Y_diag + Y_off).reshape(b, l, h, p)
    return Y, carry


class SSM(nn.Module):
    def __init__(self, cfg: ModelConfig, init: Init) -> None:
        super().__init__()
        d = cfg.d_model
        di, g, N, h = (cfg.ssm_d_inner, cfg.ssm_groups, cfg.ssm_state,
                       cfg.ssm_heads)
        conv_dim = cfg.ssm_conv_dim
        in_dim = 2 * di + 2 * g * N + h    # z, x, B, C, dt
        self.in_proj = init.normal((d, in_dim), d ** -0.5)
        self.conv_w = init.normal((cfg.ssm_conv, conv_dim), 0.2)
        self.conv_b = init.full((conv_dim,), 0.0)
        self.A_log = init.value(torch.log(torch.linspace(1.0, 16.0, h)))
        self.D = init.full((h,), 1.0)
        self.dt_bias = init.full((h,), 0.0)
        self.ssm_norm = init.full((di,), 1.0)
        self.out_proj = init.normal((di, d), di ** -0.5)


def _split_in_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, h = cfg.ssm_d_inner, cfg.ssm_heads
    z, xBC, dt = torch.split(zxbcdt, [di, cfg.ssm_conv_dim, h], dim=-1)
    return z, xBC, dt


def _gated_rmsnorm(x, z, w, eps):
    x = x * F.silu(z)
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def ssm_train(cfg: ModelConfig, p: SSM, u: torch.Tensor) -> torch.Tensor:
    """Full-sequence Mamba2 mixer: u [B, L, D] -> [B, L, D]."""
    B, L, _ = u.shape
    di, g, N, h = cfg.ssm_d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    P = cfg.ssm_head_dim
    zxbcdt = u @ p.in_proj
    z, xBC, dt = _split_in_proj(cfg, zxbcdt)

    # causal depthwise conv over time (kernel k)
    k = cfg.ssm_conv
    pad = F.pad(xBC, (0, 0, k - 1, 0))
    conv = sum(
        pad[:, i:i + L, :] * p.conv_w[i][None, None, :] for i in range(k)
    ) + p.conv_b
    xBC = F.silu(conv)

    x, Bm, Cm = torch.split(xBC, [di, g * N, g * N], dim=-1)
    x = x.reshape(B, L, h, P)
    Bm = Bm.reshape(B, L, g, N)
    Cm = Cm.reshape(B, L, g, N)
    dt = F.softplus(dt.float() + p.dt_bias.float())
    A = -torch.exp(p.A_log.float())                          # [h]
    Y, _ = ssd_chunked(
        x * dt[..., None].to(x.dtype),
        dt * A,                                              # [B,L,h]
        Bm, Cm, cfg.ssm_chunk,
    )
    Y = Y + x * p.D[None, None, :, None]
    y = _gated_rmsnorm(merge_dims(Y, 2), z, p.ssm_norm, cfg.norm_eps)
    return y @ p.out_proj


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype,
                   device) -> Dict[str, torch.Tensor]:
    return {
        "state": torch.zeros(
            (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
            dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.ssm_conv_dim),
                            dtype=dtype, device=device),
    }


def ssm_state_update_plain(
    state: torch.Tensor, dA: torch.Tensor, xdt: torch.Tensor,
    Bm: torch.Tensor, Cm: torch.Tensor, active: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba2 single-token state update of one layer, in plain PyTorch
    (the plain version of ``kernels/csrc/ssm_update.cu``).  ``state`` [B,
    H, P, N]; ``dA`` [B, H] and ``xdt`` [B, H, P] (x * dt) in the state's
    type; ``Bm``, ``Cm`` [B, G, N], head h reading group h // (H // G).
    Returns (the new state, with rows where ``active`` is 0 kept as they
    were, and y [B, H, P] read out of the new state for every row).  New
    tensors; ``state`` is not written."""
    rep = state.shape[1] // Bm.shape[1]
    Bm = Bm.repeat_interleave(rep, dim=1)                      # [B,H,N]
    Cm = Cm.repeat_interleave(rep, dim=1)
    st = state * dA[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", xdt, Bm).to(state.dtype)
    y = torch.einsum("bhpn,bhn->bhp", st, Cm)
    if active is not None:
        st = torch.where((active > 0)[:, None, None, None], st, state)
    return st, y


def ssm_decode(
    cfg: ModelConfig, p: SSM, u: torch.Tensor, cache: Dict,
    active: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict]:
    """Single-token recurrent step: u [B, 1, D].  Rows with active==0 keep
    their state and conv window unchanged (mixed-length serving batches).
    The state update runs as one launch of ``ssm_update.cu`` on a CUDA
    state, which it writes in place (the returned dict then holds the
    cache's own state tensor), and as ``ssm_state_update_plain`` elsewhere;
    every other tensor returned is new, and the conv window is not
    written."""
    B = u.shape[0]
    di, g, N, h = cfg.ssm_d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    P = cfg.ssm_head_dim
    zxbcdt = u[:, 0, :] @ p.in_proj
    z, xBC, dt = _split_in_proj(cfg, zxbcdt)

    # rolling conv buffer
    win = torch.cat([cache["conv"], xBC[:, None, :]], dim=1)   # [B,k,cd]
    conv = torch.einsum("bkc,kc->bc", win, p.conv_w) + p.conv_b
    new_conv = win[:, 1:, :]
    xBC = F.silu(conv)

    x, Bm, Cm = torch.split(xBC, [di, g * N, g * N], dim=-1)
    x = x.reshape(B, h, P)
    Bm = Bm.reshape(B, g, N)
    Cm = Cm.reshape(B, g, N)
    dt = F.softplus(dt.float() + p.dt_bias.float())
    A = -torch.exp(p.A_log.float())
    st = cache["state"]
    dA = torch.exp(dt * A).to(st.dtype)                        # [B,h]
    xdt = x * dt[..., None].to(x.dtype)
    if st.is_cuda:
        mask = (torch.ones((B,), dtype=torch.int32, device=st.device)
                if active is None else active.to(torch.int32))
        y = ssm_state_update_cuda(st, dA, xdt, Bm, Cm, mask)
    else:
        st, y = ssm_state_update_plain(st, dA, xdt, Bm, Cm, active)
    y = y + x * p.D[None, :, None]
    y = _gated_rmsnorm(y.reshape(B, di), z, p.ssm_norm, cfg.norm_eps)
    out = (y @ p.out_proj)[:, None, :]
    if active is not None:
        keep = active > 0
        new_conv = torch.where(keep[:, None, None], new_conv, cache["conv"])
    return out, {"state": st, "conv": new_conv}
