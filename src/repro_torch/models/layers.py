"""Shared model layers: norms, RoPE / M-RoPE, GQA attention (full + sliding
window; train, prefill, and single-token decode), multi-head latent
attention (MLA: expanded for train and prefill, absorbed over a latent
cache for decode), dense MLPs.

The torch port of ``repro.models.layers``: the same arithmetic in the same
order and types, as plain torch ops (the JAX package has no Pallas here).
Attention is written out with einsum, never
``scaled_dot_product_attention``, because the port is held against this
arithmetic: f32 scores, ``-1e30`` masking, probabilities cast to the query
type before the PV product.  One kernel keeps that arithmetic by hand: on a
plain CUDA cache, single-token decode attention is one launch of
``kernels/csrc/decode_attn.cu``, which reads each row's live ring slots in
place; elsewhere (the CPU, and DTensor caches, whose softmax spans ranks)
it is ``sdpa_decode_plain``.  Parameters live on small ``nn.Module``s whose
attribute names are the reference's parameter keys.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.ops import decode_attention_cuda
from .config import ModelConfig
from .shardctx import (
    constrain,
    heads_are_tp,
    merge_dims,
    split_dim,
    write_rows_,
)


class Init:
    """Random init on one device: one ``torch.Generator`` draws every
    parameter in f32 (scaled as the reference's ``init_params``), then casts
    it to the model's type, so a bf16 model is its f32 twin rounded.  On
    the ``meta`` device nothing is drawn."""

    def __init__(self, device: torch.device, dtype: torch.dtype,
                 seed: int) -> None:
        self.device, self.dtype = device, dtype
        self.gen = None
        if device.type != "meta":
            self.gen = torch.Generator(device=device)
            self.gen.manual_seed(seed)

    def _param(self, t: torch.Tensor) -> nn.Parameter:
        return nn.Parameter(t.to(self.dtype))

    def normal(self, shape, scale: float) -> nn.Parameter:
        t = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=torch.float32)
        return self._param(t * scale)

    def full(self, shape, value: float) -> nn.Parameter:
        return self._param(torch.full(shape, value, device=self.device,
                                      dtype=torch.float32))

    def value(self, t: torch.Tensor) -> nn.Parameter:
        return self._param(t.to(device=self.device, dtype=torch.float32))


# ----------------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * w


# ----------------------------------------------------------------------------
# RoPE / M-RoPE
# ----------------------------------------------------------------------------
def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, dh]; pos: [B, S] int32.  Halves split, not
    interleaved."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)      # [dh/2]
    return _rotate(x, pos[..., None].float() * freqs)     # ang [B, S, dh/2]


def apply_mrope(
    x: torch.Tensor, pos3: torch.Tensor, theta: float,
    sections: Tuple[int, int, int],
) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  pos3: [3, B, S] (t/h/w position streams);
    the dh/2 frequency slots are split into 3 sections, each rotated by its
    own stream."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    freqs = rope_freqs(x.shape[-1], theta, x.device)      # [half]
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(sections, device=x.device), output_size=half)
    pos_sel = torch.movedim(pos3[sec_id], 0, -1)          # [B, S, half]
    return _rotate(x, pos_sel.float() * freqs)


def rope_pairs(x: torch.Tensor, pos: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, d]; pos: [B, S].  Interleaved RoPE: each pair (2i,
    2i+1) rotated by pos * theta^(-2i/d), as DeepSeek-V3's complex
    rotation (its config's ``rope_interleave``); MLA's rope part."""
    ang = pos[..., None].float() * rope_freqs(x.shape[-1], theta, x.device)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xp = x.float().unflatten(-1, (-1, 2))
    x1, x2 = xp[..., 0], xp[..., 1]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.flatten(-2).to(x.dtype)


def _position_embed(cfg: ModelConfig, q, k, positions):
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.pos == "mrope":
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return q, k


# ----------------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------------
def attn_scale(cfg: ModelConfig, d_head: int) -> float:
    """The softmax scale: ``attention_multiplier`` where the config gives
    one (Granite's 1/128), else 1/sqrt(d_head)."""
    return cfg.attention_multiplier or 1.0 / math.sqrt(d_head)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, init: Init) -> None:
        super().__init__()
        d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        s = d ** -0.5
        self.wq = init.normal((d, hq * dh), s)
        self.wk = init.normal((d, hkv * dh), s)
        self.wv = init.normal((d, hkv * dh), s)
        self.wo = init.normal((hq * dh, d), (hq * dh) ** -0.5)
        if cfg.qk_norm:
            self.q_norm = init.full((dh,), 1.0)
            self.k_norm = init.full((dh,), 1.0)


def _qkv(cfg: ModelConfig, p: Attention, x: torch.Tensor):
    q = split_dim(x @ p.wq, -1, (cfg.n_heads, cfg.d_head))
    k = split_dim(x @ p.wk, -1, (cfg.n_kv_heads, cfg.d_head))
    v = split_dim(x @ p.wv, -1, (cfg.n_kv_heads, cfg.d_head))
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    return q, k, v


def _sdpa(cfg: ModelConfig, q, k, v, mask) -> torch.Tensor:
    """q, k: [B,S,Hq,dh], [B,T,Hkv,dh]; v: [B,T,Hkv,dv]; mask: [B,1,S,T]
    or broadcastable.

    Grouped GQA form (no KV head repeat): scores in f32, masked with -1e30,
    softmax in f32, probabilities cast to q's type for the PV product.  The
    scores constraint keeps the T axis sharded under decode rules; softmax
    and the PV contraction then become partial reductions."""
    Hq, Hkv = q.shape[2], k.shape[2]
    qg = split_dim(q, 2, (Hkv, Hq // Hkv))
    scale = attn_scale(cfg, q.shape[3])
    logits = torch.einsum("bsgrd,btgd->bgrst", qg, k).float() * scale
    logits = constrain(logits, "scores5")             # [B,G,rep,S,T]
    logits = torch.where(mask[:, :, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    probs = constrain(probs, "scores5")               # stay T-sharded into PV
    o = torch.einsum("bgrst,btge->bsgre", probs, v)
    return merge_dims(o, 2)


def sdpa_decode_plain(cfg: ModelConfig, q, kc, vc,
                      cur_pos: torch.Tensor) -> torch.Tensor:
    """One token's attention over each row's ring, as plain ops: q [B, 1,
    Hq, dh], kc/vc [B, C, Hkv, dh], ``cur_pos`` [B] the tokens each row held
    before this one.  A ring slot t is valid if written (t <= cur_pos) or
    the ring has wrapped (cur_pos >= C).  Returns [B, 1, Hq, dh]."""
    C = kc.shape[1]
    t = torch.arange(C, device=q.device)
    valid = (t[None, :] <= cur_pos[:, None]) | (cur_pos[:, None] >= C)
    return _sdpa(cfg, q, kc, vc, valid[:, None, None, :])   # mask [B,1,1,C]


def make_attn_mask(
    cfg: ModelConfig, S: int, is_global: bool, device=None,
) -> torch.Tensor:
    """[1, 1, S, S] boolean mask for training/prefill."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    if cfg.causal:
        m = j <= i
    else:
        m = torch.ones((S, S), dtype=torch.bool, device=device)
    if cfg.attn == "swa" and not is_global:
        m = m & (j > i - cfg.swa_window)
    return m[None, None]


def _sdpa_blockwise(
    cfg: ModelConfig, q, k, v, *, is_global: bool, block: int = 512,
) -> torch.Tensor:
    """Flash-style blockwise attention: online softmax over KV blocks (a
    Python loop where the reference scans).  Never materializes the S x S
    score matrix; GQA is computed grouped (no KV head repeat)."""
    B, S, Hq, dh = q.shape
    Hkv, dv = k.shape[2], v.shape[3]
    rep = Hq // Hkv
    if S % 16 == 0 and S // 16 >= 128:
        qb = S // 16
    else:
        qb = min(block, S)
    kvb = min(block, S)
    nq, nk = S // qb, S // kvb
    scale = attn_scale(cfg, dh)
    dev = q.device
    qg = q.reshape(B, nq, qb, Hkv, rep, dh)
    kg = k.reshape(B, nk, kvb, Hkv, dh)
    vg = v.reshape(B, nk, kvb, Hkv, dv)
    q_pos = torch.arange(S, device=dev).reshape(nq, qb)

    acc = torch.zeros((B, nq, qb, Hkv, rep, dv), dtype=torch.float32,
                      device=dev)
    m = torch.full((B, nq, qb, Hkv, rep), -math.inf, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, nq, qb, Hkv, rep), dtype=torch.float32, device=dev)
    for kidx in range(nk):
        kblk, vblk = kg[:, kidx], vg[:, kidx]
        logits = torch.einsum(
            "bnqhrd,bkhd->bnqhrk", qg, kblk
        ).float() * scale                                  # [B,nq,qb,H,r,kvb]
        k_pos = kidx * kvb + torch.arange(kvb, device=dev)
        msk = torch.ones((nq, qb, kvb), dtype=torch.bool, device=dev)
        if cfg.causal:
            msk = msk & (k_pos[None, None, :] <= q_pos[:, :, None])
        if cfg.attn == "swa" and not is_global:
            msk = msk & (
                k_pos[None, None, :] > q_pos[:, :, None] - cfg.swa_window
            )
        logits = torch.where(msk[None, :, :, None, None, :], logits, -1e30)
        new_m = torch.maximum(m, torch.amax(logits, dim=-1))
        alpha = torch.exp(m - new_m)
        pexp = torch.exp(logits - new_m[..., None])
        acc = acc * alpha[..., None] + torch.einsum(
            "bnqhrk,bkhe->bnqhre", pexp.to(q.dtype), vblk
        ).float()
        l = l * alpha + torch.sum(pexp, dim=-1)
        m = new_m
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(B, S, Hq, dv).to(q.dtype)


def _sdpa_blockwise_flat(
    cfg: ModelConfig, q, k, v, *, is_global: bool, block: int = 512,
) -> torch.Tensor:
    """Blockwise attention over FLAT heads (KV repeated to Hq) — the TP
    layout: Hq divides the model axis even when (G, rep) factors don't.
    The KV repeat is a local slice of a replicated tensor under the
    "heads" rule.  The same online softmax as ``_sdpa_blockwise``, a
    Python loop over KV blocks."""
    B, S, Hq, dh = q.shape
    rep = Hq // k.shape[2]
    k = constrain(torch.repeat_interleave(k, rep, dim=2), "heads")
    v = constrain(torch.repeat_interleave(v, rep, dim=2), "heads")
    qb = min(block, S)
    kvb = min(block, S)
    nq, nk = S // qb, S // kvb
    scale = attn_scale(cfg, dh)
    dev = q.device
    qf = q.reshape(B, nq, qb, Hq, dh)
    kg = k.reshape(B, nk, kvb, Hq, dh)
    vg = v.reshape(B, nk, kvb, Hq, dh)
    q_pos = torch.arange(S, device=dev).reshape(nq, qb)

    acc = torch.zeros((B, nq, qb, Hq, dh), dtype=torch.float32, device=dev)
    m = torch.full((B, nq, qb, Hq), -math.inf, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, nq, qb, Hq), dtype=torch.float32, device=dev)
    for kidx in range(nk):
        kblk, vblk = kg[:, kidx], vg[:, kidx]
        logits = torch.einsum(
            "bnqhd,bkhd->bnqhk", qf, kblk
        ).float() * scale                                  # [B,nq,qb,Hq,kvb]
        k_pos = kidx * kvb + torch.arange(kvb, device=dev)
        msk = torch.ones((nq, qb, kvb), dtype=torch.bool, device=dev)
        if cfg.causal:
            msk = msk & (k_pos[None, None, :] <= q_pos[:, :, None])
        if cfg.attn == "swa" and not is_global:
            msk = msk & (
                k_pos[None, None, :] > q_pos[:, :, None] - cfg.swa_window
            )
        logits = torch.where(msk[None, :, :, None, :], logits, -1e30)
        new_m = torch.maximum(m, torch.amax(logits, dim=-1))
        alpha = torch.exp(m - new_m)
        pexp = torch.exp(logits - new_m[..., None])
        acc = acc * alpha[..., None] + torch.einsum(
            "bnqhk,bkhd->bnqhd", pexp.to(q.dtype), vblk
        ).float()
        l = l * alpha + torch.sum(pexp, dim=-1)
        m = new_m
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(B, S, Hq, dh).to(q.dtype)


def attention_train(
    cfg: ModelConfig, p: Attention, x: torch.Tensor,
    positions: torch.Tensor, is_global: bool,
) -> torch.Tensor:
    S = x.shape[1]
    q, k, v = _qkv(cfg, p, x)
    q, k = _position_embed(cfg, q, k, positions)
    q = constrain(q, "heads")
    k = constrain(k, "kv_heads")
    v = constrain(v, "kv_heads")
    if S > 1024 and heads_are_tp():
        o = _sdpa_blockwise_flat(cfg, q, k, v, is_global=is_global)
        o = constrain(o, "heads")
        return merge_dims(o, 2) @ p.wo
    if S > 1024:
        o = _sdpa_blockwise(cfg, q, k, v, is_global=is_global)
    else:
        o = _sdpa(cfg, q, k, v, make_attn_mask(cfg, S, is_global, x.device))
    o = constrain(o, "heads")
    return merge_dims(o, 2) @ p.wo


def attention_decode(
    cfg: ModelConfig, p: Attention, x: torch.Tensor,
    kv_cache: Tuple[torch.Tensor, torch.Tensor],
    cur_pos: torch.Tensor,                    # [B] int32: tokens so far
    positions: torch.Tensor,                  # [B, 1] (or [3,B,1] mrope)
    is_global: bool,
    active: torch.Tensor,                     # [B] int32 (0 => don't write)
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Single-token decode with a ring-buffered, PER-SEQUENCE KV cache.

    kv_cache: (k, v) each [B, C, Hkv, dh]; C = full seq_len for global
    layers, swa_window for windowed layers.  Each sequence writes at its own
    cur_pos[b] % C, IN PLACE: an inactive row writes back the slot it holds
    (the reference drops its out-of-bounds scatter), so its K/V stay
    untouched and no row's arithmetic depends on another's.  The attention
    then reads each row's live slots: one ``decode_attn.cu`` launch on a
    plain CUDA cache (any other head size or type there raises), else
    ``sdpa_decode_plain``."""
    kc, vc = kv_cache
    C = kc.shape[1]
    q, k, v = _qkv(cfg, p, x)
    q, k = _position_embed(cfg, q, k, positions)
    slot = (cur_pos % C).long()
    keep = (active > 0)[:, None, None]
    write_rows_(kc, slot, k[:, 0].to(kc.dtype), keep)
    write_rows_(vc, slot, v[:, 0].to(vc.dtype), keep)
    if getattr(kc, "placements", None) is None and kc.is_cuda:
        o = decode_attention_cuda(q, kc, vc, cur_pos,
                                  attn_scale(cfg, q.shape[3]))
    else:
        o = sdpa_decode_plain(cfg, q, kc, vc, cur_pos)
    out = merge_dims(o, 2) @ p.wo
    return out, (kc, vc)


# ----------------------------------------------------------------------------
# multi-head latent attention
# ----------------------------------------------------------------------------
class MLA(nn.Module):
    """DeepSeek-V3's attention without q-LoRA: ``wq`` gives each head's
    query (qk_nope_head_dim, then qk_rope_head_dim); ``wkv_a`` the
    token's latent (kv_lora_rank, normalised by ``kv_norm``) and its
    shared key part (qk_rope_head_dim); ``wkv_b`` each head's key part
    and value (qk_nope_head_dim, then v_head_dim) from the latent."""

    def __init__(self, cfg: ModelConfig, init: Init) -> None:
        super().__init__()
        d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
        s = d ** -0.5
        self.wq = init.normal((d, h * cfg.d_head), s)
        self.wkv_a = init.normal((d, cfg.latent_width), s)
        self.kv_norm = init.full((r,), 1.0)
        self.wkv_b = init.normal(
            (r, h * (cfg.qk_nope_head_dim + cfg.v_head_dim)), r ** -0.5)
        self.wo = init.normal((h * cfg.v_head_dim, d),
                              (h * cfg.v_head_dim) ** -0.5)


def mla_query(cfg: ModelConfig, p: MLA, x, positions):
    """Each head's query parts [B, S, H, qk_nope_head_dim] and, rotated,
    [B, S, H, qk_rope_head_dim]."""
    q = split_dim(x @ p.wq, -1, (cfg.n_heads, cfg.d_head))
    q_nope, q_pe = torch.split(
        q, [cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], dim=-1)
    return q_nope, rope_pairs(q_pe, positions, cfg.rope_theta)


def mla_latent(cfg: ModelConfig, p: MLA, x, positions):
    """What a token caches, [B, S, kv_lora_rank + qk_rope_head_dim]: its
    latent after ``kv_norm``, then its key part rotated at its
    position."""
    c, k_pe = torch.split(x @ p.wkv_a,
                          [cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
    c = rmsnorm(c, p.kv_norm, cfg.norm_eps)
    k_pe = rope_pairs(k_pe[:, :, None, :], positions,
                      cfg.rope_theta)[:, :, 0]
    return torch.cat([c, k_pe], dim=-1)


def mla_train(cfg: ModelConfig, p: MLA, x: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """The expanded form (train, prefill): per-head K = [latent @ W_UK,
    the shared rotated key part] and V = latent @ W_UV, causal attention
    at 1/sqrt(d_head)."""
    B, S, _ = x.shape
    H, dn, r = cfg.n_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    q_nope, q_pe = mla_query(cfg, p, x, positions)
    c, k_pe = torch.split(mla_latent(cfg, p, x, positions),
                          [r, cfg.qk_rope_head_dim], dim=-1)
    k_nope, v = torch.split(split_dim(c @ p.wkv_b, -1,
                                      (H, dn + cfg.v_head_dim)),
                            [dn, cfg.v_head_dim], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(
        B, S, H, cfg.qk_rope_head_dim)], dim=-1)
    if S > 1024:
        o = _sdpa_blockwise(cfg, q, k, v, is_global=True)
    else:
        o = _sdpa(cfg, q, k, v, make_attn_mask(cfg, S, True, x.device))
    return merge_dims(o, 2) @ p.wo


def mla_decode(
    cfg: ModelConfig, p: MLA, x: torch.Tensor, latent: torch.Tensor,
    cur_pos: torch.Tensor, positions: torch.Tensor, active: torch.Tensor,
) -> torch.Tensor:
    """Single-token MLA over the latent cache, absorbed: ``latent`` [B, C,
    kv_lora_rank + qk_rope_head_dim] holds each row's tokens at ``pos %
    C``.  The row's new latent is written in place at ``cur_pos`` (an
    inactive row writes back its slot); then q_lat = q_nope W_UK, scores
    [q_lat, q_pe] . latent at 1/sqrt(d_head) over the row's valid slots
    (as ``sdpa_decode_plain``'s), o = softmax . latent's first
    kv_lora_rank values, times W_UV and ``wo``.  No per-head K or V is
    formed."""
    B, C, _ = latent.shape
    H, dn, r = cfg.n_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    q_nope, q_pe = mla_query(cfg, p, x, positions)
    row = mla_latent(cfg, p, x, positions)[:, 0]
    write_rows_(latent, (cur_pos % C).long(), row.to(latent.dtype),
                (active > 0)[:, None])
    w_uk, w_uv = torch.split(split_dim(p.wkv_b, -1,
                                       (H, dn + cfg.v_head_dim)),
                             [dn, cfg.v_head_dim], dim=-1)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], w_uk)
    q_all = torch.cat([q_lat, q_pe[:, 0].to(q_lat.dtype)], dim=-1)
    scores = torch.einsum("bhc,btc->bht", q_all, latent).float() \
        * attn_scale(cfg, cfg.d_head)
    t = torch.arange(C, device=x.device)
    valid = (t[None, :] <= cur_pos[:, None]) | (cur_pos[:, None] >= C)
    scores = torch.where(valid[:, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bht,btr->bhr", probs, latent[..., :r])
    o = torch.einsum("bhr,rhv->bhv", o_lat, w_uv)
    return o.reshape(B, 1, H * cfg.v_head_dim) @ p.wo


# ----------------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, init: Init,
                 d_ff: Optional[int] = None) -> None:
        super().__init__()
        d = cfg.d_model
        ff = d_ff if d_ff is not None else cfg.d_ff
        if cfg.act == "swiglu":
            self.w_gate = init.normal((d, ff), d ** -0.5)
        self.w_up = init.normal((d, ff), d ** -0.5)
        self.w_down = init.normal((ff, d), ff ** -0.5)


def mlp(cfg: ModelConfig, p: MLP, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "swiglu":
        g = F.silu(x @ p.w_gate)
        u = x @ p.w_up
        h = constrain(g * u, "ffn")
        return h @ p.w_down
    if cfg.act == "relu2":   # squared ReLU (Nemotron-4 / Primer)
        h = F.relu(x @ p.w_up)
        h = constrain(h * h, "ffn")
        return h @ p.w_down
    raise ValueError(cfg.act)
