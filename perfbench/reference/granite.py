"""Plain float32 forward of granite-4.0-h-small, the model the
``granite.decode`` cell serves.

Written from GraniteMoeHybrid's equations (hf:ibm-granite/granite-4.0-h-small,
config.json) and the configuration file's sizes; it imports nothing of
``repro_torch``.  Each layer holds one mixer, as ``layer_types`` lists it:

    x  = embed[tokens] * embedding_multiplier
    h  = rmsnorm(x) * norm1
    x += residual_multiplier * mixer(h)          # attention or Mamba2
    h2 = rmsnorm(x) * norm2
    x += residual_multiplier * (routed(h2) + shared(h2))
    logits = (rmsnorm(x) * final_norm) @ embed^T / logits_scaling

Attention is grouped-query with no positional encoding (NoPE): causal
softmax(q k^T * attention_multiplier) v over every earlier position.  The
Mamba2 mixer splits h W_in into z, xBC and dt; xBC passes a causal
depthwise conv of width ``ssm_conv`` with its bias and SiLU and splits
into x, B, C (one group); dt = softplus(dt + dt_bias), A = -exp(A_log);
per head S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T and
y_t = S_t C_t + D x_t; then rmsnorm(y * silu(z)) * ssm_norm over the
whole inner width and the output projection.  The router takes the
``top_k`` largest of h2 W_router and a softmax over those logits alone;
each picked expert is a SwiGLU MLP of width ``moe_d_ff``, weighted by its
gate, and the shared expert (width ``shared_d_ff``) is added unweighted.

Every expert a token picks is computed exactly: no capacity, no drop.  The
program dispatches into capacity buffers of C rows an expert, C rounded
up to 64, and a decode step has at most ``max_batch`` (16) live rows, so
no token of a served step can overflow and the two agree on what is
computed.

Everything is float32 with TF32 off (the caller sets
``torch.backends.cuda.matmul.allow_tf32 = False``), one sequence at a
time, layer by layer, with no cache; the Mamba2 mixer is evaluated in its
quadratic (attention) form over the whole sequence, one head at a time.
``precision="fp8"`` is the control: every product's two operands rounded
to float8 e4m3 (one scale a tensor, as an fp8 GEMM takes them) and
multiplied with float32 accumulation.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.nn.functional as F


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp_min(1e-12) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _mm(precision: str) -> Callable:
    if precision == "f32":
        return torch.matmul
    if precision == "fp8":
        return lambda a, b: torch.matmul(_fp8(a), _fp8(b))
    raise ValueError(precision)


def rmsnorm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def attention(m, w, h, mm):
    T = h.shape[0]
    hq, hkv, dh = m["n_heads"], m["n_kv_heads"], m["d_head"]
    q = mm(h, w("attn.wq")).reshape(T, hq, dh)
    k = mm(h, w("attn.wk")).reshape(T, hkv, dh)
    v = mm(h, w("attn.wv")).reshape(T, hkv, dh)
    rep = hq // hkv
    i = torch.arange(T, device=h.device)
    earlier = i[None, :] <= i[:, None]
    out = torch.empty((T, hq, dh), device=h.device)
    for a in range(hq):                    # one head at a time: T x T fits
        s = mm(q[:, a], k[:, a // rep].T) * m["attention_multiplier"]
        s = torch.where(earlier, s, float("-inf"))
        out[:, a] = mm(torch.softmax(s, dim=-1), v[:, a // rep])
    return mm(out.reshape(T, hq * dh), w("attn.wo"))


def mamba(m, w, h, mm):
    T = h.shape[0]
    di = m["ssm_expand"] * m["d_model"]
    P, N, K = m["ssm_head_dim"], m["ssm_state"], m["ssm_conv"]
    H = di // P
    z, xbc, dt = torch.split(mm(h, w("ssm.in_proj")), [di, di + 2 * N, H],
                             dim=-1)
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    conv_w = w("ssm.conv_w")
    xbc = F.silu(sum(pad[j:j + T] * conv_w[j] for j in range(K))
                 + w("ssm.conv_b"))
    x, B, C = torch.split(xbc, [di, N, N], dim=-1)
    x = x.reshape(T, H, P)
    dt = F.softplus(dt + w("ssm.dt_bias"))                 # [T, H]
    decay = torch.cumsum(dt * -torch.exp(w("ssm.A_log")), dim=0)
    i = torch.arange(T, device=h.device)
    earlier = i[None, :] <= i[:, None]
    CB = mm(C, B.T)                                        # [T, T]
    xdt = x * dt[..., None]
    y = torch.empty((T, H, P), device=h.device)
    for a in range(H):
        L = torch.exp(torch.where(earlier,
                                  decay[:, a, None] - decay[None, :, a],
                                  float("-inf")))
        y[:, a] = mm(CB * L, xdt[:, a])
    y = (y + x * w("ssm.D")[None, :, None]).reshape(T, di) * F.silu(z)
    y = rmsnorm(y, w("ssm.ssm_norm"), m["norm_eps"])
    return mm(y, w("ssm.out_proj"))


def _swiglu(mm, h, gate, up, down):
    return mm(F.silu(mm(h, gate)) * mm(h, up), down)


def experts(m, w, h2, mm, picks: Optional[List[torch.Tensor]] = None):
    """The routed experts' sum, each token's picks weighted by the softmax
    over its ``top_k`` router logits, plus the shared expert.  ``picks``,
    if given, gathers each call's picked experts [T, top_k]."""
    logits, chosen = torch.topk(mm(h2, w("moe.router")), m["top_k"], dim=-1)
    gates = torch.softmax(logits, dim=-1)                  # [T, top_k]
    if picks is not None:
        picks.append(chosen)
    gate_w, up_w, down_w = (w("moe.w_gate"), w("moe.w_up"),
                            w("moe.w_down"))
    out = torch.zeros_like(h2)
    for e in range(m["n_experts"]):
        tok, slot = torch.nonzero(chosen == e, as_tuple=True)
        if tok.numel():
            y = _swiglu(mm, h2[tok], gate_w[e], up_w[e], down_w[e])
            out.index_add_(0, tok, y * gates[tok, slot][:, None])
    return out + _swiglu(mm, h2, w("moe.shared.w_gate"),
                         w("moe.shared.w_up"), w("moe.shared.w_down"))


def forward_logits(m: dict, weights: Callable[[str], torch.Tensor],
                   tokens: torch.Tensor, precision: str = "f32",
                   picks: Optional[List[torch.Tensor]] = None
                   ) -> torch.Tensor:
    """Logits [T, vocab] of one sequence.  ``weights(name)`` returns the
    named parameter as float32 on the device (names as in the weight
    layout of ``entries/serve_granite.py``); ``picks`` gathers every
    layer's routing (see :func:`experts`)."""
    mm = _mm(precision)
    eps, r = m["norm_eps"], m["residual_multiplier"]
    x = weights("embed")[tokens] * m["embedding_multiplier"]
    for li, kind in enumerate(m["layer_types"]):
        def w(name, li=li):
            return weights(f"blocks.{li}.{name}")

        h = rmsnorm(x, w("norm1"), eps)
        mix = attention if kind == "attention" else mamba
        x = x + r * mix(m, w, h, mm)
        h2 = rmsnorm(x, w("norm2"), eps)
        x = x + r * experts(m, w, h2, mm, picks)
    x = rmsnorm(x, weights("final_norm"), eps)
    return mm(x, weights("embed").T) / m["logits_scaling"]
