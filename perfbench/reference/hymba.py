"""Plain float32 forward of hymba-1.5b, the model the serving cell runs.

Written from the published description (Dong et al., "Hymba: A
Hybrid-head Architecture for Small Language Models", arXiv:2411.13676) and
the configuration file's sizes; it imports nothing of ``repro_torch``.  A
layer is

    h   = rmsnorm(x) * norm1
    x  += (attention(h) + ssm(h)) / 2          # parallel heads, averaged
    x  += swiglu_mlp(rmsnorm(x) * norm2)

with grouped-query attention (RoPE on halves, theta 10,000; a causal
window of ``swa_window`` positions except in the global layers) and a
Mamba2 (SSD) mixer of state ``ssm_state``: a causal depthwise conv of width
``ssm_conv`` and SiLU on (x, B, C); dt = softplus(dt + dt_bias);
h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t; y_t = C_t h_t + D x_t; then
y * silu(z), an RMS norm and the output projection.  The LM head reads the
final RMS norm.

Departures from the paper, as the configuration runs the model: no meta
tokens (the paper prepends 128 learned tokens), no cross-layer KV sharing,
Mamba2 (SSD) heads where the paper uses Mamba heads, and the two head
groups' outputs averaged where the paper normalises and scales each with a
learned vector before the mean.

Everything is float32 with TF32 off (the caller sets
``torch.backends.cuda.matmul.allow_tf32 = False``), one sequence at a
time, layer by layer; the SSM is evaluated in its quadratic (attention)
form over the whole sequence.  ``precision="fp8"`` is the control: every
product's two operands rounded to float8 e4m3 (one scale a tensor, as an
fp8 GEMM takes them) and multiplied with float32 accumulation.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

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


def _rope(x, theta):
    """x [T, H, dh], rotated by position, halves split."""
    T, _, dh = x.shape
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, device=x.device,
                                       dtype=torch.float32) / dh)
    ang = torch.arange(T, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(m, w, h, is_global, mm):
    T = h.shape[0]
    hq, hkv, dh = m["n_heads"], m["n_kv_heads"], m["d_head"]
    q = _rope(mm(h, w["wq"]).reshape(T, hq, dh), m["rope_theta"])
    k = _rope(mm(h, w["wk"]).reshape(T, hkv, dh), m["rope_theta"])
    v = mm(h, w["wv"]).reshape(T, hkv, dh)
    rep = hq // hkv
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    i = torch.arange(T, device=h.device)
    allowed = i[None, :] <= i[:, None]
    if not is_global:
        allowed &= i[None, :] > i[:, None] - m["swa_window"]
    out = torch.empty((T, hq, dh), device=h.device)
    for a in range(hq):                    # one head at a time: T x T fits
        s = mm(q[:, a], k[:, a].T) / math.sqrt(dh)
        s = torch.where(allowed, s, float("-inf"))
        out[:, a] = mm(torch.softmax(s, dim=-1), v[:, a])
    return mm(out.reshape(T, hq * dh), w["wo"])


def ssm(m, w, h, mm):
    T = h.shape[0]
    d = m["d_model"]
    di = m["ssm_expand"] * d
    P, N, K = m["ssm_head_dim"], m["ssm_state"], m["ssm_conv"]
    H = di // P
    zxbcdt = mm(h, w["in_proj"])
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    conv = sum(pad[j:j + T] * w["conv_w"][j] for j in range(K)) + w["conv_b"]
    xbc = F.silu(conv)
    x, B, C = torch.split(xbc, [di, N, N], dim=-1)
    x = x.reshape(T, H, P)
    dt = F.softplus(dt + w["dt_bias"])                     # [T, H]
    A = -torch.exp(w["A_log"])                             # [H]
    cum = torch.cumsum(dt * A, dim=0)                      # [T, H]
    i = torch.arange(T, device=h.device)
    causal = i[None, :] <= i[:, None]
    G = mm(C, B.T)                                         # [T, T]
    xdt = x * dt[..., None]                                # [T, H, P]
    y = torch.empty((T, H, P), device=h.device)
    for a in range(H):
        L = torch.exp(torch.where(causal, cum[:, a, None] - cum[None, :, a],
                                  float("-inf")))
        y[:, a] = mm(G * L, xdt[:, a])
    y = y + x * w["D"][None, :, None]
    y = y.reshape(T, di) * F.silu(z)
    y = rmsnorm(y, w["ssm_norm"], m["norm_eps"])
    return mm(y, w["out_proj"])


def forward_logits(m: dict, weights: Callable[[str], torch.Tensor],
                   tokens: torch.Tensor, precision: str = "f32"
                   ) -> torch.Tensor:
    """Logits [T, vocab] of one sequence.  ``weights(name)`` returns the
    named parameter as float32 on the device (names as in the weight
    layout of ``entries/serve.py``)."""
    mm = _mm(precision)
    eps = m["norm_eps"]
    x = weights("embed")[tokens]
    for li in range(m["n_layers"]):
        def w(name, li=li):
            return weights(f"blocks.{li}.{name}")

        lw: Dict[str, torch.Tensor] = {
            k: w(f"attn.{k}") for k in ("wq", "wk", "wv", "wo")}
        sw = {k: w(f"ssm.{k}") for k in ("in_proj", "conv_w", "conv_b",
                                         "A_log", "D", "dt_bias", "ssm_norm",
                                         "out_proj")}
        h = rmsnorm(x, w("norm1"), eps)
        is_global = li in m["global_attn_layers"]
        x = x + (attention(m, lw, h, is_global, mm) + ssm(m, sw, h, mm)) * 0.5
        h2 = rmsnorm(x, w("norm2"), eps)
        g = F.silu(mm(h2, w("mlp.w_gate")))
        x = x + mm(g * mm(h2, w("mlp.w_up")), w("mlp.w_down"))
    x = rmsnorm(x, weights("final_norm"), eps)
    return mm(x, weights("lm_head"))


def served_gap(logits: torch.Tensor, tokens: torch.Tensor, first: int,
               pick: torch.Tensor = None) -> float:
    """Widest gap by which the token at each position ``t + 1 >= first + 1``
    (the served tokens) lies below the reference's best logit at ``t``;
    with ``pick``, the tokens judged are ``pick`` (a control's firsts)."""
    lg = logits[first:-1] if logits.shape[0] > first else logits[:0]
    served = tokens[first + 1:] if pick is None else pick[first:-1]
    if served.numel() == 0:
        return 0.0
    best = lg.max(dim=-1).values
    got = lg.gather(1, served[:, None].long())[:, 0]
    return float((best - got).max())
