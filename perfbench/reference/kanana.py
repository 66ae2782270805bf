"""Plain float32 forward of kanana-2-30b-a3b, the model the
``kanana.decode`` cell serves.

Written from the DeepSeek-V3 equations (hf:kakaocorp/kanana-2-30b-a3b-
instruct-2601, config.json, ``model_type`` deepseek_v3, ``q_lora_rank``
null) and the configuration file's sizes; it imports nothing of
``repro_torch``.  Every layer:

    h  = rmsnorm(x) * norm1
    x += mla(h)
    h2 = rmsnorm(x) * norm2
    x += mlp(h2)            # layers before first_k_dense: SwiGLU of d_ff
    x += routed(h2) + shared(h2)                 # every later layer
    logits = (rmsnorm(x) * final_norm) @ lm_head

Multi-head latent attention, in the expanded form: per head the query is
h W_q split into q_nope (qk_nope_head_dim) and q_pe (qk_rope_head_dim);
h W_kv_a splits into the latent c (kv_lora_rank) and k_pe
(qk_rope_head_dim, one for all heads); c = rmsnorm(c) * kv_norm; c W_kv_b
gives each head's k_nope and v (v_head_dim).  q_pe and k_pe are rotated
by interleaved RoPE (each pair (2i, 2i+1) as one complex number times
e^(i pos theta^(-2i/d)), DeepSeek-V3's ``apply_rotary_emb``).  A head
attends causally with q = [q_nope, q_pe], k = [k_nope, k_pe] at
1/sqrt(qk_nope_head_dim + qk_rope_head_dim) (``rope_scaling`` is null: no
YaRN factor).

The router (``scoring_func`` sigmoid, ``topk_method`` noaux_tc, one
expert group): scores = sigmoid(h2 W_router) in f32; the ``top_k``
experts of scores + correction_bias are picked; their weights are their
unbiased scores over the scores' sum (+1e-20), times ``routed_scaling``.
Each picked expert is a SwiGLU MLP of width ``moe_d_ff``; the two shared
experts are one SwiGLU of ``shared_d_ff`` (2 x 768), added unweighted.

Every expert a token picks is computed exactly: no capacity, no drop.  The
program dispatches into capacity buffers of C rows an expert, C rounded
up to 64, and a decode step has at most ``max_batch`` (32) live rows, each
picking distinct experts, so no expert of a served step receives more
than 32 picks, and the two agree on what is computed.

Everything is float32 with TF32 off (the caller sets
``torch.backends.cuda.matmul.allow_tf32 = False``), one sequence at a
time, layer by layer, one head at a time, with no cache.
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


def rotate(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, ..., d] rotated at positions ``pos`` [T]: pairs (2i, 2i+1)
    as complex numbers times e^(i pos theta^(-2i/d))."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                    device=x.device) / d)
    ang = pos.double()[:, None] * freqs                    # [T, d/2]
    turn = torch.polar(torch.ones_like(ang), ang).to(torch.complex64)
    turn = turn.reshape(turn.shape[:1] + (1,) * (x.dim() - 2)
                        + turn.shape[1:])
    xc = torch.view_as_complex(x.float().reshape(*x.shape[:-1], d // 2, 2)
                               .contiguous())
    return torch.view_as_real(xc * turn).reshape(x.shape)


def attention(m, w, h, mm):
    T = h.shape[0]
    H, r = m["n_heads"], m["kv_lora_rank"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    pos = torch.arange(T, device=h.device)
    q = mm(h, w("attn.wq")).reshape(T, H, dn + dr)
    q_nope, q_pe = q[..., :dn], rotate(q[..., dn:], pos, m["rope_theta"])
    kv_a = mm(h, w("attn.wkv_a"))
    c = rmsnorm(kv_a[:, :r], w("attn.kv_norm"), m["norm_eps"])
    k_pe = rotate(kv_a[:, r:], pos, m["rope_theta"])       # [T, dr]
    kv = mm(c, w("attn.wkv_b")).reshape(T, H, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    scale = (dn + dr) ** -0.5
    earlier = pos[None, :] <= pos[:, None]
    out = torch.empty((T, H, dv), device=h.device)
    for a in range(H):                     # one head at a time: T x T fits
        qa = torch.cat([q_nope[:, a], q_pe[:, a]], dim=-1)
        ka = torch.cat([k_nope[:, a], k_pe], dim=-1)
        s = torch.where(earlier, mm(qa, ka.T) * scale, float("-inf"))
        out[:, a] = mm(torch.softmax(s, dim=-1), v[:, a])
    return mm(out.reshape(T, H * dv), w("attn.wo"))


def _swiglu(mm, h, gate, up, down):
    return mm(F.silu(mm(h, gate)) * mm(h, up), down)


def route(m, w, h2, mm):
    """(picks [T, top_k], their weights [T, top_k]) of the noaux_tc
    router."""
    scores = torch.sigmoid(mm(h2, w("moe.router")))
    picks = torch.topk(scores + w("moe.correction_bias"), m["top_k"],
                       dim=-1).indices
    weights = scores.gather(1, picks)
    weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    return picks, weights * m["routed_scaling"]


def experts(m, w, h2, mm, picks: Optional[List] = None):
    """The routed experts' weighted sum plus the shared experts.
    ``picks``, if given, gathers each call's (picks, weights)."""
    chosen, gates = route(m, w, h2, mm)
    if picks is not None:
        picks.append((chosen, gates))
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
                   picks: Optional[List] = None) -> torch.Tensor:
    """Logits [T, vocab] of one sequence.  ``weights(name)`` returns the
    named parameter as float32 on the device (names as in the weight
    layout of ``entries/serve_kanana.py``); ``picks`` gathers every MoE
    layer's routing (see :func:`experts`)."""
    mm = _mm(precision)
    eps = m["norm_eps"]
    x = weights("embed")[tokens]
    for li in range(m["n_layers"]):
        def w(name, li=li):
            return weights(f"blocks.{li}.{name}")

        x = x + attention(m, w, rmsnorm(x, w("norm1"), eps), mm)
        h2 = rmsnorm(x, w("norm2"), eps)
        if li < m["first_k_dense"]:
            x = x + _swiglu(mm, h2, w("mlp.w_gate"), w("mlp.w_up"),
                            w("mlp.w_down"))
        else:
            x = x + experts(m, w, h2, mm, picks)
    x = rmsnorm(x, weights("final_norm"), eps)
    return mm(x, weights("lm_head"))
