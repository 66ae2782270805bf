"""The least bytes and the model FLOPs of one kanana-2-30b-a3b decode step,
the yardstick of ``decode_graph_roofline.kanana`` and ``serve.mfu.kanana``
(bf16 = 2 bytes; peaks in ``counts.py``).

A step must read every weight outside the routed experts once (but of the
untied embedding only its live rows' rows), and of the routed experts only
those its live rows picked: ``touched`` experts a step, from the program's
device counter ``moe.experts_touched`` over the traced steps.  Each live
row reads its latent cache (kv_lora_rank + qk_rope_head_dim values a
token) at its real context and writes its new latent row once in every
layer, and writes f32 logits.  Its FLOPs: 2 a parameter it multiplies
(the embedding is a lookup), and the absorbed attention at its real
context: per head and slot, the score over the whole latent row and the
weighted sum over the latent.
"""
from __future__ import annotations

from typing import Sequence

BF16 = 2


def _moe_layers(m: dict) -> int:
    return m["n_layers"] - m["first_k_dense"]


def attention_params(m: dict) -> int:
    """One MLA layer's parameters: wq, wkv_a, kv_norm, wkv_b, wo."""
    d, H, r = m["d_model"], m["n_heads"], m["kv_lora_rank"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    return (d * H * (dn + dr) + d * (r + dr) + r + r * H * (dn + dv)
            + H * dv * d)


def dense_params(m: dict) -> int:
    """Parameters a step multiplies outside the routed experts: attention
    and norms in every layer, the leading dense MLPs, router, correction
    bias and shared experts in the MoE layers, the final norm and the LM
    head (not the embedding table, which is looked up)."""
    d, E = m["d_model"], m["n_experts"]
    every = attention_params(m) + 2 * d
    moe = d * E + E + 3 * d * m["shared_d_ff"]
    return (m["n_layers"] * every + m["first_k_dense"] * 3 * d * m["d_ff"]
            + _moe_layers(m) * moe + d + d * m["vocab"])


def expert_params(m: dict) -> int:
    """One routed expert's parameters (SwiGLU of width ``moe_d_ff``)."""
    return 3 * m["d_model"] * m["moe_d_ff"]


def decode_bytes(m: dict, contexts: Sequence[int], touched: float) -> int:
    """Least bytes of one step with live rows at ``contexts`` (tokens
    each row holds, the fed one included) and ``touched`` experts with a
    live pick, summed over the MoE layers."""
    latent = (m["kv_lora_rank"] + m["qk_rope_head_dim"]) * BF16
    total = BF16 * dense_params(m) + BF16 * expert_params(m) * touched
    for ctx in contexts:
        total += m["d_model"] * BF16                        # embedding row
        total += m["n_layers"] * ((ctx - 1) * latent + latent)  # read, write
        total += m["vocab"] * 4                             # f32 logits
    return int(total)


def decode_flops(m: dict, contexts: Sequence[int]) -> int:
    """Model FLOPs of one step: 2 a parameter a live row multiplies (the
    dense ones and ``top_k`` experts an MoE layer), and the absorbed
    attention's two products at each row's real context."""
    active = dense_params(m) + _moe_layers(m) * m["top_k"] * expert_params(m)
    r, dr = m["kv_lora_rank"], m["qk_rope_head_dim"]
    total = 0
    for ctx in contexts:
        total += 2 * active
        total += 2 * m["n_heads"] * ((r + dr) + r) * ctx * m["n_layers"]
    return int(total)
