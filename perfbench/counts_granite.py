"""The least bytes and the model FLOPs of one granite-4.0-h-small decode
step, the yardstick of ``decode_graph_roofline.granite`` and
``serve.mfu.granite`` (bf16 = 2 bytes; peaks in ``counts.py``).

A step must read every weight outside the routed experts once (the tied
embedding once, as the LM head), and of the routed experts only those its
live rows picked: ``touched`` experts a step, from the program's device
counter ``moe.experts_touched`` over the traced steps.  Each live row
reads and writes its Mamba2 state and conv window in every Mamba2 layer,
reads its cached K and V at its real context and writes its new K and V
in every attention layer, and writes f32 logits.
"""
from __future__ import annotations

from typing import Sequence

BF16 = 2


def _kinds(m: dict):
    n_attn = sum(t == "attention" for t in m["layer_types"])
    return n_attn, len(m["layer_types"]) - n_attn


def _ssm_dims(m: dict):
    di = m["ssm_expand"] * m["d_model"]
    heads = di // m["ssm_head_dim"]
    conv_dim = di + 2 * m["ssm_groups"] * m["ssm_state"]
    return di, heads, conv_dim


def dense_params(m: dict) -> int:
    """Parameters outside the routed experts: both mixers' weights in
    their layers, norms, router and shared expert in every layer, the
    final norm and the tied embedding."""
    d, dh = m["d_model"], m["d_head"]
    n_attn, n_mamba = _kinds(m)
    di, heads, conv_dim = _ssm_dims(m)
    attn = 2 * d * m["n_heads"] * dh + 2 * d * m["n_kv_heads"] * dh
    mamba = (d * (di + conv_dim + heads) + m["ssm_conv"] * conv_dim
             + conv_dim + 3 * heads + di + di * d)
    every = 2 * d + d * m["n_experts"] \
        + 3 * d * m["shared_d_ff"] * m["n_shared_experts"]
    return (n_attn * attn + n_mamba * mamba
            + len(m["layer_types"]) * every + d + m["vocab"] * d)


def expert_params(m: dict) -> int:
    """One routed expert's parameters (SwiGLU of width ``moe_d_ff``)."""
    return 3 * m["d_model"] * m["moe_d_ff"]


def decode_bytes(m: dict, contexts: Sequence[int], touched: float) -> int:
    """Least bytes of one step with live rows at ``contexts`` (tokens
    each row holds, the fed one included) and ``touched`` experts with a
    live pick, summed over the MoE layers."""
    n_attn, n_mamba = _kinds(m)
    di, heads, conv_dim = _ssm_dims(m)
    kv = m["n_kv_heads"] * m["d_head"] * 2 * BF16           # K and V
    state = (heads * m["ssm_head_dim"] * m["ssm_state"]
             + (m["ssm_conv"] - 1) * conv_dim) * BF16
    total = BF16 * dense_params(m) + BF16 * expert_params(m) * touched
    for ctx in contexts:
        total += n_attn * ((ctx - 1) * kv + kv)             # read, write
        total += n_mamba * 2 * state                        # read, write
        total += m["vocab"] * 4                             # f32 logits
    return int(total)


def decode_flops(m: dict, contexts: Sequence[int]) -> int:
    """Model FLOPs of one step: 2 a parameter a live row multiplies (the
    dense ones and ``top_k`` experts a layer), attention's two products at
    each row's real context, and the Mamba2 state update and read-out."""
    n_attn, n_mamba = _kinds(m)
    di = m["ssm_expand"] * m["d_model"]
    active = dense_params(m) \
        + len(m["layer_types"]) * m["top_k"] * expert_params(m)
    total = 0
    for ctx in contexts:
        total += 2 * active
        total += 4 * m["n_heads"] * m["d_head"] * ctx * n_attn
        total += 6 * di * m["ssm_state"] * n_mamba
    return int(total)
