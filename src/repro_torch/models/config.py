"""Unified model configuration covering the assigned architectures.

One dataclass drives dense GQA transformers, MoE, encoder-only audio, VLM
backbones with M-RoPE, pure SSM (Mamba2/SSD), hybrid attn+SSM in every
layer (Hymba) and hybrids whose layers each hold one mixer, attention or
Mamba2, as ``layer_types`` lists them (Granite 4.0-H).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | audio | vlm | ssm | hybrid
    n_layers: int
    d_model: int
    vocab: int
    # --- attention ---------------------------------------------------------
    n_heads: int = 0               # query heads; 0 => attention-free layer
    n_kv_heads: int = 0
    d_head: int = 64
    attn: str = "full"             # full | swa | none
    swa_window: int = 1024
    global_attn_layers: Tuple[int, ...] = ()   # full-attn layers when attn=swa
    causal: bool = True            # False => encoder-only (no decode path)
    pos: str = "rope"              # rope | mrope | none
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w freq split
    qk_norm: bool = False
    # --- MLP -----------------------------------------------------------------
    d_ff: int = 0                  # dense MLP width (0 => no dense MLP)
    act: str = "swiglu"            # swiglu | relu2
    # --- MoE -----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    router_aux_coef: float = 0.01
    moe_dispatch: str = "capacity"   # capacity (EP, ~active FLOPs) | dense
    moe_capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---------------------------------------------------
    ssm: bool = False              # present in every layer (pure or hybrid)
    ssm_state: int = 0             # N
    ssm_expand: int = 2
    ssm_head_dim: int = 64         # P
    ssm_groups: int = 1            # G (B/C groups)
    ssm_conv: int = 4
    ssm_chunk: int = 64
    # --- per-layer mixer ------------------------------------------------------
    # "attention" or "mamba" for each layer (one mixer a layer); empty: every
    # layer holds every mixer the config has, as before.
    layer_types: Tuple[str, ...] = ()
    # --- embedding / frontend ---------------------------------------------------
    frontend: str = "token"        # token | audio | vision
    frontend_dim: int = 0          # stub embedding dim (0 => d_model)
    tie_embeddings: bool = False
    # --- numerics -----------------------------------------------------------------
    norm_eps: float = 1e-5
    # Granite's scalars; at their defaults nothing is multiplied.
    embedding_multiplier: float = 1.0   # the embedding's output
    residual_multiplier: float = 1.0    # each block output before its add
    attention_multiplier: float = 0.0   # softmax scale; 0 => 1/sqrt(d_head)
    logits_scaling: float = 1.0         # logits divided by it
    dtype: str = "bfloat16"
    remat: bool = True             # activation checkpointing per layer
    scan_unroll: bool = False      # unroll layer scans (cost-probe lowering)

    def __post_init__(self) -> None:
        if self.layer_types and (
                len(self.layer_types) != self.n_layers
                or not set(self.layer_types) <= {"attention", "mamba"}):
            raise ValueError(f"layer_types must give 'attention' or 'mamba' "
                             f"for each of the {self.n_layers} layers")

    # ---- derived -------------------------------------------------------------
    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def ssm_conv_dim(self) -> int:
        return self.ssm_d_inner + 2 * self.ssm_groups * self.ssm_state

    @property
    def has_attn(self) -> bool:
        return self.n_heads > 0 and self.attn != "none"

    @property
    def has_dense_mlp(self) -> bool:
        return self.d_ff > 0

    @property
    def has_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: SSM / hybrid with windowed attention."""
        if self.ssm and not self.has_attn:
            return True
        return self.ssm and self.attn == "swa"

    @property
    def can_decode(self) -> bool:
        return self.causal

    def layer_is_global(self, i: int) -> bool:
        return self.attn == "full" or i in self.global_attn_layers

    def n_params(self) -> int:
        """Analytic parameter count (for 6·N·D roofline math).  Leaves out
        the final norm and the SSM's conv bias, as the reference does."""
        d, dh = self.d_model, self.d_head
        n = self.vocab * d                                   # embed
        if not self.tie_embeddings:
            n += d * self.vocab                              # lm head
        attn = ssm = 0
        if self.has_attn:
            attn += d * self.n_heads * dh                    # wq
            attn += 2 * d * self.n_kv_heads * dh             # wk, wv
            attn += self.n_heads * dh * d                    # wo
        per_layer = 0
        if self.has_dense_mlp:
            mults = 3 if self.act == "swiglu" else 2
            per_layer += mults * d * self.d_ff
        if self.has_moe:
            per_layer += d * self.n_experts                  # router
            per_layer += self.n_experts * 3 * d * self.moe_d_ff
            if self.n_shared_experts:
                per_layer += 3 * d * self.shared_d_ff
        if self.ssm:
            di, g, N, h = (self.ssm_d_inner, self.ssm_groups,
                           self.ssm_state, self.ssm_heads)
            ssm += d * (2 * di + 2 * g * N + h)              # in_proj
            ssm += self.ssm_conv_dim * self.ssm_conv         # conv
            ssm += 3 * h + di                                # A, D, dt_bias, norm
            ssm += di * d                                    # out_proj
        per_layer += 2 * d                                   # norms
        for i in range(self.n_layers):
            n += per_layer + (attn if layer_has_attn(self, i) else 0) \
                + (ssm if layer_has_ssm(self, i) else 0)
        return n

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.has_moe:
            return self.n_params()
        d = self.d_model
        full = self.n_params()
        inactive = self.n_layers * (self.n_experts - self.top_k) * 3 * d * self.moe_d_ff
        return full - inactive


def layer_has_attn(cfg, i: int) -> bool:
    """Layer ``i`` holds attention (every layer, unless ``layer_types``
    gives it another mixer)."""
    return cfg.has_attn and (not cfg.layer_types
                             or cfg.layer_types[i] == "attention")


def layer_has_ssm(cfg, i: int) -> bool:
    """Layer ``i`` holds the Mamba2 mixer."""
    return cfg.ssm and (not cfg.layer_types
                        or cfg.layer_types[i] == "mamba")


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test-sized variant of the same family (layers/width shrunk)."""
    base = dict(
        n_layers=2,
        d_model=64,
        vocab=256,
        d_head=16,
        dtype="float32",
        remat=False,
    )
    if cfg.n_heads:
        base["n_heads"] = 4
        base["n_kv_heads"] = max(1, min(cfg.n_kv_heads, 2))
    if cfg.d_ff:
        base["d_ff"] = 128
    if cfg.n_experts:
        base.update(n_experts=8, top_k=min(cfg.top_k, 2), moe_d_ff=32,
                    moe_dispatch="dense")
        if cfg.n_shared_experts:
            base.update(n_shared_experts=1, shared_d_ff=64)
    if cfg.ssm:
        base.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.attn == "swa":
        base.update(swa_window=8, global_attn_layers=(0,))
    if cfg.layer_types:     # one layer of each mixer kind, and two more
        base.update(n_layers=4,
                    layer_types=("mamba", "attention", "mamba", "mamba"))
    if cfg.frontend != "token":
        base["frontend_dim"] = 32
    if cfg.pos == "mrope":
        base["mrope_sections"] = (2, 3, 3)   # d_head 16 -> 8 freq slots
    base["name"] = cfg.name + "-smoke"
    return replace(cfg, **{**base, **overrides})
