"""Unified model configuration covering the assigned architectures.

One dataclass drives dense GQA transformers, MoE, encoder-only audio, VLM
backbones with M-RoPE, pure SSM (Mamba2/SSD), hybrid attn+SSM in every
layer (Hymba), hybrids whose layers each hold one mixer, attention or
Mamba2, as ``layer_types`` lists them (Granite 4.0-H), and the DeepSeek-V3
block: multi-head latent attention (``attn="mla"``), leading dense layers
(``first_k_dense``) and a sigmoid router with a correction bias
(kanana-2-30b-a3b).
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
    attn: str = "full"             # full | swa | mla | none
    swa_window: int = 1024
    global_attn_layers: Tuple[int, ...] = ()   # full-attn layers when attn=swa
    causal: bool = True            # False => encoder-only (no decode path)
    pos: str = "rope"              # rope | mrope | none
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w freq split
    qk_norm: bool = False
    # --- multi-head latent attention (attn="mla", DeepSeek-V2/V3) ----------
    # Each token caches one latent row: kv_lora_rank normalised values and
    # qk_rope_head_dim rotated ones, shared by every head.  A head's query
    # and key are qk_nope_head_dim + qk_rope_head_dim wide (d_head is their
    # sum), its value v_head_dim.  The query is one projection (no
    # q-LoRA), and the rope part rotates pairs (2i, 2i+1), not halves.
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
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
    first_k_dense: int = 0         # leading layers with the dense MLP
    # The router: "softmax" over the logits, top-k of the probabilities;
    # or "sigmoid" (DeepSeek-V3's noaux_tc): top-k of the sigmoids plus a
    # per-expert correction bias, weighted by the unbiased sigmoids.  The
    # picks' weights are renormalised to sum to 1, then multiplied by
    # routed_scaling.
    router_score: str = "softmax"
    routed_scaling: float = 1.0
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
        if self.router_score not in ("softmax", "sigmoid"):
            raise ValueError(f"router_score {self.router_score!r}: "
                             f"'softmax' or 'sigmoid'")
        if self.attn == "mla":
            if (self.d_head != self.qk_nope_head_dim + self.qk_rope_head_dim
                    or self.n_kv_heads != self.n_heads or self.pos != "rope"
                    or min(self.kv_lora_rank, self.qk_rope_head_dim,
                           self.v_head_dim) <= 0):
                raise ValueError(
                    "multi-head latent attention needs kv_lora_rank, "
                    "qk_rope_head_dim and v_head_dim > 0, d_head = "
                    "qk_nope_head_dim + qk_rope_head_dim, n_kv_heads = "
                    "n_heads and pos 'rope'")

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
        return self.attn in ("full", "mla") or i in self.global_attn_layers

    @property
    def latent_width(self) -> int:
        """Values an MLA layer caches a token: the normalised latent and
        the rotated key part."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    def n_params(self) -> int:
        """Analytic parameter count (for 6·N·D roofline math).  Leaves out
        the final norm and the SSM's conv bias, as the reference does."""
        d, dh = self.d_model, self.d_head
        n = self.vocab * d                                   # embed
        if not self.tie_embeddings:
            n += d * self.vocab                              # lm head
        attn = ssm = mlp = moe = 0
        if self.attn == "mla":
            h, r = self.n_heads, self.kv_lora_rank
            attn += d * h * dh                               # wq
            attn += d * self.latent_width + r                # wkv_a, kv_norm
            attn += r * h * (self.qk_nope_head_dim + self.v_head_dim)
            attn += h * self.v_head_dim * d                  # wo
        elif self.has_attn:
            attn += d * self.n_heads * dh                    # wq
            attn += 2 * d * self.n_kv_heads * dh             # wk, wv
            attn += self.n_heads * dh * d                    # wo
        if self.has_dense_mlp:
            mults = 3 if self.act == "swiglu" else 2
            mlp = mults * d * self.d_ff
        if self.has_moe:
            moe += d * self.n_experts                        # router
            if self.router_score == "sigmoid":
                moe += self.n_experts                        # its bias
            moe += self.n_experts * 3 * d * self.moe_d_ff
            if self.n_shared_experts:
                moe += 3 * d * self.shared_d_ff
        if self.ssm:
            di, g, N, h = (self.ssm_d_inner, self.ssm_groups,
                           self.ssm_state, self.ssm_heads)
            ssm += d * (2 * di + 2 * g * N + h)              # in_proj
            ssm += self.ssm_conv_dim * self.ssm_conv         # conv
            ssm += 3 * h + di                                # A, D, dt_bias, norm
            ssm += di * d                                    # out_proj
        for i in range(self.n_layers):
            n += 2 * d                                       # norms
            n += (attn if layer_has_attn(self, i) else 0) \
                + (ssm if layer_has_ssm(self, i) else 0)
            if layer_has_moe(self, i):
                n += moe
            elif self.has_dense_mlp:
                n += mlp
        return n

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.has_moe:
            return self.n_params()
        d = self.d_model
        full = self.n_params()
        n_moe = sum(layer_has_moe(self, i) for i in range(self.n_layers))
        inactive = n_moe * (self.n_experts - self.top_k) * 3 * d * self.moe_d_ff
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


def layer_has_moe(cfg, i: int) -> bool:
    """Layer ``i`` holds the MoE (every layer past the ``first_k_dense``
    leading ones, which hold the dense MLP)."""
    return cfg.has_moe and i >= cfg.first_k_dense


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
    if cfg.attn == "mla":    # every latent width kept distinct
        base.update(n_kv_heads=4, d_head=24, kv_lora_rank=32,
                    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=12)
    if cfg.first_k_dense:    # one dense layer, then two MoE
        base.update(n_layers=3, first_k_dense=1)
    if cfg.frontend != "token":
        base["frontend_dim"] = 32
    if cfg.pos == "mrope":
        base["mrope_sections"] = (2, 3, 3)   # d_head 16 -> 8 freq slots
    base["name"] = cfg.name + "-smoke"
    return replace(cfg, **{**base, **overrides})
