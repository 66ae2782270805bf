"""The assigned architectures, exactly as specified (source tags inline):
the reference's 10, and granite-4.0-h-small and kanana-2-30b-a3b, which
the port alone runs.

Every config is selectable via --arch <id> in the launchers; reduced smoke
variants come from repro_torch.models.config.reduced().
"""
from __future__ import annotations

from typing import Dict

from ..models.config import ModelConfig

# --- dense ---------------------------------------------------------------
SMOLLM_360M = ModelConfig(
    # [hf:HuggingFaceTB/SmolLM-135M; hf] — llama-arch small
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, d_head=64,
    d_ff=2560, vocab=49_152, act="swiglu", attn="full", pos="rope",
)

LLAMA32_1B = ModelConfig(
    # [hf:meta-llama/Llama-3.2-1B; unverified] — small llama3
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, d_head=64,
    d_ff=8192, vocab=128_256, act="swiglu", attn="full", pos="rope",
    rope_theta=500_000.0, tie_embeddings=True,
)

DEEPSEEK_CODER_33B = ModelConfig(
    # [arXiv:2401.14196; hf] — llama-arch
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=19_200, vocab=32_256, act="swiglu", attn="full", pos="rope",
)

NEMOTRON_4_340B = ModelConfig(
    # [arXiv:2402.16819; unverified] — GQA, squared-ReLU
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18_432, n_heads=96, n_kv_heads=8, d_head=192,
    d_ff=73_728, vocab=256_000, act="relu2", attn="full", pos="rope",
)

# --- MoE ------------------------------------------------------------------
QWEN3_MOE_30B = ModelConfig(
    # [hf:Qwen/Qwen3-30B-A3B; hf] — 128 experts top-8
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_head=128,
    d_ff=0, vocab=151_936, act="swiglu", attn="full", pos="rope",
    n_experts=128, top_k=8, moe_d_ff=768, qk_norm=True,
)

QWEN2_MOE_A27B = ModelConfig(
    # [hf:Qwen/Qwen1.5-MoE-A2.7B; hf] — 4 shared + 60 routed top-4
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=0, vocab=151_936, act="swiglu", attn="full", pos="rope",
    n_experts=60, top_k=4, moe_d_ff=1408,
    n_shared_experts=4, shared_d_ff=5632,
)

# --- audio (encoder-only; frontend = stub frame embeddings) -----------------
HUBERT_XLARGE = ModelConfig(
    # [arXiv:2106.07447; unverified] — encoder-only, w2v2 arch
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, d_head=80,
    d_ff=5120, vocab=504, act="swiglu", attn="full", causal=False,
    pos="none", frontend="audio", frontend_dim=512,
)

# --- VLM backbone (frontend = stub patch embeddings; M-RoPE) -----------------
QWEN2_VL_2B = ModelConfig(
    # [arXiv:2409.12191; hf] — M-RoPE, dynamic resolution
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_head=128,
    d_ff=8960, vocab=151_936, act="swiglu", attn="full", pos="mrope",
    mrope_sections=(16, 24, 24), frontend="vision", frontend_dim=1536,
)

# --- SSM ----------------------------------------------------------------------
MAMBA2_130M = ModelConfig(
    # [arXiv:2405.21060; unverified] — SSD (state-space duality)
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50_280, attn="none", pos="none",
    ssm=True, ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
)

# --- hybrid ----------------------------------------------------------------------
HYMBA_1_5B = ModelConfig(
    # [arXiv:2411.13676; hf] — parallel attn+mamba heads; SWA + 3 global layers
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_head=64,
    d_ff=5504, vocab=32_001, act="swiglu",
    attn="swa", swa_window=1024, global_attn_layers=(0, 15, 31), pos="rope",
    ssm=True, ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_chunk=64,
)

GRANITE_4_0_H_SMALL = ModelConfig(
    # [hf:ibm-granite/granite-4.0-h-small config.json] — one mixer a layer:
    # Mamba2 except NoPE GQA attention at 5, 15, 25, 35; 72 experts top-10
    # (width intermediate_size) and a shared expert in every layer
    name="granite-4.0-h-small", family="hybrid",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=0, vocab=100_352, act="swiglu", attn="full", pos="none",
    ssm=True, ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
    ssm_conv=4, ssm_chunk=256,
    n_experts=72, top_k=10, moe_d_ff=768,
    n_shared_experts=1, shared_d_ff=1536,
    layer_types=tuple("attention" if i in (5, 15, 25, 35) else "mamba"
                      for i in range(40)),
    tie_embeddings=True, norm_eps=1e-5,
    embedding_multiplier=12.0, residual_multiplier=0.22,
    attention_multiplier=0.0078125, logits_scaling=16.0,
)

KANANA_2_30B_A3B = ModelConfig(
    # [hf:kakaocorp/kanana-2-30b-a3b-instruct-2601 config.json,
    # model_type deepseek_v3] — the DeepSeek-V3 block without q-LoRA:
    # MLA (latent 512, rope part 64 interleaved, nope 128, value 128),
    # layer 0 dense (intermediate_size 6144), then 128 experts of 768
    # top-6 by the sigmoid noaux_tc router (one group, normalised, x
    # 2.448) and two shared experts as one MLP of 1536
    name="kanana-2-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_head=192,
    attn="mla", pos="rope", rope_theta=1_000_000.0,
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128,
    d_ff=6144, act="swiglu", first_k_dense=1,
    n_experts=128, top_k=6, moe_d_ff=768,
    n_shared_experts=2, shared_d_ff=1536,
    router_score="sigmoid", routed_scaling=2.448,
    vocab=128_256, tie_embeddings=False, norm_eps=1e-6,
)

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in [
        SMOLLM_360M, LLAMA32_1B, DEEPSEEK_CODER_33B, NEMOTRON_4_340B,
        QWEN3_MOE_30B, QWEN2_MOE_A27B, HUBERT_XLARGE, QWEN2_VL_2B,
        MAMBA2_130M, HYMBA_1_5B, GRANITE_4_0_H_SMALL, KANANA_2_30B_A3B,
    ]
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(ARCHS)}")
    return ARCHS[name]
