"""arctic-480b [moe] — 128 experts top-2 + dense residual branch.

35L d_model=7168 56H (GQA kv=8) d_ff=4864(expert) vocab=32000.
[hf:Snowflake/snowflake-arctic-base; hf]
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="decoder",
    n_layers=35,
    d_model=7168,
    d_ff=4864,
    vocab_size=32_000,
    attention=AttentionConfig(kind="gqa", n_heads=56, n_kv_heads=8),
    moe=MoEConfig(n_experts=128, top_k=2, expert_ff=4864,
                  capacity_factor=1.25,
                  dense_residual_ff=4864),   # arctic dense-MoE hybrid residual
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, d_ff=64, vocab_size=256,
    attention=AttentionConfig(kind="gqa", n_heads=4, n_kv_heads=2),
    moe=MoEConfig(n_experts=8, top_k=2, expert_ff=64, capacity_factor=2.0,
                  dense_residual_ff=64),
)
