"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table config).

61L d_model=7168 64H (GQA kv=8) d_ff=2048(expert) vocab=163840, MoE 384e
top-8. [arXiv:2501.kimi2; unverified]
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="decoder",
    n_layers=61,
    d_model=7168,
    d_ff=2048,               # expert FFN width
    vocab_size=163_840,
    attention=AttentionConfig(kind="gqa", n_heads=64, n_kv_heads=8),
    moe=MoEConfig(n_experts=384, top_k=8, expert_ff=2048,
                  capacity_factor=1.25),
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, d_ff=64, vocab_size=256,
    attention=AttentionConfig(kind="gqa", n_heads=4, n_kv_heads=2),
    moe=MoEConfig(n_experts=8, top_k=2, expert_ff=64, capacity_factor=2.0),
)
