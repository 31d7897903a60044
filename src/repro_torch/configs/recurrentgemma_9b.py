"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2 recurrent : 1
attention. 38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000.
[arXiv:2402.19427; unverified]
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,   # 38 blocks following the (rec, rec, attn) pattern
    d_model=4096,
    d_ff=12288,
    vocab_size=256_000,
    attention=AttentionConfig(kind="gqa", n_heads=16, n_kv_heads=1,
                              head_dim=256, window=2048),
    rglru=RGLRUConfig(lru_width=4096, conv_width=4,
                      block_pattern=("rec", "rec", "attn")),
    act="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, d_ff=160, vocab_size=256,
    attention=AttentionConfig(kind="gqa", n_heads=4, n_kv_heads=1,
                              head_dim=16, window=16),
    rglru=RGLRUConfig(lru_width=64, conv_width=4),
)
