"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window attention.

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000. [arXiv:2401.16818; hf]
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="decoder",
    n_layers=24,
    d_model=2560,
    d_ff=6912,
    vocab_size=32_000,
    attention=AttentionConfig(
        kind="gqa", n_heads=32, n_kv_heads=8, window=4096, rope_theta=10_000.0
    ),
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, d_ff=160, vocab_size=256,
    attention=AttentionConfig(kind="gqa", n_heads=4, n_kv_heads=2, window=16),
)
