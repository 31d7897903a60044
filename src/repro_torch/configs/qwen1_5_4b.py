"""qwen1.5-4b [dense] — QKV bias. 40L d_model=2560 20H (GQA kv=20) d_ff=6912
vocab=151936. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="decoder",
    n_layers=40,
    d_model=2560,
    d_ff=6912,
    vocab_size=151_936,
    attention=AttentionConfig(
        kind="gqa", n_heads=20, n_kv_heads=20, qkv_bias=True, rope_theta=1_000_000.0
    ),
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, d_ff=160, vocab_size=256,
    attention=AttentionConfig(kind="gqa", n_heads=4, n_kv_heads=4, qkv_bias=True),
)
