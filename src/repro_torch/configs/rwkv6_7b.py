"""rwkv6-7b [ssm] — Finch, data-dependent decay, attention-free.

32L d_model=4096 d_ff=14336 vocab=65536. [arXiv:2404.05892; hf]
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65_536,
    attention=AttentionConfig(kind="none", n_heads=64, n_kv_heads=64),
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, token_shift_lora=32,
                    chunk_size=128),
    act="relu",   # rwkv channel-mix uses relu^2; handled in the block
    norm="layernorm",
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, d_ff=128, vocab_size=256,
    attention=AttentionConfig(kind="none", n_heads=4, n_kv_heads=4),
    rwkv=RWKVConfig(head_dim=16, decay_lora=16, token_shift_lora=8,
                    chunk_size=16),
)
