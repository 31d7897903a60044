"""minicpm3-4b [dense] — multi-head latent attention (MLA).

62L d_model=2560 40H d_ff=6400 vocab=73448. [hf:openbmb/MiniCPM3-4B; hf]
"""
from repro_torch.configs.base import AttentionConfig, MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="decoder",
    n_layers=62,
    d_model=2560,
    d_ff=6400,
    vocab_size=73_448,
    attention=AttentionConfig(
        kind="mla", n_heads=40, n_kv_heads=40,
        mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                      qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    ),
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, d_ff=160, vocab_size=256,
    attention=AttentionConfig(
        kind="mla", n_heads=4, n_kv_heads=4,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8),
    ),
)
