"""internvl2-2b [vlm] — InternViT + InternLM2 backbone. 24L d_model=2048 16H
(GQA kv=8) d_ff=8192 vocab=92553. [arXiv:2404.16821; hf]

The vision frontend is a stub: a batch carries precomputed patch
embeddings (``batch["patches"]``, (B, n_frontend_tokens, d_model)) that are
prepended to the token sequence.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    d_ff=8192,
    vocab_size=92_553,
    attention=AttentionConfig(kind="gqa", n_heads=16, n_kv_heads=8),
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=False,
    frontend="vision",
    n_frontend_tokens=256,   # 256 patch embeddings per image
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, d_ff=160, vocab_size=256,
    attention=AttentionConfig(kind="gqa", n_heads=4, n_kv_heads=2),
    n_frontend_tokens=8,
)
