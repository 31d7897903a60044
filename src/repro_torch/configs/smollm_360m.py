"""smollm-360m [dense] — llama-arch small. 32L d_model=960 15H (GQA kv=5)
d_ff=2560 vocab=49152. [hf:HuggingFaceTB/SmolLM-135M; hf]"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="decoder",
    n_layers=32,
    d_model=960,
    d_ff=2560,
    vocab_size=49_152,
    attention=AttentionConfig(kind="gqa", n_heads=15, n_kv_heads=5),
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=60, d_ff=160, vocab_size=256,
    attention=AttentionConfig(kind="gqa", n_heads=3, n_kv_heads=1),
)
