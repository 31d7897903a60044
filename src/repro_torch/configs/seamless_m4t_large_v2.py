"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal backbone.

24L(+24L dec) d_model=1024 16H (kv=16) d_ff=8192 vocab=256206.
[arXiv:2308.11596; hf]

The audio frontend is a stub: a batch carries precomputed frame embeddings
(``batch["frames"]``, (B, enc_memory_len, d_model)) as the encoder input.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=48,
    enc_layers=24,
    dec_layers=24,
    d_model=1024,
    d_ff=8192,
    vocab_size=256_206,
    attention=AttentionConfig(kind="gqa", n_heads=16, n_kv_heads=16),
    act="gelu",
    norm="layernorm",
    tie_embeddings=True,
    frontend="audio",
    n_frontend_tokens=3200,   # encoder memory length for decode shapes
    enc_memory_len=3200,
)

SMOKE = CONFIG.replace(
    n_layers=4, enc_layers=2, dec_layers=2, d_model=64, d_ff=128,
    vocab_size=256,
    attention=AttentionConfig(kind="gqa", n_heads=4, n_kv_heads=4),
    n_frontend_tokens=16, enc_memory_len=16,
)
