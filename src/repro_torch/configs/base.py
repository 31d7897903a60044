"""Config schema: the DLRM family (paper Table I) and the LM zoo.

Frozen dataclasses, field for field the reference's
(``repro/configs/base.py``), so a config built in either package
describes the same model and the two compare equal field by field.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (MiniCPM3 / DeepSeek-V2 style)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class AttentionConfig:
    kind: str = "gqa"            # 'gqa' | 'mla' | 'none'
    n_heads: int = 16
    n_kv_heads: int = 16
    head_dim: Optional[int] = None   # default d_model // n_heads
    qkv_bias: bool = False           # qwen-style
    window: Optional[int] = None     # sliding-window attention size
    rope_theta: float = 10_000.0
    mla: Optional[MLAConfig] = None
    causal: bool = True

    def resolved_head_dim(self, d_model: int) -> int:
        return (self.head_dim if self.head_dim is not None
                else d_model // self.n_heads)


# ---------------------------------------------------------------------------
# MoE and recurrent blocks (RG-LRU / RWKV)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    expert_ff: int = 1024
    capacity_factor: float = 1.25
    # Arctic-style: a dense FFN residual branch computed beside the MoE
    dense_residual_ff: Optional[int] = None
    aux_loss_coef: float = 0.01
    router_dtype: str = "float32"


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma / Griffin recurrent block."""
    lru_width: Optional[int] = None   # default d_model
    conv_width: int = 4
    block_pattern: Tuple[str, ...] = ("rec", "rec", "attn")  # Griffin 2:1


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64
    token_shift_lora: int = 32
    chunk_size: int = 128


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "decoder"      # decoder | encdec | hybrid | ssm | vlm | audio
    n_layers: int = 12
    d_model: int = 1024
    d_ff: int = 4096
    vocab_size: int = 32_000
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    moe: Optional[MoEConfig] = None
    rglru: Optional[RGLRUConfig] = None
    rwkv: Optional[RWKVConfig] = None
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    act: str = "swiglu"          # swiglu | geglu | gelu | relu
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    # frontends are stubs providing embeddings
    frontend: Optional[str] = None   # None | 'vision' | 'audio'
    n_frontend_tokens: int = 0       # patches / frames prepended to the seq
    # encoder-decoder split (seamless): n_layers counts each stack
    enc_layers: int = 0
    dec_layers: int = 0
    # cross-attention encoder memory length used by decode shapes
    enc_memory_len: int = 3200
    # first k layers use a dense FFN even in MoE models
    first_dense_layers: int = 0

    @property
    def is_encdec(self) -> bool:
        return self.family == "encdec"

    @property
    def attention_free(self) -> bool:
        return self.attention.kind == "none"

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode at 500k context with bounded state?"""
        if self.attention_free or self.rwkv is not None:
            return True
        if self.rglru is not None:
            return True  # the local attention window bounds the cache
        return self.attention.window is not None

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Shapes (the assigned input-shape set)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # 'train' | 'prefill' | 'decode'


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

LM_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in LM_SHAPES}


def shape_applicable(model: ModelConfig,
                     shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell runs, with the reason."""
    if shape.name == "long_500k" and not model.subquadratic:
        return False, ("skipped: pure full-attention arch (quadratic at "
                       "524k ctx)")
    return True, "ok"


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"          # sgd | adamw | adafactor
    lr: float = 3e-4
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    # row-wise adagrad for DLRM embedding tables (paper-standard)
    embedding_opt: str = "rowwise_adagrad"


# ---------------------------------------------------------------------------
# DLRM (the paper's own model family, Table I)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm"
    n_tables: int = 5
    rows_per_table: int = 200_000
    emb_dim: int = 32                 # paper default: 32-dim embeddings
    lookups_per_table: int = 20       # gathers per table ("M" in Fig. 2)
    dense_features: int = 13          # criteo-style continuous features
    bottom_mlp: Tuple[int, ...] = (512, 256, 32)
    top_mlp: Tuple[int, ...] = (512, 256, 1)
    dtype: str = "float32"
    # Heterogeneous tables: each table t owns a private
    # (table_rows[t] + 1, table_dims[t]) arena and draws its ids from
    # Zipf(table_alphas[t]). All three tuples have n_tables entries.
    table_rows: Optional[Tuple[int, ...]] = None
    table_dims: Optional[Tuple[int, ...]] = None
    table_alphas: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        for f in ("table_rows", "table_dims", "table_alphas"):
            v = getattr(self, f)
            if v is not None and len(v) != self.n_tables:
                raise ValueError(f"{f} has {len(v)} entries for "
                                 f"{self.n_tables} tables")
        if (self.table_rows is None) != (self.table_dims is None):
            raise ValueError("heterogeneous configs set table_rows AND "
                             "table_dims together")

    @property
    def heterogeneous(self) -> bool:
        return self.table_rows is not None

    @property
    def resolved_table_rows(self) -> Tuple[int, ...]:
        return (self.table_rows if self.table_rows is not None
                else (self.rows_per_table,) * self.n_tables)

    @property
    def resolved_table_dims(self) -> Tuple[int, ...]:
        return (self.table_dims if self.table_dims is not None
                else (self.emb_dim,) * self.n_tables)

    @property
    def table_bytes(self) -> int:
        if self.heterogeneous:
            return 4 * sum(r * d for r, d in zip(self.table_rows,
                                                 self.table_dims))
        return self.n_tables * self.rows_per_table * self.emb_dim * 4

    @property
    def n_interact_features(self) -> int:
        # reduced embedding per table + bottom-mlp output vector
        return self.n_tables + 1
