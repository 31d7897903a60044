"""Registry mapping ``--arch <id>`` to the LM configs (full and smoke):
the reference's ten architectures, every one of them ported: the dense
GQA decoders, the MoE decoders (kimi-k2-1t-a32b, arctic-480b), MLA
(minicpm3-4b), the vision-prefix decoder (internvl2-2b), the RG-LRU
hybrid (recurrentgemma-9b), RWKV-6 (rwkv6-7b) and the encoder-decoder
(seamless-m4t-large-v2).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (arctic_480b, h2o_danube_1_8b, internvl2_2b,
                                 kimi_k2_1t_a32b, minicpm3_4b, qwen1_5_4b,
                                 recurrentgemma_9b, rwkv6_7b,
                                 seamless_m4t_large_v2, smollm_360m)
from repro_torch.configs.base import ModelConfig

_MODULES = {
    "h2o-danube-1.8b": h2o_danube_1_8b,
    "qwen1.5-4b": qwen1_5_4b,
    "minicpm3-4b": minicpm3_4b,
    "smollm-360m": smollm_360m,
    "internvl2-2b": internvl2_2b,
    "recurrentgemma-9b": recurrentgemma_9b,
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b,
    "arctic-480b": arctic_480b,
    "seamless-m4t-large-v2": seamless_m4t_large_v2,
    "rwkv6-7b": rwkv6_7b,
}

ARCHS: Dict[str, ModelConfig] = {k: m.CONFIG for k, m in _MODULES.items()}
SMOKE_ARCHS: Dict[str, ModelConfig] = {k: m.SMOKE
                                       for k, m in _MODULES.items()}
ARCH_IDS = tuple(ARCHS)


def _lookup(table: Dict[str, ModelConfig], arch_id: str) -> ModelConfig:
    if arch_id not in table:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return table[arch_id]


def get_arch(arch_id: str) -> ModelConfig:
    return _lookup(ARCHS, arch_id)


def get_smoke(arch_id: str) -> ModelConfig:
    return _lookup(SMOKE_ARCHS, arch_id)
