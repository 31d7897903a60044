"""Registry mapping ``--arch <id>`` to the LM configs (full and smoke).

The port has the three dense GQA decoders; the reference's other seven
architectures are known by name and refused until their models are
ported (ROADMAP Queue 1, item 15b).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import h2o_danube_1_8b, qwen1_5_4b, smollm_360m
from repro_torch.configs.base import ModelConfig

_MODULES = {
    "h2o-danube-1.8b": h2o_danube_1_8b,
    "qwen1.5-4b": qwen1_5_4b,
    "smollm-360m": smollm_360m,
}

# the reference's architectures whose models the port does not have yet
NOT_PORTED = ("minicpm3-4b", "internvl2-2b", "recurrentgemma-9b",
              "kimi-k2-1t-a32b", "arctic-480b", "seamless-m4t-large-v2",
              "rwkv6-7b")

ARCHS: Dict[str, ModelConfig] = {k: m.CONFIG for k, m in _MODULES.items()}
SMOKE_ARCHS: Dict[str, ModelConfig] = {k: m.SMOKE
                                       for k, m in _MODULES.items()}
ARCH_IDS = tuple(ARCHS)


def _lookup(table: Dict[str, ModelConfig], arch_id: str) -> ModelConfig:
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id!r} is not ported yet (ROADMAP Queue 1, item 15b); "
            f"the port has {sorted(ARCHS)}")
    if arch_id not in table:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return table[arch_id]


def get_arch(arch_id: str) -> ModelConfig:
    return _lookup(ARCHS, arch_id)


def get_smoke(arch_id: str) -> ModelConfig:
    return _lookup(SMOKE_ARCHS, arch_id)
