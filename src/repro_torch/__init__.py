"""PyTorch/CUDA port of the Centaur DLRM reproduction.

A second package beside the JAX reference ``repro``: each module sits at
the same relative path as its JAX counterpart and keeps its public names.
It imports ``torch`` and numpy only, never ``jax`` and nothing of
``repro``. The TPU's Pallas kernels are hand-written CUDA C++ for Hopper
(``kernels/csrc``); on a CPU tensor every kernel wrapper runs its plain
PyTorch version instead (``kernels/ref.py``).

Entry points (``core.dlrm.init``, ``serving.rec_engine.RecEngine``,
``training.online.OnlineTrainer``, ``python -m repro_torch.launch.train``)
run on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

# The reference GEMM is true fp32 (repro/kernels/gemm.py accumulates in
# f32 on the MXU); TF32 would keep ~3 decimal digits, so pin both off.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device() -> torch.device:
    """The card, or a clear error when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path instead")
    return torch.device("cuda")


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` means the card (``default_device``); anything else is taken
    as given."""
    return default_device() if device is None else torch.device(device)
