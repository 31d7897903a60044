"""Model API over the ported LM architectures, the counterpart of the
serving half of the reference's ``repro/models/api.py``:

    init(generator, cfg, device=None)       -> params
    params_from_numpy(tree, device=None)    -> params
    forward / prefill / decode_step / init_cache
    make_prefill_step / make_decode_fn

Everything runs under ``torch.inference_mode()``: the flash kernel is
forward-only, as the reference's is, and LM training (the loss, the
train step and its optimizers) is ROADMAP Queue 1, item 16. Mesh
arguments and the dry-run stand-ins are not ported (items 13 and 15b).
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def _inference(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.inference_mode():
            return fn(*args, **kwargs)
    return wrapped


@_inference
def init(generator: torch.Generator, cfg: ModelConfig, *,
         device=None) -> Dict:
    """Random params from ``generator`` (on the card unless ``device``
    says otherwise)."""
    return transformer.init(generator, cfg, device=device)


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: the same
        # 16 bits, reinterpreted
        bits = np.array(a).view(np.uint16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    # np.array copies: the reference's arrays may be read-only views
    return torch.from_numpy(np.array(a)).to(device)


@_inference
def params_from_numpy(tree: Any, device=None) -> Any:
    """The reference's params as a numpy tree
    (``jax.tree.map(np.asarray, repro.models.api.init(key, cfg)[0])``) ->
    the port's tree on ``device`` (the card unless told otherwise), the
    same leaves in the same dtypes, bf16 included."""
    device = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(conv(v) for v in t)
        return _tensor(t, device)
    return conv(tree)


@_inference
def forward(params, cfg: ModelConfig, batch):
    return transformer.forward(params, cfg, batch)


@_inference
def prefill(params, cfg: ModelConfig, batch, max_len: int):
    return transformer.prefill(params, cfg, batch, max_len)


@_inference
def decode_step(params, cfg: ModelConfig, cache, tokens, pos):
    """``pos`` an int or a 0-dim tensor (read on the host)."""
    return transformer.decode_step(params, cfg, cache, tokens, int(pos))


@_inference
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    return transformer.init_cache(cfg, batch, max_len, dtype, device)


def make_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill_step(params, batch):
        return prefill(params, cfg, batch, max_len)
    return prefill_step


def make_decode_fn(cfg: ModelConfig):
    def serve_step(params, cache, batch):
        return decode_step(params, cfg, cache, batch["tokens"], batch["pos"])
    return serve_step
