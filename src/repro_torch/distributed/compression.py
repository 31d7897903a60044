"""Gradient compression for a data-parallel gradient sync, the reference's
``repro.distributed.compression``, numerics only.

Two mechanisms, composable:

* **bf16 wire sync**: gradients cast to bf16 before the all-reduce (half
  the bytes on the wire);
* **int8 error feedback**: the residual carry of 1-bit-Adam-style
  compression, q_t = Q(g_t + e_t), e_{t+1} = (g_t + e_t) - q_t; the
  int8 tensor and its per-row f32 scale are what an int8 collective would
  move (a quarter of the bytes).

No path of the reference or of the port calls them: the reference's
``grad_compression`` config field is read nowhere else. Trees are dicts,
lists and tuples of tensors (``optim.tree_map``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.optim import tree_leaves, tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise symmetric int8 (one scale a row of the last dim; one for a
    0-d tensor). Returns (q int8, scale f32). Rounds half to even, as
    ``jnp.round``."""
    x32 = x.float()
    if x.dim() == 0:
        scale = torch.clamp(x32.abs(), min=1e-12) / 127.0
        return torch.round(x32 / scale).to(torch.int8), scale
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def init_error_feedback(params):
    """A zero f32 residual for every leaf of ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_grads(grads, error_state):
    """(the gradients as they arrive after the int8 wire, in their own
    dtypes; the new error state)."""
    def one(g, e):
        corrected = g.float() + e
        q, s = quantize_int8(corrected)
        deq = dequantize_int8(q, s)
        return deq.to(g.dtype), corrected - deq

    pairs = tree_map(one, grads, error_state)
    return (tree_map(lambda g, p: p[0], grads, pairs),
            tree_map(lambda g, p: p[1], grads, pairs))


def bf16_cast_grads(grads):
    return tree_map(lambda g: g.to(torch.bfloat16), grads)


def wire_bytes(params, scheme: str) -> int:
    """Bytes one gradient sync moves under each scheme: ``"f32"``,
    ``"bf16"`` or ``"int8"`` (the int8 scales left out, as the
    reference's count)."""
    n = sum(int(p.numel()) for p in tree_leaves(params))
    return {"f32": 4 * n, "bf16": 2 * n, "int8": n}[scheme]
