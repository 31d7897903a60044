"""Causal / windowed flash attention on Hopper: the ``flash_attention``
kernel (forward only).

Replaces the Pallas kernel ``repro/kernels/flash_attention.py:77
flash_attention`` (body ``_flash_kernel``, :31) and its GQA wrapper
``flash_attention_gqa`` (:113): online-softmax attention whose running
max, sum and output accumulator never leave the chip, so device memory
sees only q, k, v and the output, never the (S, S) scores.

What bounds it on the card: operations. Causal attention at the LM's
prefill lengths (S = 2048..4096) does a few hundred flops per byte of
q, k, v and out, above the bf16 tensor cores' balance point. The CUDA
kernel (``csrc/flash_attention.cu``) runs both products on the tensor
cores with ``mma.sync`` (bf16 operands, fp32 accumulation); one block
owns a 64-row q tile of one head and loops over 64-key kv tiles staged
in shared memory, skipping tiles wholly outside the causal and window
band. Each query head reads its kv head directly, so GQA repeats
nothing. It keeps the reference's numerics: fp32 scores times d**-0.5,
-1e30 for masked entries, P rounded to bf16 before the PV product while
the row sum adds the fp32 P, and acc / max(l, 1e-30).

This wrapper takes CUDA tensors only; ``kernels.ops`` routes CPU tensors
to the plain version in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

# launches of the CUDA kernel in this process (not of the plain version)
launches = 0

# head dims the kernel is instantiated for: the smoke configs' 16 and 20,
# smollm-360m's 64, h2o-danube's 80 and qwen1.5's 128
HEAD_DIMS = (16, 20, 64, 80, 128)

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_float, ctypes.c_int, ctypes.c_int)


def _check_head_dim(d: int) -> None:
    if d not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention: head dim {d} is not instantiated (the kernel "
            f"takes {HEAD_DIMS}); 112 (the MoE decoders) and 256 "
            "(recurrentgemma) come with their models, ROADMAP Queue 1, "
            "item 15b")


def _check(q, k, v, window, ndim: int) -> None:
    """What the kernel takes, short of the device: bf16 q, k, v of one
    GQA shape, an instantiated head dim, a positive window or None."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be torch.bfloat16, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{name} must have {ndim} dims, got "
                             f"{tuple(t.shape)}")
    if ndim == 3:
        if not q.shape == k.shape == v.shape:
            raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                             f"{tuple(v.shape)} differ")
    else:
        b, s, h, d = q.shape
        kh = k.shape[2]
        if k.shape != (b, s, kh, d) or v.shape != k.shape:
            raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and "
                             f"v {tuple(v.shape)} do not form a GQA triple")
        if kh == 0 or h % kh:
            raise ValueError(f"{h} query heads do not share {kh} kv heads "
                             "evenly")
    _check_head_dim(q.shape[-1])
    if window is not None and window <= 0:
        raise ValueError(f"window {window} must be positive or None")


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, S, KH, hd), bf16 -> (B, S, H, hd) bf16;
    query head h attends with kv head h // (H / KH)."""
    global launches
    _check(q, k, v, window, 4)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, name, dtype=torch.bfloat16, ndim=4)
        if t.data_ptr() % 4:
            raise ValueError(f"{name} must be 4-byte aligned")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _build.function("flash_attention", "flash_attention_bf16", _ARGS)
    _build.launch(fn, "flash_attention", q.device, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), b, s, h, k.shape[2], d,
                  d ** -0.5, int(bool(causal)),
                  0 if window is None else int(window))
    launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q, k, v (BH, S, d) bf16 -> (BH, S, d) bf16: one head per row of
    the leading dim, the GQA kernel with one head and one kv head."""
    _check(q, k, v, window, 3)
    return flash_attention_gqa(q[:, :, None], k[:, :, None], v[:, :, None],
                               causal=causal, window=window)[:, :, 0]
