"""Output-stationary fp32 matmul on Hopper: the ``gemm`` kernel.

Replaces the Pallas kernel ``repro/kernels/gemm.py:39 gemm`` (body
``_gemm_kernel``, :21), Centaur's dense engine: every MLP layer of the
serving path, six launches per forward on DLRM(1).

What bounds it on the card: at serving batch sizes (M = 1..32) the
product is small and the time is reading the weights once, so bytes; at
M in the thousands it turns towards the fp32 CUDA-core rate. The CUDA
kernel (``csrc/gemm.cu``) keeps a 32 x 32 output tile in registers and
streams 32-deep slices of x and w through shared memory, in true fp32
FMA (no TF32: the reference accumulates in full f32). It masks every
edge itself, so K = 13 or 47 and N = 1 need no padding.

This wrapper takes CUDA tensors only; ``kernels.ops`` routes CPU tensors
to the plain version in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# launches of the CUDA kernel in this process (not of the plain version)
launches = 0

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int)


def gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x:(M,K) @ w:(K,N) -> (M,N) f32 with fp32 accumulation."""
    global launches
    _build.require(x, "x", dtype=torch.float32, ndim=2)
    _build.require(w, "w", dtype=torch.float32, ndim=2)
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    fn = _build.function("gemm", "gemm_f32", _ARGS)
    _build.launch(fn, "gemm", x.device, x.data_ptr(), w.data_ptr(),
                  out.data_ptr(), m, n, k)
    launches += 1
    return out
