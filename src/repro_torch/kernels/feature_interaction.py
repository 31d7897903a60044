"""Batched pairwise-dot feature interaction on Hopper: the ``interaction``
kernel (paper Fig. 3 / Fig. 11).

Replaces the Pallas kernel ``repro/kernels/feature_interaction.py:30
interaction`` (body ``_interact_kernel``, :20): Z = X X^T per sample.
The lower-triangle extraction stays outside, in ``kernels.ops``.

What bounds it on the card: bytes. At DLRM(1)'s F = 6, D = 32 it does
about three flops per byte read. The CUDA kernel
(``csrc/interaction.cu``) stages a group of samples' F x D slabs in
shared memory with coalesced reads (rows padded against bank conflicts)
and writes the F x F dots, each summed in order of d in f32.

This wrapper takes CUDA tensors only; ``kernels.ops`` routes CPU tensors
to the plain version in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# launches of the CUDA kernel in this process (not of the plain version)
launches = 0

# one sample's padded F x (D + 1) slab must fit the kernel's 48 KB of
# static shared memory
_MAX_SHARED = 48 * 1024

_ARGS = (ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int)


def interaction(x: torch.Tensor) -> torch.Tensor:
    """x: (B, F, D) f32 -> (B, F, F) pairwise dots per sample."""
    global launches
    _build.require(x, "x", dtype=torch.float32, ndim=3)
    b, f, d = x.shape
    if f * (d + 1) * 4 > _MAX_SHARED:
        raise ValueError(f"one sample's {f} x {d} features exceed the "
                         f"kernel's {_MAX_SHARED} bytes of shared memory")
    out = torch.empty((b, f, f), dtype=torch.float32, device=x.device)
    if b == 0 or f == 0:
        return out
    fn = _build.function("interaction", "interaction_f32", _ARGS)
    _build.launch(fn, "interaction", x.device, x.data_ptr(), out.data_ptr(),
                  b, f, d)
    launches += 1
    return out
