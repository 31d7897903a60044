"""Centaur's feature-interaction unit on Hopper (paper Fig. 3 / Fig. 11):
the ``interaction`` kernel.

Replaces the Pallas kernel ``repro/kernels/feature_interaction.py:30
interaction`` (body ``_interact_kernel``, :20), Z = X X^T per sample,
together with the ops the reference leaves around it to XLA: the concat
of the features, the strictly-lower triangle of Z and the concat with the
bottom MLP's output (``repro/core/dense_engine.py:42-51``), and their VJP
(``repro/kernels/ops.py:422-429``). On eager CUDA each of those would be
a launch and a host dispatch of its own, so the stage is one launch each
way:

* ``feature_interaction(bottom_out, reduced_embs)`` reads both in place
  and writes ``out`` (B, D + F(F-1)/2), the bottom copy then the kept
  pairs in ``jnp.tril_indices(F, k=-1)`` order, and ``feats`` (B, F, D);
* ``feature_interaction_backward`` writes ``d_bottom`` and ``d_embs``
  from the output gradient, an optional ``feats`` gradient and the saved
  inputs: the reference's (G + G^T) X over the kept triangle plus the
  pass-throughs;
* ``interaction(x)`` is the TPU kernel's own function, the full (B, F, F).

What bounds it on the card: bytes, under one flop a byte at DLRM(1)'s
F = 6, D = 32. The CUDA kernel (``csrc/interaction.cu``) gives each
sample a group of one to eight warps, one sample a block until there are
two blocks an SM, so a batch of 32 runs on 32 SMs; the group stages its
sample's rows in shared memory and computes only the pairs it keeps, each
summed in order of d in f32, so a sample's bits do not depend on the
batch or the grid.

These wrappers take CUDA tensors only; ``kernels.ops`` routes CPU tensors
to the plain versions in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

# launches of the CUDA kernel in this process (not of the plain version):
# the full matrix, the stage's forward and its backward
launches = 0

# one sample's rows (and, backward, its pair gradients) in shared memory
_MAX_SHARED = 227 * 1024

# each entry ends with the card's SM count, which spreads the samples
_ARGS = (ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int)
_STAGE_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_int)
_BACKWARD_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int)


def n_pairs(f: int) -> int:
    """Pairs of the strictly-lower triangle of an F x F matrix."""
    return f * (f - 1) // 2


def _fits(what: str, floats: int) -> None:
    if 4 * floats > _MAX_SHARED:
        raise ValueError(f"one sample's {what} ({floats} floats) exceed the "
                         f"kernel's {_MAX_SHARED} bytes of shared memory")


def interaction(x: torch.Tensor) -> torch.Tensor:
    """x: (B, F, D) f32 -> (B, F, F) pairwise dots per sample."""
    global launches
    _build.require(x, "x", dtype=torch.float32, ndim=3)
    b, f, d = x.shape
    _fits(f"{f} x {d} features", f * (d + 1))
    out = torch.empty((b, f, f), dtype=torch.float32, device=x.device)
    if b == 0 or f == 0:
        return out
    fn = _build.function("interaction", "interaction_f32", _ARGS)
    _build.launch(fn, "interaction", x.device, x.data_ptr(), out.data_ptr(),
                  b, f, d, _build.sm_count(x.device))
    launches += 1
    return out


def _stage_inputs(bottom_out: torch.Tensor,
                  reduced_embs: torch.Tensor) -> Tuple[int, int, int]:
    _build.require(bottom_out, "bottom_out", dtype=torch.float32, ndim=2)
    _build.require(reduced_embs, "reduced_embs", dtype=torch.float32, ndim=3)
    if bottom_out.device != reduced_embs.device:
        raise ValueError(f"bottom_out on {bottom_out.device}, reduced_embs "
                         f"on {reduced_embs.device}")
    b, t, d = reduced_embs.shape
    if tuple(bottom_out.shape) != (b, d):
        raise ValueError(f"bottom_out {tuple(bottom_out.shape)} for "
                         f"reduced_embs {tuple(reduced_embs.shape)}: "
                         f"expected ({b}, {d})")
    return b, t, d


def feature_interaction(bottom_out: torch.Tensor, reduced_embs: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """bottom_out (B, D), reduced_embs (B, T, D), f32 -> (out (B, D + P),
    feats (B, F, D)) in one launch; F = T + 1, P = F (F - 1) / 2."""
    global launches
    b, t, d = _stage_inputs(bottom_out, reduced_embs)
    f = t + 1
    _fits(f"{f} x {d} features", f * (d + 1))
    dev = bottom_out.device
    out = torch.empty((b, d + n_pairs(f)), dtype=torch.float32, device=dev)
    feats = torch.empty((b, f, d), dtype=torch.float32, device=dev)
    if b == 0:
        return out, feats
    fn = _build.function("interaction", "interaction_stage_f32", _STAGE_ARGS)
    _build.launch(fn, "interaction", dev, bottom_out.data_ptr(),
                  reduced_embs.data_ptr(), out.data_ptr(), feats.data_ptr(),
                  b, t, d, _build.sm_count(dev))
    launches += 1
    return out, feats


def feature_interaction_backward(
        g: torch.Tensor, g_feats: Optional[torch.Tensor],
        bottom_out: torch.Tensor, reduced_embs: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stage's VJP in one launch: g (B, D + P) and g_feats (B, F, D) or
    None against the saved bottom_out and reduced_embs -> (d_bottom (B, D),
    d_embs (B, T, D))."""
    global launches
    b, t, d = _stage_inputs(bottom_out, reduced_embs)
    f = t + 1
    _fits(f"{f} x {d} features and {n_pairs(f)} pair gradients",
          f * d + n_pairs(f))
    _build.require(g, "g", dtype=torch.float32, ndim=2)
    if tuple(g.shape) != (b, d + n_pairs(f)) or g.device != bottom_out.device:
        raise ValueError(f"g {tuple(g.shape)} on {g.device}: expected "
                         f"({b}, {d + n_pairs(f)}) on {bottom_out.device}")
    if g_feats is not None:
        _build.require(g_feats, "g_feats", dtype=torch.float32, ndim=3)
        if (tuple(g_feats.shape) != (b, f, d)
                or g_feats.device != bottom_out.device):
            raise ValueError(f"g_feats {tuple(g_feats.shape)} on "
                             f"{g_feats.device}: expected ({b}, {f}, {d}) "
                             f"on {bottom_out.device}")
    dev = bottom_out.device
    d_bottom = torch.empty((b, d), dtype=torch.float32, device=dev)
    d_embs = torch.empty((b, t, d), dtype=torch.float32, device=dev)
    if b == 0:
        return d_bottom, d_embs
    fn = _build.function("interaction", "interaction_stage_backward_f32",
                         _BACKWARD_ARGS)
    _build.launch(fn, "interaction", dev, g.data_ptr(),
                  None if g_feats is None else g_feats.data_ptr(),
                  bottom_out.data_ptr(), reduced_embs.data_ptr(),
                  d_bottom.data_ptr(), d_embs.data_ptr(), b, t, d,
                  _build.sm_count(dev))
    launches += 1
    return d_bottom, d_embs
