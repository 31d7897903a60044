"""Causal / windowed flash attention on Hopper: the ``flash_attention``
kernel, the forward (``kernels/ops.py``'s op recomputes its backward
through the model's chunked attention).

Replaces the Pallas kernel ``repro/kernels/flash_attention.py:77
flash_attention`` (body ``_flash_kernel``, :31) and its GQA wrapper
``flash_attention_gqa`` (:113): online-softmax attention whose running
max, sum and output accumulator never leave the chip, so device memory
sees only q, k, v and the output, never the (S, S) scores.

What bounds it on the card: operations. Causal attention at the LM's
prefill lengths (S = 2048..4096) does a few hundred flops per byte of
q, k, v and out, above the bf16 tensor cores' balance point. The CUDA
kernel (``csrc/flash_attention.cu``, whose header note has the details)
is warp-specialised: one producer warpgroup issues TMA copies of a q
tile and of 128-key K and V tiles (64-key at hd 256, whose two stages
would not fit the block's shared memory at 128) into a two-stage ring
behind mbarriers, and consumer warpgroups of 64 query rows (one a block
at hd <= 80 and at hd 256, two at hd 128) run both products on
``wgmma`` (S = Q K^T from shared memory, O += P V with
P from registers and V as an MN-major operand), skipping kv tiles
wholly outside the causal and window band and the mask arithmetic on
tiles wholly inside it. Each query head reads its kv head as a TMA
coordinate, so GQA repeats nothing. It keeps the reference's numerics:
fp32 scores from bf16 operands times d**-0.5 (folded with log2(e) into
an exp2), -1e30 for masked entries, P rounded to bf16 before the PV
product while the row sum adds the fp32 P, and acc / max(l, 1e-30).

The wrapper's own decisions are pure functions here, so the CPU tests
reach them: the depth each head dim runs at (the smallest instantiated
depth at or above it: hd 20, whose 40-byte head stride breaks TMA's
16-byte rule, is padded to 32, and the MoE decoders' hd 112, which
would take a third panel, to 128, each with one copy of q, k and v; the
kernel scales by the true head dim and stores its columns only), the
16-byte stride rule, and the scalars handed to the C entry. The tiling (q and kv tiles, TMA boxes, grid) is fixed per depth
in the C++ and held on the card by ``chip_smoke.py``.

This wrapper takes CUDA tensors only; ``kernels.ops`` routes CPU tensors
to the plain version in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

# launches of the CUDA kernel in this process (not of the plain version)
launches = 0

# head dims the kernel takes: the smoke configs' 16 and 20, smollm-360m's
# and seamless-m4t's 64, h2o-danube's 80, kimi-k2's 112, qwen1.5's,
# arctic's and internvl2's 128, and recurrentgemma-9b's 256
HEAD_DIMS = (16, 20, 64, 80, 112, 128, 256)
# the depths csrc/flash_attention.cu instantiates
DEPTHS = (16, 32, 64, 80, 128, 256)
# TMA: the global address and every stride a multiple of 16 bytes
TMA_ALIGN = 16
# the C entry adds this to the CUresult of a tensor map that failed
ENCODE_ERROR = 20000
LOG2E = 1.4426950408889634

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int)


def _check_head_dim(d: int) -> None:
    if d not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention: head dim {d} is not instantiated (the kernel "
            f"takes {HEAD_DIMS})")


def tma_strides_ok(depth: int, heads: int) -> bool:
    """TMA's stride rule for a contiguous (B, S, heads, depth) bf16
    tensor: the head and row strides are multiples of 16 bytes (the
    batch stride then is too)."""
    return ((2 * depth) % TMA_ALIGN == 0
            and (2 * depth * heads) % TMA_ALIGN == 0)


def depth(d: int) -> int:
    """The depth the kernel runs a head dim at: the smallest instantiated
    depth at or above d (hd 20 -> 32, whose 40-byte head stride breaks
    TMA's rule; hd 112 -> 128, which would take a third panel); every
    depth meets TMA's 16-byte rule for any head count."""
    return min(dp for dp in DEPTHS if dp >= d)


def route(d: int) -> str:
    """"tma": q, k, v go to the kernel as they are; "pad": the wrapper
    first pads them to ``depth(d)`` with one copy each."""
    return "tma" if depth(d) == d else "pad"


def c_args(d: int, causal: bool,
           window: Optional[int]) -> Tuple[int, int, float, int, int]:
    """The scalars the C entry takes for head dim ``d``: the depth it
    runs at, the columns it stores, d**-0.5 log2(e) of the true head dim
    (hd 20 scales by 20**-0.5 at depth 32, hd 112 by 112**-0.5 at 128),
    causal as 0/1 and the window (0: none)."""
    return (depth(d), d, d ** -0.5 * LOG2E, int(bool(causal)),
            0 if window is None else int(window))


def launch_error(rc: int) -> str:
    if rc >= ENCODE_ERROR:
        return (f"flash_attention: cuTensorMapEncodeTiled failed with "
                f"CUresult {rc - ENCODE_ERROR}")
    what = (torch.cuda.CudaError(rc) if torch.cuda.is_available()
            else f"cudaError {rc}")
    return f"flash_attention kernel failed to launch: {what}"


def check_aligned(**tensors: torch.Tensor) -> None:
    """TMA reads from 16-byte aligned addresses only."""
    for name, t in tensors.items():
        if t.data_ptr() % TMA_ALIGN:
            raise ValueError(f"{name} must be {TMA_ALIGN}-byte aligned for "
                             f"TMA, got address {t.data_ptr():#x}")


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
    b, s, h, d = q.shape
    kh = k.shape[2]
    dp, d_out, scale_log2, causal, window = c_args(d, causal, window)
    if route(d) == "pad":
        q, k, v = (F.pad(t, (0, dp - d)) for t in (q, k, v))
    check_aligned(q=q, k=k, v=v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, name, dtype=torch.bfloat16, ndim=4)
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = _build.function("flash_attention", "flash_attention_bf16", _ARGS)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                s, h, kh, dp, d_out, scale_log2, causal, window,
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(launch_error(rc))
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
