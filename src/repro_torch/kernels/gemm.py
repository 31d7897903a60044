"""fp32 matmul on Hopper in three operand layouts: the ``gemm`` kernel.

Replaces the Pallas kernel ``repro/kernels/gemm.py:39 gemm`` (body
``_gemm_kernel``, :21), Centaur's dense engine: every MLP layer of the
serving path, six launches per forward on DLRM(1), and the two GEMMs of
each layer's backward. ``gemm(x, w)`` is ``x @ w``, ``gemm_nt(a, b)`` is
``a @ b^T`` (dx = g w^T) and ``gemm_tn(a, b)`` is ``a^T @ b`` (dw = x^T
g); the kernel reads all three in place, so the backward copies nothing.

What bounds it on the card: at serving batch sizes (M <= 64) the product
is small and the time is reading the weights once, so bytes and launch
latency; at M in the thousands, operations. ``plan`` picks one of the
two tilings of ``csrc/gemm.cu`` (whose header note has the details) from
the shape alone:

* M <= 64 (and any product with K <= 64 or N <= 32): split-K across a
  thread-block cluster of ``split`` <= 8 blocks, each summing one
  ``slice`` of K with fp32 FMA in order of k, the partials reduced in
  rank order through distributed shared memory. ``split`` and ``slice``
  depend on K alone, so a row's bits do not depend on M.
* M > 64 with K > 64 and N > 32: 3xTF32 on the tensor cores
  (``mma.sync``), each operand split into a TF32 high and low part, fp32
  accuracy at tensor-core rates; a long or narrow product also splits K
  across a cluster, by K and N.

Both accumulate in fp32 and mask every edge in the kernel, so K = 13 or
47 and N = 1 need no padding. This wrapper takes CUDA tensors only;
``kernels.ops`` routes CPU tensors to the plain versions in
``kernels.ref``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

# launches of the CUDA kernel in this process (not of the plain version),
# all three layouts together
launches = 0

# the tensor cores take a product with more than CLUSTER_ROWS rows, more
# than SPLIT_FROM of contraction and more than NARROW_N columns; the
# cluster split-K tiling on the CUDA cores takes every other one
CLUSTER_ROWS = 64
NARROW_N = 32
# blocks of a cluster at most (the portable cluster size)
MAX_SPLIT = 8
# split-K keeps a contraction of up to SPLIT_FROM in one block (a
# cluster's reduction costs more than it saves there) and gives a longer
# one SLICE_DEPTH a block; the tensor-core tiling, whose output tiles are
# 64 columns wide, splits at 256 deep, and at 64 when N gives it fewer
# than four column tiles
SLICE_DEPTH = 32
SPLIT_FROM = 64
TC_SLICE_DEPTH = {"wide": 256, "narrow": 64}
TC_WIDE = 256
# the tensor-core tiling's k-tile: its slices are whole tiles
TC_TILE_K = 32

# operand layouts and routes of the C entry
NN, NT, TN = 0, 1, 2
_ROUTES = {"cluster": 0, "tf32x3": 1}

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int)


class Plan(NamedTuple):
    """``route`` "cluster" (the split-K tiling) or "tf32x3" (the tensor
    cores); either way a cluster of ``split`` blocks along K, each
    ``slice`` of it deep, the partials summed in rank order."""
    route: str
    split: int
    slice: int


def _split(k: int, depth: int, align: int) -> tuple:
    """(split, slice): ceil(k / depth) blocks, at most MAX_SPLIT, each
    ceil(k / split) deep rounded up to ``align``; no block left empty."""
    split = min(MAX_SPLIT, -(-k // depth))
    per = -(-(-(-k // split)) // align) * align
    return -(-k // per), per


def plan(m: int, k: int, n: int) -> Plan:
    """The tiling of an (m, k) x (k, n) product, in any layout.

    The 3xTF32 tensor-core tiling when m > CLUSTER_ROWS, k > SPLIT_FROM
    and n > NARROW_N: a cluster along k of ceil(k / depth) blocks, at most
    MAX_SPLIT, each a whole number of TC_TILE_K tiles deep; depth 256
    when n >= TC_WIDE, else 64 (a narrow product has few output tiles to
    fill the card with): 2 blocks at k = 512, n = 256, 8 at k = 2048.
    Every other product -- the serving buckets, the small-k and narrow
    layers at any m -- takes the split-K tiling on the CUDA cores: one
    block up to k = SPLIT_FROM, else ceil(k / SLICE_DEPTH) blocks, at
    most MAX_SPLIT, each ceil(k / split) deep rounded up to a multiple of
    4 (16-byte copies): 1 at k = 13 and 47, 8 at 256 and 512.

    m only picks the route, never the split: output (r, c) is summed in
    an order that the route, k and n fix, so a row's bits are the same
    for every m <= CLUSTER_ROWS, for every m above it, and, where k or n
    is small, for every m at all.
    """
    if min(m, k, n) < 1:
        raise ValueError(f"gemm plan: empty product ({m}, {k}) x ({k}, {n})")
    if m > CLUSTER_ROWS and k > SPLIT_FROM and n > NARROW_N:
        depth = TC_SLICE_DEPTH["wide" if n >= TC_WIDE else "narrow"]
        return Plan("tf32x3", *_split(k, depth, TC_TILE_K))
    return Plan("cluster", *_split(k, SLICE_DEPTH if k > SPLIT_FROM
                                   else k, 4))


def _launch(a: torch.Tensor, b: torch.Tensor, m: int, k: int, n: int,
            layout: int) -> torch.Tensor:
    global launches
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    p = plan(m, k, n)
    fn = _build.function("gemm", "gemm_f32", _ARGS)
    _build.launch(fn, "gemm", a.device, a.data_ptr(), b.data_ptr(),
                  out.data_ptr(), m, n, k, layout, _ROUTES[p.route], p.split,
                  p.slice)
    launches += 1
    return out


def _check(a: torch.Tensor, b: torch.Tensor, form: str, ka: int,
           kb: int) -> None:
    """Shapes, dtype and layout of both operands first, so each fault is
    named on any device; then the device (``_build.require``)."""
    for t, name in ((a, "a"), (b, "b")):
        if not isinstance(t, torch.Tensor) or t.dim() != 2:
            raise ValueError(f"{form}: {name} must be a 2-d tensor")
    if a.shape[ka] != b.shape[kb]:
        raise ValueError(f"contraction mismatch for {form}: "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    for t, name in ((a, "a"), (b, "b")):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{form}: {name} must be contiguous "
                             f"torch.float32, got {t.dtype}, strides "
                             f"{t.stride()}")
    _build.require(a, "a", dtype=torch.float32, ndim=2)
    _build.require(b, "b", dtype=torch.float32, ndim=2)
    if b.device != a.device:
        raise ValueError(f"b on {b.device}, a on {a.device}")


def gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x:(M,K) @ w:(K,N) -> (M,N) f32 with fp32 accumulation."""
    _check(x, w, "x @ w", 1, 0)
    return _launch(x, w, x.shape[0], x.shape[1], w.shape[1], NN)


def gemm_nt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a:(M,K) @ b:(N,K)^T -> (M,N) f32, b read in place."""
    _check(a, b, "a @ b^T", 1, 1)
    return _launch(a, b, a.shape[0], a.shape[1], b.shape[0], NT)


def gemm_tn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a:(K,M)^T @ b:(K,N) -> (M,N) f32, a read in place."""
    _check(a, b, "a^T @ b", 0, 0)
    return _launch(a, b, a.shape[1], a.shape[0], b.shape[1], TN)
