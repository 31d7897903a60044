"""RG-LRU recurrent block (RecurrentGemma / Griffin), the counterpart of
the reference's ``repro/models/rglru.py``.

Recurrence: h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t), with
a_t = exp(-c * softplus(Lambda) * r_t) and r, i input-dependent gates.

The reference computes the diagonal linear recurrence over the sequence
with ``jax.lax.associative_scan`` of the pair (a, b) under the combine
(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2); it is plain JAX, no Pallas
kernel. torch has no associative scan, and a loop over S would launch a
few ops a position (about 53k launches for recurrentgemma-9b's 26
recurrent layers at S = 2048), so ``_scan`` runs the same recurrence as
a log-depth (Hillis-Steele) scan: ceil(log2 S) passes of elementwise
ops over the whole (B, S, W) pair, in fp32 (11 passes at S = 2048). The
two scans associate the products in different trees, so they agree to
fp32 rounding, not bit for bit. The scan runs in a profiler span,
``SCAN_SPAN``, so that a trace can tell its device time from the
block's other elementwise ops.

Numerics follow the reference: the gates in the params' dtype, log a
and the recurrence in fp32, the causal depthwise conv summed over its
taps in the reference's order, ``gelu`` the tanh approximation (as
``jax.nn.gelu``'s default).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RGLRUConfig
from repro_torch.models.params import Builder

_C = 8.0
# the profiler span around the recurrence's scan
SCAN_SPAN = "rglru_scan"


def init_rec(b: Builder, rcfg: RGLRUConfig, d: int):
    w = rcfg.lru_width or d
    # Lambda so that a ~ U[0.9, 0.999] at r = 1 (Griffin's appendix)
    lam = torch.log(torch.expm1(-torch.log(torch.linspace(
        0.9, 0.999, w, dtype=torch.float32)) / _C))
    return {
        "wx": b.normal((d, w)),
        "wgate": b.normal((d, w)),
        "conv_w": b.normal((rcfg.conv_width, w), scale=0.1),
        "conv_b": b.zeros((w,)),
        "wa": b.normal((w, w), scale=0.01),
        "ba": b.const(torch.zeros((w,)) - 1.0),
        "wi": b.normal((w, w), scale=0.01),
        "bi": b.zeros((w,)),
        "lam": b.const(lam, dtype=torch.float32),
        "wo": b.normal((w, d)),
    }


def _gates(p, xc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, b) of the recurrence, fp32: a = exp(log a) and b = sqrt(1 -
    a^2) (i x)."""
    r = torch.sigmoid(xc @ p["wa"] + p["ba"])
    i = torch.sigmoid(xc @ p["wi"] + p["bi"])
    log_a = -_C * F.softplus(p["lam"]) * r.float()
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * (i * xc).float()


def _conv_full(p, xb: torch.Tensor, conv_w: int,
               state: Optional[torch.Tensor] = None):
    """Causal depthwise conv over S. state: (B, conv_w - 1, W) history
    (zeros without). Returns (out, the new history)."""
    if state is None:
        pad = torch.zeros(xb.shape[:1] + (conv_w - 1,) + xb.shape[2:],
                          dtype=xb.dtype, device=xb.device)
    else:
        pad = state.to(xb.dtype)
    xp = torch.cat([pad, xb], 1)
    s = xb.shape[1]
    out = xp[:, 0:s] * p["conv_w"][0]
    for i in range(1, conv_w):
        out = out + xp[:, i:i + s] * p["conv_w"][i]
    return out + p["conv_b"], xp[:, -(conv_w - 1):]


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 over dim 1, as a log-depth
    inclusive scan of (a, b): at offset o each position t >= o takes
    (a_{t-o} a_t, a_t b_{t-o} + b_t), o = 1, 2, 4, ... < S."""
    s = a.shape[1]
    o = 1
    while o < s:
        b = torch.cat([b[:, :o], torch.addcmul(b[:, o:], a[:, o:],
                                               b[:, :-o])], 1)
        if 2 * o < s:
            a = torch.cat([a[:, :o], a[:, o:] * a[:, :-o]], 1)
        o *= 2
    return b


def rec_full(p, rcfg: RGLRUConfig, x: torch.Tensor,
             h0: Optional[torch.Tensor] = None):
    """x (B, S, D) -> (y (B, S, D), state {"h", "conv"}): the whole
    sequence, from a zero state or from ``h0`` (B, W)."""
    xb = x @ p["wx"]
    gate = F.gelu(x @ p["wgate"], approximate="tanh")
    xc, conv_state = _conv_full(p, xb, rcfg.conv_width)
    a, b_term = _gates(p, xc)
    if h0 is not None:
        # fold the carried state into step 0: b_0 += a_0 * h0
        b_term = torch.cat([b_term[:, :1] + a[:, :1] * h0.float()[:, None],
                            b_term[:, 1:]], 1)
    with torch.profiler.record_function(SCAN_SPAN):
        h = _scan(a, b_term)
    y = (h.to(x.dtype) * gate) @ p["wo"]
    return y, {"h": h[:, -1], "conv": conv_state}


def init_rec_state(rcfg: RGLRUConfig, d: int, batch: int,
                   dtype=torch.float32, device=None):
    w = rcfg.lru_width or d
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, rcfg.conv_width - 1, w), dtype=dtype,
                                device=device)}


def rec_step(p, rcfg: RGLRUConfig, x: torch.Tensor, state):
    """One token. x (B, 1, D) -> (y (B, 1, D), the new state)."""
    xb = x @ p["wx"]
    gate = F.gelu(x @ p["wgate"], approximate="tanh")
    xc, conv_state = _conv_full(p, xb, rcfg.conv_width, state["conv"])
    a, b_term = _gates(p, xc)
    h = a[:, 0] * state["h"] + b_term[:, 0]
    y = (h[:, None].to(x.dtype) * gate) @ p["wo"]
    return y, {"h": h, "conv": conv_state}
