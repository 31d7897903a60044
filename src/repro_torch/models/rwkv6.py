"""RWKV-6 "Finch" block: data-dependent token shift and decay linear
attention, the counterpart of the reference's ``repro/models/rwkv6.py``.

State per head is a (head_dim x head_dim) matrix updated as
    S_t = diag(w_t) S_{t-1} + k_t^T v_t,
    out_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with w_t a data-dependent per-channel decay. Attention-free: the decode
state is O(1) in the context length.

The WKV recurrence is plain JAX in the reference (``lax.scan``), no
Pallas kernel, and is ported as torch ops: ``_wkv_scan`` is the
sequential form (a loop over S, a few ops a step: decode, and a prefill
whose length no chunk divides), ``_wkv_chunked`` the chunk-parallel form
(S / chunk steps of small matmuls) that the forward and the prefill take
when ``s % chunk_size == 0 and s > 1``, as the reference does
(``rwkv6.py:155``). Both keep the reference's numerics: the recurrence in
fp32, the ``1e-38`` floor under the log of the decay, ``exp(-cum)``
folded into k, and the per-head RMS with eps 1e-6. The recurrence runs
in a profiler span, ``WKV_SPAN``, so that a trace can tell its device
time from the block's projections.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RWKVConfig
from repro_torch.models.params import Builder

_COMPONENTS = 5   # r, k, v, w, g
# the profiler span around the WKV recurrence, either form
WKV_SPAN = "rwkv_wkv"


def init_time_mix(b: Builder, rcfg: RWKVConfig, d: int):
    h = d // rcfg.head_dim
    ts = rcfg.token_shift_lora
    return {
        "mu_x": b.normal((d,), scale=0.1),
        "mu": b.normal((_COMPONENTS, d), scale=0.1),
        "lora_a": b.normal((d, _COMPONENTS * ts), scale=0.01),
        "lora_b": b.normal((_COMPONENTS, ts, d), scale=0.01),
        "wr": b.normal((d, d)),
        "wk": b.normal((d, d)),
        "wv": b.normal((d, d)),
        "wg": b.normal((d, d)),
        "w_base": b.const(-6.0 * torch.ones((d,)), dtype=torch.float32),
        "w_lora_a": b.normal((d, rcfg.decay_lora), scale=0.01),
        "w_lora_b": b.normal((rcfg.decay_lora, d), scale=0.01),
        "u": b.normal((h, rcfg.head_dim), scale=0.1),
        "ln_w": b.ones((d,), dtype=torch.float32),
        "wo": b.normal((d, d)),
    }


def _shifted(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Token shift: the carry (B, 1, D) (zeros at the sequence start)
    before x[:, :-1]."""
    return torch.cat([x_prev.to(x.dtype), x[:, :-1]], 1)


def _mix_inputs(p, x: torch.Tensor, xs: torch.Tensor):
    """Data-dependent lerp between x and the shifted x for the five
    components."""
    dx = xs - x
    xxx = x + dx * p["mu_x"]
    lora = torch.tanh(xxx @ p["lora_a"])
    b_, s, _ = x.shape
    ts = p["lora_b"].shape[1]
    lora = lora.reshape(b_, s, _COMPONENTS, ts)
    adj = torch.einsum("bsft,ftd->bsfd", lora, p["lora_b"])
    mixed = x[:, :, None] + dx[:, :, None] * (p["mu"] + adj)
    return [mixed[:, :, i] for i in range(_COMPONENTS)]


def _rkvwg(p, rcfg: RWKVConfig, x: torch.Tensor, xs: torch.Tensor):
    x_r, x_k, x_v, x_w, x_g = _mix_inputs(p, x, xs)
    b_, s, d = x.shape
    h, hd = d // rcfg.head_dim, rcfg.head_dim
    r = (x_r @ p["wr"]).reshape(b_, s, h, hd)
    k = (x_k @ p["wk"]).reshape(b_, s, h, hd)
    v = (x_v @ p["wv"]).reshape(b_, s, h, hd)
    g = F.silu(x_g @ p["wg"])
    w_log = p["w_base"] + torch.tanh(x_w @ p["w_lora_a"]) @ p["w_lora_b"]
    w = torch.exp(-torch.exp(w_log.float())).reshape(b_, s, h, hd)
    return r, k, v, w, g


def _wkv_scan(r, k, v, w, u, s0):
    """Sequential WKV recurrence. r, k, v, w (B, S, H, hd); s0 (B, H,
    hd, hd) fp32. Returns (out (B, S, H, hd), the last state), fp32."""
    r, k, v, w = (t.float() for t in (r, k, v, w))
    state = s0
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # (B,H,hd,hd)
        outs.append(torch.einsum("bhi,bhij->bhj", r[:, t],
                                 state + u[..., :, None] * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(outs, 1), state


def _wkv_chunked(r, k, v, w, u, s0, chunk: int):
    """Chunk-parallel WKV: an intra-chunk attention matmul and the state
    carried across chunks; the math of ``_wkv_scan``."""
    b_, s, h, hd = r.shape
    if s % chunk:
        raise ValueError(f"chunk {chunk} does not divide S = {s}")
    n = s // chunk
    rc, kc, vc, wc = (t.float().reshape(b_, n, chunk, h, hd)
                      for t in (r, k, v, w))
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    state = s0
    outs = []
    for c in range(n):
        r_, k_, v_, w_ = rc[:, c], kc[:, c], vc[:, c], wc[:, c]  # (B,c,H,hd)
        logw = torch.log(torch.clamp(w_, min=1e-38))
        cum = torch.cumsum(logw, 1)                   # prod of decays to t
        # the carried state's share: r_t (prod_{j<t} w_j) S
        decay_in = torch.exp(cum - logw)
        out_state = torch.einsum("bchi,bhij->bchj", r_ * decay_in, state)
        # pairwise within the chunk: the channel-dependent decay between
        # j and t folded into the operands, r~_t = r_t exp(cum_{t-1}),
        # k~_j = k_j exp(-cum_j); scores[t, j] = <r~_t, k~_j> for j < t
        r_tilde = r_ * torch.exp(cum - logw)
        k_tilde = k_ * torch.exp(-cum)
        scores = torch.einsum("bchi,bdhi->bhcd", r_tilde, k_tilde)
        scores = torch.where(mask, scores, 0.0)
        out_intra = torch.einsum("bhcd,bdhj->bchj", scores, v_)
        # the current token's bonus: r_t . (diag(u) k_t^T v_t)
        out_bonus = (r_ * (u[None, None] * k_)).sum(-1, keepdim=True) * v_
        # the state at the chunk's end:
        #   S' = diag(prod w) S + sum_j (prod_{m>j} w_m) k_j v_j
        decay_all = torch.exp(cum[:, -1])             # (B,H,hd)
        k_fold = k_ * torch.exp(cum[:, -1:] - cum)
        state = decay_all[..., None] * state + torch.einsum(
            "bchi,bchj->bhij", k_fold, v_)
        outs.append(out_state + out_intra + out_bonus)
    return torch.stack(outs, 1).reshape(b_, s, h, hd), state


def time_mix_full(p, rcfg: RWKVConfig, x: torch.Tensor, state=None,
                  chunked: bool = False):
    """x (B, S, D) -> (y, new state {"x_prev", "S"}); ``state`` the
    carried one, or None for a zero state."""
    b_, s, d = x.shape
    h, hd = d // rcfg.head_dim, rcfg.head_dim
    x_prev = (state["x_prev"][:, None] if state is not None
              else torch.zeros((b_, 1, d), dtype=x.dtype, device=x.device))
    r, k, v, w, g = _rkvwg(p, rcfg, x, _shifted(x, x_prev))
    s0 = (state["S"] if state is not None
          else torch.zeros((b_, h, hd, hd), dtype=torch.float32,
                           device=x.device))
    u = p["u"].float()
    with torch.profiler.record_function(WKV_SPAN):
        if chunked and s % rcfg.chunk_size == 0 and s > 1:
            out, s_last = _wkv_chunked(r, k, v, w, u, s0, rcfg.chunk_size)
        else:
            out, s_last = _wkv_scan(r, k, v, w, u, s0)
    # the per-head norm, then the gate
    rms = torch.rsqrt(out.square().mean(-1, keepdim=True) + 1e-6)
    out = (out * rms).reshape(b_, s, d) * p["ln_w"]
    y = (out.to(x.dtype) * g) @ p["wo"]
    return y, {"x_prev": x[:, -1], "S": s_last}


def init_channel_mix(b: Builder, d: int, dff: int):
    return {
        "mu_k": b.normal((d,), scale=0.1),
        "mu_r": b.normal((d,), scale=0.1),
        "wk": b.normal((d, dff)),
        "wv": b.normal((dff, d)),
        "wr": b.normal((d, d)),
    }


def channel_mix_full(p, x: torch.Tensor, state=None):
    b_, s, d = x.shape
    x_prev = (state["x_prev"][:, None] if state is not None
              else torch.zeros((b_, 1, d), dtype=x.dtype, device=x.device))
    dx = _shifted(x, x_prev) - x
    x_k = x + dx * p["mu_k"]
    x_r = x + dx * p["mu_r"]
    k = torch.relu(x_k @ p["wk"]).square()
    y = torch.sigmoid(x_r @ p["wr"]) * (k @ p["wv"])
    return y, {"x_prev": x[:, -1]}


def init_tm_state(rcfg: RWKVConfig, d: int, batch: int,
                  dtype=torch.bfloat16, device=None):
    h = d // rcfg.head_dim
    return {"x_prev": torch.zeros((batch, d), dtype=dtype, device=device),
            "S": torch.zeros((batch, h, rcfg.head_dim, rcfg.head_dim),
                             dtype=torch.float32, device=device)}


def init_cm_state(d: int, batch: int, dtype=torch.bfloat16, device=None):
    return {"x_prev": torch.zeros((batch, d), dtype=dtype, device=device)}
