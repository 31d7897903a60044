"""Model API over the LM architectures, the counterpart of the
reference's ``repro/models/api.py`` on one card; an encoder-decoder
config goes to ``models.encdec``, every other one to
``models.transformer``, as the reference dispatches:

    init(generator, cfg, device=None)       -> params
    params_from_numpy(tree, device=None)    -> params
    forward / prefill / decode_step / init_cache
    make_prefill_step / make_decode_fn
    loss(params, cfg, batch, remat=True)    -> scalar
    default_optimizer(cfg)                  -> (name, optimizer)
    make_train_step(cfg, ...)               -> (name, optimizer, step fn)

Params are built under ``torch.no_grad()``, so their leaves can take
``requires_grad_()``; serving (forward, prefill, decode, the cache) runs
under ``torch.inference_mode()``, which records nothing. ``forward``
returns (logits, aux) as the reference's does, aux the MoE load-balance
loss summed over the layers (zero for a dense model), and ``loss``
adds ``aux_loss_coef`` x aux. Training differentiates ``loss`` with
autograd: through the flash op, whose backward recomputes through the
chunked attention. Mesh arguments and the dry-run stand-ins are not
ported (ROADMAP Queue 1, item 13c).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import optim as optim_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer


def _impl(cfg: ModelConfig):
    return encdec if cfg.is_encdec else transformer


def _inference(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.inference_mode():
            return fn(*args, **kwargs)
    return wrapped


@torch.no_grad()
def init(generator: torch.Generator, cfg: ModelConfig, *,
         device=None) -> Dict:
    """Random params from ``generator`` (on the card unless ``device``
    says otherwise)."""
    return _impl(cfg).init(generator, cfg, device=device)


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: the same
        # 16 bits, reinterpreted
        bits = np.array(a).view(np.uint16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    # np.array copies: the reference's arrays may be read-only views
    return torch.from_numpy(np.array(a)).to(device)


@torch.no_grad()
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
    return _impl(cfg).forward(params, cfg, batch)


@_inference
def prefill(params, cfg: ModelConfig, batch, max_len: int):
    return _impl(cfg).prefill(params, cfg, batch, max_len)


@_inference
def decode_step(params, cfg: ModelConfig, cache, tokens, pos):
    """``pos`` an int or a 0-dim tensor (read on the host)."""
    return _impl(cfg).decode_step(params, cfg, cache, tokens, int(pos))


@_inference
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    return _impl(cfg).init_cache(cfg, batch, max_len, dtype, device)


def make_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill_step(params, batch):
        return prefill(params, cfg, batch, max_len)
    return prefill_step


def make_decode_fn(cfg: ModelConfig):
    def serve_step(params, cache, batch):
        return decode_step(params, cfg, cache, batch["tokens"], batch["pos"])
    return serve_step


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def loss(params, cfg: ModelConfig, batch, remat: bool = True):
    return _impl(cfg).loss_fn(params, cfg, batch, remat=remat)


def default_optimizer(cfg: ModelConfig) -> Tuple[str, Any]:
    """Adafactor for the >100B MoE archs (state must stay O(P/d)), else
    AdamW; both wrapped layerwise, so an update's temporaries are one
    layer of the stacked params. Returns (name, optimizer)."""
    if cfg.moe is not None and cfg.d_model >= 4096:
        return "adafactor", optim_lib.layerwise(optim_lib.adafactor(1e-4))
    return "adamw", optim_lib.layerwise(optim_lib.adamw(3e-4))


def make_train_step(cfg: ModelConfig, optimizer=None, grad_clip: float = 1.0,
                    microbatches: int = 1):
    """Returns (opt_name, optimizer, train_step).

    train_step(params, opt_state, batch) -> (params, opt_state, metrics)
    updates ``params`` and ``opt_state`` in place and returns them, with
    ``metrics = {"loss", "grad_norm"}`` as 0-dim fp32 tensors on the
    params' device (nothing is read to the host). ``grad_norm`` is the
    norm before clipping to ``grad_clip``.

    microbatches > 1 is gradient accumulation, as the reference's scan:
    the batch is split contiguously along its first dim, the gradients are
    added in the params' dtype in micro-batch order starting from zeros,
    then divided by n; the loss is the mean of the micro-batch losses.
    """
    if optimizer is None:
        opt_name, opt = default_optimizer(cfg)
    else:
        opt_name, opt = optimizer

    def value_and_grad(params, batch):
        # fresh leaves over the params' storage: autograd records on
        # them, and the in-place update below writes the params
        leaves = optim_lib.tree_map(lambda p: p.detach().requires_grad_(),
                                    params)
        value = loss(leaves, cfg, batch)
        grads = torch.autograd.grad(value, optim_lib.tree_leaves(leaves))
        it = iter(grads)
        return value.detach(), optim_lib.tree_map(lambda _: next(it), leaves)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss_val, grads = value_and_grad(params, batch)
        else:
            n = next(iter(batch.values())).shape[0] // microbatches
            grads = optim_lib.tree_map(torch.zeros_like, params)
            losses = []
            for i in range(microbatches):
                mb_loss, g = value_and_grad(
                    params, {k: v[i * n:(i + 1) * n] for k, v in batch.items()})
                optim_lib.tree_map(torch.Tensor.add_, grads, g)
                losses.append(mb_loss)
            grads = optim_lib.tree_map(lambda g: g / microbatches, grads)
            loss_val = torch.stack(losses).mean()
        grads, gnorm = optim_lib.clip_by_global_norm(grads, grad_clip)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss_val, "grad_norm": gnorm}

    return opt_name, opt, train_step
