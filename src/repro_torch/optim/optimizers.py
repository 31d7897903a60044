"""Minimal optax-style optimizers, the counterpart of the reference's
``repro/optim/optimizers.py``.

An optimizer is a pair of functions:
    init(params) -> state
    update(grads, state, params) -> (new_params, new_state)

over a tree of tensors (dicts, lists and tuples), as in the reference.
Unlike the reference's pure functions, ``update`` works **in place**: it
rewrites the parameter tensors and the state's tensors and returns the
same objects, so a (V, D) embedding arena is never copied per step. A
caller that needs the old values keeps its own copy.

The step count is a Python int and learning-rate schedules are evaluated
on the host in float32, as the reference evaluates them in f32, so no
update reads the device. Every update computes a parameter's new value
in float32 from ``p.float()`` and writes it back rounded once to the
parameter's dtype, as the reference's ``(p.astype(f32) - lr *
step).astype(p.dtype)``; on a float32 leaf that is an in-place
subtraction of the same bits.

Provided: ``sgd`` (momentum), ``adamw``, ``adafactor`` (factored second
moments), ``rowwise_adagrad`` (the DLRM embedding tables), ``partitioned``
(one rule per top-level key), ``layerwise`` (the update one layer of a
stacked subtree at a time), global-norm clipping, ``warmup_cosine`` and
``from_config``. On a mesh the updates run on each rank's blocks: the
elementwise ones (AdamW, SGD) as they are; Adafactor, whose statistics
are means over a leaf's rows, its columns and the whole leaf, with a
``Layout`` a leaf (``update(..., layouts=)``) that names the mesh axes
splitting each of its dims: each mean's local sum is summed over the
axes that split the dims it runs over and divided by the whole leaf's
extent, so every statistic is the unsharded one. The global norm sums
the squares of each leaf over the axes that split it, each replicated
leaf once. The reference's ``state_logical_specs`` (the dry-run's) is
``models.api.train_state_specs`` here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

F32 = np.float32


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Any]   # (grads, state, params) -> (params, state)


def tree_map(f, tree, *rest):
    """Apply ``f`` leaf by leaf over trees of one structure (dicts, lists,
    tuples; every other object is a leaf). ``tree`` sets the structure:
    where it holds a leaf, ``f`` gets the other trees' subtrees whole."""
    if isinstance(tree, dict):
        return {k: tree_map(f, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(f, *xs) for xs in zip(tree, *rest))
    return f(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def tree_paths(tree, path: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in ``jax.tree_util.tree_flatten``'s
    order: dict keys sorted, lists and tuples in order, ``None`` an empty
    subtree, everything else a leaf. Two trees that hold the same keys in
    another order give the same paths in the same order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_paths(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, x in enumerate(tree)
                for pl in tree_paths(x, f"{path}[{i}]")]
    return [(path, tree)]


def _write(p: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """p <- p - delta, computed in float32 and rounded once to p's dtype,
    in place."""
    if p.dtype == torch.float32:
        return p.sub_(delta)
    return p.copy_(p.float().sub_(delta))


# ---------------------------------------------------------------------------
# Clipping
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Layout:
    """How a rank's block of a leaf lies on a mesh: ``dims`` names, for
    each dim of the leaf, the mesh axes (of more than one rank) that
    split it, ``()`` where the rank holds the dim whole; ``shape`` is the
    whole leaf's. ``models.api`` builds them from the params' specs."""
    mesh: Any
    dims: Tuple[Tuple[str, ...], ...]
    shape: Tuple[int, ...]

    @property
    def axes(self) -> Tuple[str, ...]:
        """Every axis that splits the leaf, in the mesh's order."""
        named = {a for d in self.dims for a in d}
        return tuple(a for a in self.mesh.axis_names if a in named)

    def layer(self) -> "Layout":
        """The layout of one slice along the leading dim (a layer of a
        stacked leaf, whose layer dim is never split)."""
        return Layout(self.mesh, self.dims[1:], self.shape[1:])

    def sum(self, x: torch.Tensor, *dims: int) -> torch.Tensor:
        """``x``, a sum over the rank's part of ``dims`` of the leaf,
        summed over the axes that split them: the whole leaf's sum, on
        every rank (``x`` itself where no axis splits them)."""
        # imported here: repro_torch.distributed imports this package
        from repro_torch.distributed import collectives
        named = {a for d in dims for a in self.dims[d]}
        axes = tuple(a for a in self.mesh.axis_names if a in named)
        return collectives.psum(x, self.mesh, axes) if axes else x


def global_norm(tree, mesh=None, layouts=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in float32, the leaves
    summed in the reference's leaf order (``tree_paths``). A 0-dim tensor
    on the leaves' device.

    On ``mesh``, ``layouts`` (a tree of ``Layout``s of ``tree``'s
    structure) says which leaves are this rank's blocks of a split
    leaf: the squares of the leaves split over the same axes are summed,
    then over those axes, and every leaf held whole is counted once.
    Every rank gets the same bits."""
    if mesh is None or layouts is None:
        return torch.sqrt(sum(x.float().square().sum()
                              for _, x in tree_paths(tree)))
    # imported here: repro_torch.distributed imports this package
    from repro_torch.distributed import collectives
    axes = [lay.axes for _, lay in tree_paths(layouts)]
    sq = [x.float().square().sum() for _, x in tree_paths(tree)]
    zero = torch.zeros((), dtype=torch.float32, device=sq[0].device)
    total = zero
    for group in sorted({a for a in axes if a}):
        part = sum((q for q, a in zip(sq, axes) if a == group), zero)
        total = total + collectives.psum(part, mesh, group)
    whole = sum((q for q, a in zip(sq, axes) if not a), zero)
    return torch.sqrt(total + whole)


def clip_by_global_norm(grads, max_norm: float, mesh=None, layouts=None):
    """(grads scaled by min(1, max_norm / (norm + 1e-9)), norm): new
    tensors of the grads' dtypes. The scale stays on the device. On a
    mesh the norm is the whole tree's (``global_norm``)."""
    norm = global_norm(grads, mesh, layouts)
    scale = torch.clamp(torch.full_like(norm, max_norm) / (norm + 1e-9),
                        max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


# ---------------------------------------------------------------------------
# Schedules, evaluated on the host in float32
# ---------------------------------------------------------------------------

def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> Callable[[int], np.float32]:
    def schedule(step):
        step = F32(step)
        warm = step / F32(max(1.0, warmup_steps))
        prog = (step - F32(warmup_steps)) / F32(
            max(1.0, total_steps - warmup_steps))
        prog = np.clip(prog, F32(0.0), F32(1.0))
        cos = F32(min_ratio) + F32((1 - min_ratio) * 0.5) * (
            F32(1.0) + np.cos(F32(np.pi) * prog))
        return F32(base_lr) * (warm if step < warmup_steps else cos)
    return schedule


def _as_schedule(lr):
    return lr if callable(lr) else (lambda step: F32(lr))


def _lr(sched, step: int) -> float:
    """The learning rate at ``step`` as a float32 value."""
    return float(F32(sched(step)))


# ---------------------------------------------------------------------------
# SGD + momentum
# ---------------------------------------------------------------------------

def sgd(lr, momentum: float = 0.9) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return {"mu": tree_map(lambda p: torch.zeros_like(
            p, dtype=torch.float32), params), "step": 0}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr(sched, step)

        def upd(p, g, mu):
            mu.mul_(momentum).add_(g.float())
            return _write(p, lr_t * mu)

        return (tree_map(upd, params, grads, state["mu"]),
                {"mu": state["mu"], "step": step})

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                              params),
                "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                              params),
                "step": 0}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr(sched, step)
        # the bias corrections in f32, as the reference computes them
        t = F32(step)
        c1 = float(F32(1) - F32(b1) ** t)
        c2 = float(F32(1) - F32(b2) ** t)

        def upd(p, g, m, v):
            # the reference's ops, in place where it keeps no operand:
            # fewer fp32 copies of a leaf and passes over it, the same
            # bits
            g32 = g.float()
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_(g32.square().mul_(1 - b2))
            del g32
            step_ = (m / c1).div_((v / c2).sqrt_().add_(eps))
            step_.add_(p.float() * weight_decay)
            return _write(p, step_.mul_(lr_t))

        new_params = tree_map(upd, params, grads, state["m"], state["v"])
        return new_params, {"m": state["m"], "v": state["v"], "step": step}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments; state ~ O(P/D) for matrices)
# ---------------------------------------------------------------------------

def _mean(x: torch.Tensor, dim: int, layout: Optional[Layout] = None,
          of: Optional[int] = None, keepdim: bool = False) -> torch.Tensor:
    """``x.mean(dim)`` of the whole leaf: where ``layout`` splits the
    leaf's dim ``of`` (``dim`` by default), the rank's sum summed over
    the axes that split it and divided by the dim's whole extent."""
    of = dim if of is None else of
    if layout is None or not layout.dims[of]:
        return x.mean(dim, keepdim=keepdim)
    return layout.sum(x.sum(dim, keepdim=keepdim), of) / layout.shape[of]


def _mean_all(x: torch.Tensor, layout: Optional[Layout] = None
              ) -> torch.Tensor:
    """``x.mean()`` of the whole leaf of which ``x`` is the rank's
    block."""
    if layout is None or not layout.axes:
        return x.mean()
    return layout.sum(x.sum(), *range(x.dim())) / float(
        np.prod(layout.shape))


def adafactor(lr, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """The reference's Adafactor. ``update(grads, state, params,
    layouts=None)``: on a mesh, ``layouts`` (a tree of ``Layout``s of the
    params' structure) makes every row and column mean, the normaliser
    and the update's RMS those of the whole leaf (module docstring)."""
    sched = _as_schedule(lr)

    def _factored(shape):
        return len(shape) >= 2

    def init(params):
        def per_leaf(p):
            z = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}
        return {"fac": tree_map(per_leaf, params), "step": 0}

    @torch.no_grad()
    def update(grads, state, params, layouts=None):
        step = state["step"] + 1
        lr_t = _lr(sched, step)
        beta = F32(1.0) - F32(step) ** F32(-decay)
        keep = float(F32(1.0) - beta)

        def per_leaf(p, g, st, lay=None):
            # the reference's ops in place where it keeps no operand, so
            # at most two fp32 copies of a leaf are alive at once (a
            # MoE's stacked expert leaf is GBs in fp32); the same bits.
            # The copy keeps an fp32 gradient as it was handed in
            g32 = g.to(torch.float32, copy=True)
            g2 = g32.square().add_(eps)
            if _factored(p.shape):
                vr = st["vr"].mul_(float(beta)).add_(
                    keep * _mean(g2, -1, lay))
                vc = st["vc"].mul_(float(beta)).add_(
                    keep * _mean(g2, -2, lay))
                del g2
                # vr's last dim is the leaf's second-to-last
                norm = _mean(vr, -1, lay, of=-2, keepdim=True)
                denom = (vr[..., None] * vc[..., None, :]).div_(
                    torch.clamp(norm[..., None], min=eps))
                upd = g32.div_(denom.add_(eps).sqrt_())
                del denom
            else:
                v = st["v"].mul_(float(beta)).add_(keep * g2)
                del g2
                upd = g32.div_(torch.sqrt(v + eps))
            rms = torch.sqrt(_mean_all(upd.square(), lay) + eps)
            upd.div_(torch.clamp(rms / clip_threshold, min=1.0))
            return _write(p, upd.mul_(lr_t))

        trees = (params, grads, state["fac"]) + (
            () if layouts is None else (layouts,))
        return (tree_map(per_leaf, *trees),
                {"fac": state["fac"], "step": step})

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Row-wise Adagrad (DLRM embedding tables)
# ---------------------------------------------------------------------------

def rowwise_adagrad(lr, eps: float = 1e-8) -> Optimizer:
    """One adaptive accumulator scalar per table *row* (paper-standard for
    embedding tables: state is rows x 1 instead of rows x dim)."""
    sched = _as_schedule(lr)

    def init(params):
        return {"acc": tree_map(
            lambda p: torch.zeros(p.shape[:-1] + (1,), dtype=torch.float32,
                                  device=p.device), params),
            "step": 0}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr(sched, step)

        def upd(p, g, a):
            g32 = g.float()
            a.add_(g32.square().mean(dim=-1, keepdim=True))
            return _write(p, lr_t * g32 / (torch.sqrt(a) + eps))

        return (tree_map(upd, params, grads, state["acc"]),
                {"acc": state["acc"], "step": step})

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Partitioned and layerwise optimizers
# ---------------------------------------------------------------------------

def partitioned(rules: dict, default: Optimizer) -> Optimizer:
    """Apply a different optimizer to top-level keys named in `rules`;
    DLRM uses ``partitioned({'arena': rowwise_adagrad(...)}, adamw(...))``."""
    def pick(key):
        return rules.get(key, default)

    def init(params):
        return {k: pick(k).init(v) for k, v in params.items()}

    def update(grads, state, params):
        new_p, new_s = {}, {}
        for k, p in params.items():
            new_p[k], new_s[k] = pick(k).update(grads[k], state[k], p)
        return new_p, new_s

    return Optimizer(init, update)


def _stacked_dim(subtree, min_layers: int) -> Optional[int]:
    """The layer count of a layer stack: a subtree of two or more leaves
    that all share a leading dim in [min_layers, 256] (a single big array,
    such as the vocab embedding, is never one)."""
    leaves = [x for _, x in tree_paths(subtree)]
    if len(leaves) < 2:
        return None
    dims = {x.shape[0] if getattr(x, "ndim", 0) > 0 else None
            for x in leaves}
    d = dims.pop() if len(dims) == 1 else None
    return d if (d is not None and min_layers <= d <= 256) else None


def layerwise(opt: Optimizer, min_layers: int = 8) -> Optimizer:
    """Apply `opt`'s update one layer at a time over stacked-layer
    subtrees, as the reference's ``lax.scan`` over the layer dim: a
    Python loop over views of layer i of the params, grads and state,
    updated in place. Top-level subtrees whose leaves (and whose grads'
    and state's leaves) all share a leading dim in [min_layers, 256] are
    taken a layer at a time; the rest update directly. That matters where
    an update reduces over a leaf: Adafactor clips by the RMS of its
    update, per layer under this rule. Leaf-wise optimizers only (adamw,
    sgd, adafactor, rowwise_adagrad)."""
    def init(params):
        return opt.init(params)

    def update(grads, state, params, layouts=None):
        # ``layouts`` (a mesh's, for Adafactor) go to ``opt`` sliced as
        # the params are
        kw = {} if layouts is None else {"layouts": layouts}
        if not isinstance(params, dict):
            return opt.update(grads, state, params, **kw)
        step = state.get("step")
        # state trees mirror params one level down inside each state field
        fields = [k for k in state if k != "step"]
        for key, p_sub in params.items():
            g_sub = grads[key]
            s_sub = {f: state[f][key] for f in fields}
            l_kw = {} if layouts is None else {"layouts": layouts[key]}
            n = _stacked_dim(p_sub, min_layers)
            if n is not None and _stacked_dim(g_sub, min_layers) == n and all(
                    _stacked_dim(s_sub[f], min_layers) == n for f in fields):
                if l_kw:
                    l_kw["layouts"] = tree_map(Layout.layer, l_kw["layouts"])
                for i in range(n):
                    def layer(tree, i=i):
                        return tree_map(lambda t: t[i], tree)
                    st_l = {f: layer(s_sub[f]) for f in fields}
                    st_l["step"] = step
                    opt.update(layer(g_sub), st_l, layer(p_sub), **l_kw)
            else:
                st = dict(s_sub)
                st["step"] = step
                opt.update(g_sub, st, p_sub, **l_kw)
        new_s = {f: state[f] for f in fields}
        new_s["step"] = step + 1
        return params, new_s

    return Optimizer(init, update)


def from_config(cfg) -> Optimizer:
    """Build from ``configs.base.OptimizerConfig``."""
    if cfg.name == "sgd":
        return sgd(cfg.lr)
    if cfg.name == "adamw":
        return adamw(cfg.lr, cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay)
    if cfg.name == "adafactor":
        return adafactor(cfg.lr)
    raise ValueError(f"unknown optimizer {cfg.name!r}")
