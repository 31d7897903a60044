"""Minimal optax-style optimizers, the DLRM subset of the reference's
``repro/optim/optimizers.py``.

An optimizer is a pair of functions:
    init(params) -> state
    update(grads, state, params) -> (new_params, new_state)

over a tree of tensors (dicts, lists and tuples), as in the reference.
Unlike the reference's pure functions, ``update`` works **in place**: it
rewrites the parameter tensors and the state's tensors and returns the
same objects, so a (V, D) embedding arena is never copied per step. A
caller that needs the old values keeps its own copy. The step count is a
Python int, so no update reads the device.

Ported: ``adamw`` (the MLPs), ``rowwise_adagrad`` (the embedding arena)
and ``partitioned`` (one rule per top-level key), at a constant learning
rate. ``sgd``, ``adafactor``, ``layerwise``, global-norm clipping and the
schedules come with LM training (ROADMAP Queue 1, item 16).
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple

import numpy as np
import torch


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Any]   # (grads, state, params) -> (params, state)


def tree_map(f, tree, *rest):
    """Apply ``f`` leaf by leaf over trees of one structure (dicts, lists,
    tuples; every other object is a leaf)."""
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


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    def init(params):
        return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                              params),
                "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                              params),
                "step": 0}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        # the bias corrections in f32, as the reference computes them
        t = np.float32(step)
        c1 = float(np.float32(1) - np.float32(b1) ** t)
        c2 = float(np.float32(1) - np.float32(b2) ** t)

        def upd(p, g, m, v):
            g32 = g.float()
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_((1 - b2) * g32.square())
            step_ = (m / c1) / (torch.sqrt(v / c2) + eps) \
                + weight_decay * p.float()
            p.sub_((lr * step_).to(p.dtype))
            return p

        new_params = tree_map(upd, params, grads, state["m"], state["v"])
        return new_params, {"m": state["m"], "v": state["v"], "step": step}

    return Optimizer(init, update)


def rowwise_adagrad(lr: float, eps: float = 1e-8) -> Optimizer:
    """One adaptive accumulator scalar per table *row* (paper-standard for
    embedding tables: state is rows x 1 instead of rows x dim)."""
    def init(params):
        return {"acc": tree_map(
            lambda p: torch.zeros(p.shape[:-1] + (1,), dtype=torch.float32,
                                  device=p.device), params),
            "step": 0}

    @torch.no_grad()
    def update(grads, state, params):
        def upd(p, g, a):
            g32 = g.float()
            a.add_(g32.square().mean(dim=-1, keepdim=True))
            p.sub_((lr * g32 / (torch.sqrt(a) + eps)).to(p.dtype))
            return p

        return (tree_map(upd, params, grads, state["acc"]),
                {"acc": state["acc"], "step": state["step"] + 1})

    return Optimizer(init, update)


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
