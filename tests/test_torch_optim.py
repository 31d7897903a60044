"""The port's optimizers against the reference's: one or two updates of
AdamW, row-wise Adagrad, the partitioned DLRM optimizer and the sparse
row-wise Adagrad, on the same numpy params and gradients.

Tolerances (fp32): an update moves a param by at most ~lr (AdamW) or
~lr * sqrt(D) (row-wise Adagrad); the two frameworks round the bias
corrections, square roots and divisions alike up to the order of the
operations, so params agree to rtol=1e-6, atol=1e-7 at lr 1e-2 and the
accumulators to rtol=1e-6. Within the port the sparse row-wise update
equals the dense one on the touched rows bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as j_optim
from repro.training import sparse_optim as j_so
from repro_torch import optim as t_optim
from repro_torch.configs.dlrm import DLRM_SMOKE as CFG
from repro_torch.core import dlrm as t_dlrm
from repro_torch.training import sparse_optim as t_so

torch.set_num_threads(1)

LR = 1e-2
TOL = dict(rtol=1e-6, atol=1e-7)


def _tree(seed):
    """A DLRM-shaped tree: two MLP layers and a small arena."""
    rng = np.random.RandomState(seed)
    return {"bottom": [(rng.randn(13, 8).astype(np.float32),
                        rng.randn(8).astype(np.float32))],
            "top": [(rng.randn(8, 1).astype(np.float32),
                     rng.randn(1).astype(np.float32))],
            "arena": rng.randn(30, 4).astype(np.float32)}


def _torch(tree):
    return t_optim.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_close(t_tree, j_tree, **tol):
    # jax.tree orders dict keys; torch tensors are leaves to it
    got = [a.numpy() for a in jax.tree.leaves(t_tree)]
    want = [np.asarray(a) for a in jax.tree.leaves(j_tree)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **(tol or TOL))


def _run(t_opt, j_opt, n_updates=2, sub=None):
    params = _tree(0) if sub is None else _tree(0)[sub]
    t_params, j_params = _torch(params), _jax(params)
    t_state, j_state = t_opt.init(t_params), j_opt.init(j_params)
    for i in range(n_updates):
        grads = _tree(i + 1) if sub is None else _tree(i + 1)[sub]
        t_params, t_state = t_opt.update(_torch(grads), t_state, t_params)
        j_params, j_state = j_opt.update(_jax(grads), j_state, j_params)
        _assert_close(t_params, j_params)
    return t_state, j_state


@pytest.mark.parametrize("sub", ["bottom", "top"])
def test_adamw_matches_jax(sub):
    t_state, j_state = _run(t_optim.adamw(LR), j_optim.adamw(LR), sub=sub)
    assert t_state["step"] == int(j_state["step"]) == 2
    _assert_close(t_state["m"], j_state["m"])
    _assert_close(t_state["v"], j_state["v"])


def test_rowwise_adagrad_matches_jax():
    t_state, j_state = _run(t_optim.rowwise_adagrad(LR),
                            j_optim.rowwise_adagrad(LR), sub="arena")
    assert t_state["acc"].shape == (30, 1)
    _assert_close(t_state["acc"], j_state["acc"])


def test_partitioned_dlrm_optimizer_matches_jax():
    t_state, j_state = _run(t_dlrm.make_optimizer(CFG, LR),
                            j_optim.partitioned(
                                {"arena": j_optim.rowwise_adagrad(LR * 10)},
                                j_optim.adamw(LR)))
    assert set(t_state) == {"bottom", "top", "arena"}
    _assert_close(t_state["arena"]["acc"], j_state["arena"]["acc"])


def test_updates_work_in_place():
    params = _torch(_tree(0))
    opt = t_dlrm.make_optimizer(CFG, LR)
    state = opt.init(params)
    leaves = t_optim.tree_leaves(params)
    new, _ = opt.update(_torch(_tree(1)), state, params)
    assert all(a is b for a, b in zip(t_optim.tree_leaves(new), leaves))


def _rows_case():
    rows = np.array([1, 4, 7, 9, 29, 29, 29], np.int32)   # 29 = fill row
    grads = np.random.RandomState(3).randn(7, 4).astype(np.float32)
    grads[4:] = 0.0
    return rows, grads


def test_sparse_rowwise_adagrad_matches_jax():
    rows, grads = _rows_case()
    arena = _tree(0)["arena"]
    arena[29] = 0.0
    t_opt, j_opt = t_so.sparse_rowwise_adagrad(LR), j_so.sparse_rowwise_adagrad(LR)
    t_arena, j_arena = torch.from_numpy(arena.copy()), jnp.asarray(arena)
    t_state, j_state = t_opt.init(t_arena), j_opt.init(j_arena)
    for _ in range(2):
        t_arena, t_state = t_opt.update(t_arena, t_state,
                                        torch.from_numpy(rows),
                                        torch.from_numpy(grads))
        j_arena, j_state = j_opt.update(j_arena, j_state, jnp.asarray(rows),
                                        jnp.asarray(grads))
    np.testing.assert_allclose(t_arena.numpy(), np.asarray(j_arena), **TOL)
    np.testing.assert_allclose(t_state["acc"].numpy(),
                               np.asarray(j_state["acc"]), **TOL)
    assert t_state["step"] == 2 and not t_arena[29].any()


def test_sparse_rowwise_adagrad_equals_dense_on_touched_rows():
    """Untouched rows see g = 0 in the dense update, which moves nothing:
    the two updates agree everywhere, bit for bit."""
    rows, grads = _rows_case()
    arena = _tree(0)["arena"]
    arena[29] = 0.0
    dense_g = np.zeros_like(arena)
    dense_g[rows[:4]] = grads[:4]
    sparse = t_so.sparse_rowwise_adagrad(LR)
    dense = t_optim.rowwise_adagrad(LR)
    s_arena = torch.from_numpy(arena.copy())
    d_arena = torch.from_numpy(arena.copy())
    s_state, d_state = sparse.init(s_arena), dense.init(d_arena)
    for _ in range(2):
        s_arena, s_state = sparse.update(s_arena, s_state,
                                         torch.from_numpy(rows),
                                         torch.from_numpy(grads))
        d_arena, d_state = dense.update(torch.from_numpy(dense_g), d_state,
                                        d_arena)
    np.testing.assert_array_equal(s_arena.numpy(), d_arena.numpy())
    np.testing.assert_array_equal(s_state["acc"].numpy(),
                                  d_state["acc"].numpy())
