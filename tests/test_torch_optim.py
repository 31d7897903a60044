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


# ---------------------------------------------------------------------------
# the LM optimizers: sgd, adafactor, layerwise, schedules, clipping,
# from_config (tolerances as above, fp32; the bf16 pin is exact)
# ---------------------------------------------------------------------------

def test_sgd_matches_jax():
    t_state, j_state = _run(t_optim.sgd(LR), j_optim.sgd(LR))
    assert t_state["step"] == int(j_state["step"]) == 2
    _assert_close(t_state["mu"], j_state["mu"])


@pytest.mark.parametrize("sub", ["bottom", "arena"],
                         ids=["factored_and_not", "factored"])
def test_adafactor_matches_jax(sub):
    """``bottom`` holds a (13, 8) matrix (factored: vr, vc) and an (8,)
    bias (not: v); ``arena`` one (30, 4) matrix."""
    t_state, j_state = _run(t_optim.adafactor(LR), j_optim.adafactor(LR),
                            n_updates=3, sub=sub)
    assert t_state["step"] == int(j_state["step"]) == 3
    _assert_close(t_state["fac"], j_state["fac"], rtol=1e-5, atol=1e-9)


def test_adamw_with_a_schedule_matches_jax():
    sched = (t_optim.warmup_cosine(LR, 2, 6), j_optim.warmup_cosine(LR, 2, 6))
    _run(t_optim.adamw(sched[0]), j_optim.adamw(sched[1]), n_updates=4)


def test_warmup_cosine_matches_jax():
    for args in ((3e-4, 10, 100), (1.0, 0, 50, 0.0), (2e-3, 7, 7)):
        t_s, j_s = t_optim.warmup_cosine(*args), j_optim.warmup_cosine(*args)
        got = np.array([t_s(s) for s in range(0, 120)])
        want = np.array([float(j_s(jnp.int32(s))) for s in range(0, 120)])
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_bf16_adamw_rounds_once():
    """The reference computes the new value in f32 and rounds it once:
    1.0 - 1.934e-3 * (1 + 0.01) rounds to 0.99609375 in bf16. Rounding
    the update to bf16 first and then the difference gave 1.0."""
    for lr in (1.934e-3, 5.8e-3):
        p = {"w": torch.ones(1, dtype=torch.bfloat16)}
        opt = t_optim.adamw(lr)
        new, _ = opt.update({"w": torch.ones(1, dtype=torch.bfloat16)},
                            opt.init(p), p)
        j_opt = j_optim.adamw(lr)
        jp = {"w": jnp.ones(1, jnp.bfloat16)}
        want, _ = j_opt.update({"w": jnp.ones(1, jnp.bfloat16)},
                               j_opt.init(jp), jp)
        assert new["w"].item() == float(want["w"][0]) == 0.99609375


def test_fp32_leaves_keep_their_bits():
    """On fp32 leaves the one-rounding form is the in-place subtraction
    the DLRM steps always took: the same bits."""
    params = _torch(_tree(0))
    grads = _torch(_tree(1))
    new, _ = t_optim.adamw(LR).update(grads, t_optim.adamw(LR).init(params),
                                      t_optim.tree_map(torch.clone, params))
    for p, g, n in zip(t_optim.tree_leaves(params), t_optim.tree_leaves(grads),
                       t_optim.tree_leaves(new)):
        g32 = g.float()
        m, v = 0.1 * g32, 0.05 * g32.square()
        c1 = float(np.float32(1) - np.float32(0.9))
        c2 = float(np.float32(1) - np.float32(0.95))
        step_ = (m / c1) / (torch.sqrt(v / c2) + 1e-8) + 0.01 * p
        want = p.clone().sub_((LR * step_).to(p.dtype))
        assert torch.equal(n, want)


def _lm_tree(seed, norms=True, n_layers=8, d=6, f=5):
    """An LM-shaped tree: a vocab table, a layer stack of ``n_layers``
    ((L, d, f) and (L, f, d) matrices, with ``norms`` an (L, d) weight)
    and a final norm."""
    rng = np.random.RandomState(seed)
    layers = {"w1": rng.randn(n_layers, d, f).astype(np.float32),
              "w2": rng.randn(n_layers, f, d).astype(np.float32)}
    if norms:
        layers["ln"] = {"w": rng.randn(n_layers, d).astype(np.float32)}
    return {"embed": rng.randn(40, d).astype(np.float32), "layers": layers,
            "ln_f": {"w": rng.randn(d).astype(np.float32)}}


def _run_lm(t_opt, j_opt, norms, n_updates=3):
    t_p, j_p = _torch(_lm_tree(0, norms)), _jax(_lm_tree(0, norms))
    t_s, j_s = t_opt.init(t_p), j_opt.init(j_p)
    for i in range(n_updates):
        g = _lm_tree(i + 1, norms)
        t_p, t_s = t_opt.update(_torch(g), t_s, t_p)
        j_p, j_s = j_opt.update(_jax(g), j_s, j_p)
        _assert_close(t_p, j_p, rtol=1e-5, atol=1e-7)
    assert t_s["step"] == int(j_s["step"]) == n_updates
    return t_p, j_p


@pytest.mark.parametrize("norms", [True, False],
                         ids=["with_norms", "matrices_only"])
@pytest.mark.parametrize("inner", ["adamw", "adafactor"])
def test_layerwise_matches_jax(inner, norms):
    """layerwise over 8 stacked layers. Under Adafactor a stacked norm
    weight (L, d) has vc of shape (d,), so the ``layers`` subtree's state
    leaves do not share the dim L and the whole subtree updates directly,
    in both packages; without norms it is taken a layer at a time."""
    make = {"adamw": lambda m: m.adamw(LR),
            "adafactor": lambda m: m.adafactor(LR)}[inner]
    _run_lm(t_optim.layerwise(make(t_optim)), j_optim.layerwise(make(j_optim)),
            norms)


@pytest.mark.parametrize("norms", [True, False],
                         ids=["with_norms", "matrices_only"])
def test_layerwise_adafactor_clips_per_layer(norms):
    """Adafactor's RMS clip is taken per leaf, so a layer at a time when
    the stack is scanned: layerwise then differs from the direct update,
    and equals it when the norms keep the stack unscanned."""
    g = _torch(_lm_tree(1, norms))
    outs = []
    for opt in (t_optim.layerwise(t_optim.adafactor(LR)),
                t_optim.adafactor(LR)):
        p = _torch(_lm_tree(0, norms))
        p, _ = opt.update(g, opt.init(p), p)
        outs.append(p["layers"])
    same = all(torch.equal(a, b) for a, b in zip(
        t_optim.tree_leaves(outs[0]), t_optim.tree_leaves(outs[1])))
    assert same == norms


def test_layerwise_leaves_short_stacks_and_single_leaves_direct():
    """Under 8 layers, or a single leaf (the vocab table), is updated
    directly: the same bits as the inner optimizer's update."""
    for n in (4, 8):
        g = _torch(_lm_tree(1, n_layers=n))
        got = _torch(_lm_tree(0, n_layers=n))
        want = _torch(_lm_tree(0, n_layers=n))
        lw, inner = t_optim.layerwise(t_optim.adamw(LR)), t_optim.adamw(LR)
        lw.update(g, lw.init(got), got)
        inner.update(g, inner.init(want), want)
        for a, b in zip(t_optim.tree_leaves(got), t_optim.tree_leaves(want)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("max_norm", [1e3, 0.5])
def test_clip_by_global_norm_matches_jax(max_norm):
    tree = _lm_tree(3)
    got, norm = t_optim.clip_by_global_norm(_torch(tree), max_norm)
    want, j_norm = j_optim.clip_by_global_norm(_jax(tree), max_norm)
    np.testing.assert_allclose(norm.item(), float(j_norm), rtol=1e-6)
    np.testing.assert_allclose(t_optim.global_norm(_torch(tree)).item(),
                               float(j_optim.global_norm(_jax(tree))),
                               rtol=1e-6)
    _assert_close(got, want, rtol=1e-6, atol=1e-7)
    assert isinstance(norm, torch.Tensor) and norm.dim() == 0


@pytest.mark.parametrize("name", ["sgd", "adamw", "adafactor"])
def test_from_config_matches_jax(name):
    from repro.configs.base import OptimizerConfig as JOptimizerConfig
    from repro_torch.configs.base import OptimizerConfig
    import dataclasses
    cfg = OptimizerConfig(name=name, lr=LR, beta2=0.99)
    j_cfg = JOptimizerConfig(name=name, lr=LR, beta2=0.99)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    assert dataclasses.asdict(OptimizerConfig()) == dataclasses.asdict(
        JOptimizerConfig())
    _run(t_optim.from_config(cfg), j_optim.from_config(j_cfg), sub="bottom")
    with pytest.raises(ValueError, match="unknown optimizer"):
        t_optim.from_config(OptimizerConfig(name="lion"))
