"""The port's training slice against the JAX reference: the segment
scatter-add, the kernels' backward passes, the row gradients, the train
step in both modes, the online trainer and the launcher, on the same
numpy inputs with the reference's params carried across.

The CUDA kernels run only on the card (``chip_smoke.py`` phase 4 holds
``sls_grad_table`` and the backward GEMMs against their plain versions
there); here every op runs its plain version.

Tolerances (fp32; XLA and torch sum in different orders):
  * int32 results (touched rows, unique ids) must match exactly;
  * the scatter-add: a row's <= ~10 terms of O(1) -> rtol=atol=1e-5;
  * gradients of gemm / interaction: K <= 64 products of O(1) ->
    rtol=atol=1e-5;
  * the train step, K = 5 steps on DLRM_SMOKE at lr 1e-2: per-step loss
    rtol=1e-5; params atol=5e-6. Row-wise Adagrad moves an arena row by
    up to ~10 lr = 0.1 per step, ~0.5 over the run, and two summation
    orders change that move by a few 1e-6 of itself (AdamW moves the MLP
    params ten times less).
Within the port, on the CPU, the sparse and the dense-gradient step add
the same terms in the same order, so they agree bit for bit.
"""
import dataclasses
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.dlrm import DLRM_SMOKE as J_CFG
from repro.core import dlrm as j_dlrm
from repro.data import DLRMSynthetic as JSynthetic
from repro.kernels import embedding_gather as j_eg
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.training import make_drifting_zipf
from repro.training import sparse_optim as j_so
from repro_torch.configs.dlrm import DLRM_HET_SMOKE
from repro_torch.configs.dlrm import DLRM_SMOKE as CFG
from repro_torch.core import dlrm as t_dlrm
from repro_torch.core import embedding_source as t_es
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as t_launch
from repro_torch.optim import tree_leaves
from repro_torch.training import OnlineTrainer, unique_padded
from repro_torch.training import sparse_optim as t_so

torch.set_num_threads(1)

MAX_L = 2 * CFG.lookups_per_table       # as the launcher sizes it
BATCH = 16
K_STEPS = 5
LR = 1e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_params(seed=0):
    return jax.tree.map(np.asarray, j_dlrm.init(jax.random.PRNGKey(seed),
                                                J_CFG))


def _batches(k, seed=3, b=BATCH):
    data = JSynthetic(J_CFG, seed=seed)
    return [data.ragged_batch(b, max_l=MAX_L,
                              pad_to=b * CFG.n_tables * MAX_L)
            for _ in range(k)]


_KEYS = ("dense", "indices", "offsets", "labels")


# ---------------------------------------------------------------------------
# the segment scatter-add (plain version) against the Pallas kernel
# ---------------------------------------------------------------------------

def _scatter_case(name):
    """(g, indices, offsets, n_rows): duplicates, empty bags, a padded
    tail, no ids at all, and one long run."""
    rng = np.random.RandomState(len(name))
    if name == "duplicates":
        off = np.array([0, 3, 7, 9], np.int32)
        idx = np.array([4, 4, 1, 4, 0, 1, 4, 2, 4], np.int32)
        n_rows = 6
    elif name == "empty_bags":
        off = np.array([0, 0, 2, 2, 5, 5], np.int32)
        idx = np.array([7, 3, 3, 0, 7], np.int32)
        n_rows = 9
    elif name == "padded_tail":
        off = np.array([0, 2, 4, 5], np.int32)
        idx = np.array([1, 2, 2, 5, 1, 5, 5, 0, 0, 1], np.int32)
        n_rows = 7
    elif name == "no_ids":
        off = np.zeros(4, np.int32)
        idx = np.zeros(0, np.int32)
        n_rows = 5
    else:                                  # long_run: a Zipf-hot row
        lens = rng.randint(0, 9, 12)
        off = np.zeros(13, np.int32)
        np.cumsum(lens, out=off[1:])
        idx = np.where(rng.rand(off[-1] + 4) < 0.7, 3,
                       rng.randint(0, 20, off[-1] + 4)).astype(np.int32)
        n_rows = 20
    g = rng.randn(len(off) - 1, 8).astype(np.float32)
    return g, idx, off, n_rows


_SCATTER_CASES = ["duplicates", "empty_bags", "padded_tail", "no_ids",
                  "long_run"]


@pytest.mark.parametrize("name", _SCATTER_CASES)
def test_sls_grad_table_plain_matches_jax(name):
    g, idx, off, n_rows = _scatter_case(name)
    got = ref.sls_grad_table(_t(g), _t(idx), _t(off), n_rows)
    assert got.dtype == torch.float32 and got.shape == (n_rows, 8)
    args = (jnp.asarray(g), jnp.asarray(idx), jnp.asarray(off))
    for want in (j_eg.sls_grad_table(*args, n_rows=n_rows, interpret=True),
                 j_ref.sls_grad_table(*args, n_rows)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", _SCATTER_CASES)
def test_sls_grad_table_sums_in_position_order(name):
    """Each row is the sum of its positions' bag gradients in ascending
    position order, bit for bit: the order the CUDA kernel keeps."""
    g, idx, off, n_rows = _scatter_case(name)
    want = np.zeros((n_rows, g.shape[1]), np.float32)
    seg = np.searchsorted(off[1:], np.arange(len(idx)), side="right")
    for p in range(int(off[-1])):
        want[idx[p]] = want[idx[p]] + g[seg[p]]
    got = ops.sls_grad_table(_t(g), _t(idx), _t(off), n_rows=n_rows)
    np.testing.assert_array_equal(got.numpy(), want)
    pinned = ops.sls_grad_table(_t(g), _t(idx), _t(off), n_rows=n_rows,
                                skip_row=int(idx[0]) if len(idx) else 0)
    want[idx[0] if len(idx) else 0] = 0.0
    np.testing.assert_array_equal(pinned.numpy(), want)


# ---------------------------------------------------------------------------
# backward passes of the three ported kernels against jax.grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(16, 13, 64), (16, 64, 1), (5, 22, 7)])
def test_gemm_grad_matches_jax(m, k, n):
    rng = np.random.RandomState(m + k + n)
    x, w, gy = (rng.randn(*s).astype(np.float32)
                for s in ((m, k), (k, n), (m, n)))
    tx = _t(x).requires_grad_()
    tw = _t(w).requires_grad_()
    ops.gemm(tx, tw).backward(_t(gy))
    jdx, jdw = jax.grad(lambda a, b: jnp.sum(j_ops.gemm(a, b) * gy),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-5)
    # dx is skipped where nothing needs it (the bottom MLP's input)
    tw2 = _t(w).requires_grad_()
    ops.gemm(_t(x), tw2).backward(_t(gy))
    np.testing.assert_array_equal(tw2.grad.numpy(), tw.grad.numpy())


@pytest.mark.parametrize("null_row", [None, 39])
def test_fused_segment_sum_grad_matches_jax(null_row):
    rng = np.random.RandomState(7)
    v, d, b, l = 40, 16, 6, 5
    table = rng.randn(v, d).astype(np.float32)
    table[v - 1] = 0.0
    ids = rng.randint(0, v - 1, (b, l)).astype(np.int32)
    ids[:, 3:] = v - 1                       # short bags -> the null row
    ids[0, 0] = ids[1, 1] = 2                # duplicates across bags
    gy = rng.randn(b, d).astype(np.float32)
    tt = _t(table).requires_grad_()
    ops.fused_segment_sum(tt, _t(ids), null_row=null_row).backward(_t(gy))
    want = jax.grad(lambda t: jnp.sum(
        j_ops.fused_segment_sum(t, jnp.asarray(ids), null_row=null_row)
        * gy))(jnp.asarray(table))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if null_row is not None:
        assert not tt.grad[null_row].any()          # exactly 0
    else:
        assert tt.grad[v - 1].abs().sum() > 0


@pytest.mark.parametrize("b,f,d", [(4, 4, 16), (3, 6, 32)])
def test_interaction_tril_grad_matches_jax(b, f, d):
    rng = np.random.RandomState(b * f)
    x = rng.randn(b, f, d).astype(np.float32)
    gy = rng.randn(b, f * (f - 1) // 2).astype(np.float32)
    tx = _t(x).requires_grad_()
    ops.interaction_tril(tx).backward(_t(gy))
    want = jax.grad(lambda a: jnp.sum(j_ops.interaction_tril(a) * gy))(
        jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# row gradients of the sparse step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keys", [[5, 1, 5, 9, 1, 1], [9, 9, 9], [3], [],
                                  [0, 7, 2, 9, 4]])
def test_unique_padded_matches_jnp_unique(keys):
    k = np.asarray(keys, np.int32)
    rows, inv = unique_padded(_t(k), 9)
    want_rows, want_inv = jnp.unique(jnp.asarray(k), size=len(k),
                                     fill_value=9, return_inverse=True)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    np.testing.assert_array_equal(inv.numpy(),
                                  np.asarray(want_inv).reshape(-1))


@pytest.mark.parametrize("dist", ["fixed", "uniform", "poisson"])
def test_ragged_row_grads_match_jax(dist):
    rb = JSynthetic(J_CFG, seed=5).ragged_batch(
        6, dist=dist, mean_l=3, max_l=MAX_L, pad_to=6 * CFG.n_tables * MAX_L)
    n_bags = len(rb["offsets"]) - 1
    d_bags = np.random.RandomState(1).randn(n_bags, CFG.emb_dim).astype(
        np.float32)
    spec_t, spec_j = t_dlrm.arena_spec(CFG), j_dlrm.arena_spec(J_CFG)
    rows, grads = t_so.source_row_grads(spec_t, _t(d_bags),
                                        _t(rb["indices"]), _t(rb["offsets"]))
    jrows, jgrads = j_so.source_row_grads(
        spec_j, jnp.asarray(d_bags), jnp.asarray(rb["indices"]),
        jnp.asarray(rb["offsets"]))
    assert rows.dtype == torch.int32
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_allclose(grads.numpy(), np.asarray(jgrads), rtol=1e-5,
                               atol=1e-5)


def test_ragged_row_grads_zero_the_fill_row():
    """A valid position that targets the fill row adds nothing."""
    idx = np.array([2, 7, 2, 7, 1, 0], np.int32)
    off = np.array([0, 2, 4, 5], np.int32)
    d = np.arange(12, dtype=np.float32).reshape(3, 4) + 1
    rows, grads = t_so.ragged_row_grads(_t(d), _t(idx), _t(off), fill_row=7)
    jrows, jgrads = j_so.ragged_row_grads(jnp.asarray(d), jnp.asarray(idx),
                                          jnp.asarray(off), fill_row=7)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(grads.numpy(), np.asarray(jgrads))
    assert not grads[rows == 7].any()


def test_row_grads_equal_the_dense_gradient_bitwise():
    """The O(N) row gradients are the touched rows of the (V, D) gradient
    that autograd scatters through lookup_bags, bit for bit: both add each
    row's positions in the same order."""
    rb = _batches(1, seed=6)[0]
    spec = t_dlrm.arena_spec(CFG)
    arena = _t(_np_params()["arena"]).requires_grad_()
    idx, off = _t(rb["indices"]), _t(rb["offsets"])
    emb = t_es.lookup_bags(t_es.FpArena(arena), spec, idx, off, max_l=MAX_L)
    d_emb = torch.randn(emb.shape, generator=torch.Generator().manual_seed(0))
    emb.backward(d_emb)
    rows, grads = t_so.source_row_grads(
        spec, d_emb.reshape(-1, spec.dim), idx, off)
    real = rows != spec.null_row
    np.testing.assert_array_equal(grads[real].numpy(),
                                  arena.grad[rows[real].long()].numpy())
    untouched = torch.ones(spec.total_rows, dtype=torch.bool)
    untouched[rows.long()] = False
    assert not arena.grad[untouched].any()
    assert not arena.grad[spec.null_row].any()


# ---------------------------------------------------------------------------
# the train step, both modes, against the JAX step
# ---------------------------------------------------------------------------

def _j_trajectory(np_params, batches, sparse):
    opt, step = j_dlrm.make_train_step_ragged(J_CFG, max_l=MAX_L, lr=LR,
                                              sparse=sparse)
    params = jax.tree.map(jnp.asarray, np_params)
    state = opt.init(params)
    step = jax.jit(step)
    losses, rows = [], []
    for b in batches:
        params, state, loss, r = step(params, state, {
            k: jnp.asarray(b[k]) for k in _KEYS})
        losses.append(float(loss))
        rows.append(np.asarray(r))
    return jax.tree.map(np.asarray, params), losses, rows


def _t_trajectory(np_params, batches, sparse):
    opt, step = t_dlrm.make_train_step_ragged(CFG, max_l=MAX_L, lr=LR,
                                              sparse=sparse)
    params = t_dlrm.params_from_numpy(np_params, "cpu")   # a fresh copy
    state = opt.init(params)
    losses, rows = [], []
    for b in batches:
        params, state, loss, r = step(params, state,
                                      {k: _t(b[k]) for k in _KEYS})
        losses.append(float(loss))
        rows.append(r.numpy())
    return params, losses, rows


@pytest.mark.parametrize("sparse", [True, False])
def test_train_step_matches_jax_over_k_steps(sparse):
    np_params = _np_params()
    batches = _batches(K_STEPS)
    j_params, j_losses, j_rows = _j_trajectory(np_params, batches, sparse)
    t_params, t_losses, t_rows = _t_trajectory(np_params, batches, sparse)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    for tr, jr in zip(t_rows, j_rows):
        assert tr.dtype == np.int32
        np.testing.assert_array_equal(tr, jr)
    for key in ("bottom", "top", "arena"):
        for got, want in zip(tree_leaves(t_params[key]),
                             jax.tree.leaves(j_params[key])):
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-6)
    # the params moved, and the null row stayed zero
    assert np.abs(j_params["arena"] - np_params["arena"]).max() > 1e-3
    assert not t_params["arena"][t_dlrm.arena_spec(CFG).null_row].any()


def test_sparse_and_dense_steps_agree_bitwise():
    """One step of each mode from the same params: the same touched rows
    and, on the CPU, the same bits everywhere (the dense row-wise Adagrad
    leaves untouched rows alone since their gradient is zero)."""
    np_params = _np_params(seed=4)
    batches = _batches(2, seed=8)
    sp, sl, sr = _t_trajectory(np_params, batches, sparse=True)
    dp, dl, dr = _t_trajectory(np_params, batches, sparse=False)
    assert sl == dl
    for a, b in zip(sr, dr):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tree_leaves(sp), tree_leaves(dp)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_train_step_updates_in_place():
    params = t_dlrm.params_from_numpy(_np_params(), "cpu")
    arena = params["arena"]
    before = arena.clone()
    opt, step = t_dlrm.make_train_step_ragged(CFG, max_l=MAX_L)
    new, _, _, _ = step(params, opt.init(params),
                        {k: _t(v) for k, v in _batches(1)[0].items()
                         if k in _KEYS})
    assert new["arena"] is arena and not torch.equal(arena, before)


@pytest.mark.parametrize("kw,item", [({"sharded": True}, "item 13"),
                                     ({"mesh": object()}, "item 13")])
def test_sharded_training_is_refused(kw, item):
    """Sharded training is ported (item 13, across ranks in
    tests/test_torch_sharded_dist.py); it is refused without a mesh, and
    a mesh must be the port's ``launch.mesh.Mesh``."""
    err, match = {"sharded": (ValueError, "needs a mesh"),
                  "mesh": (TypeError, "Mesh")}[next(iter(kw))]
    with pytest.raises(err, match=match):
        t_dlrm.make_train_step_ragged(CFG, max_l=MAX_L, **kw)


def test_heterogeneous_training_is_refused():
    """Group train steps are ported; sharded group training is refused
    in the reference's words, and OnlineTrainer refuses a group, naming
    OnlineGroupTrainer, which trains one."""
    from repro_torch.launch.mesh import Mesh
    het = dataclasses.replace(CFG, table_rows=(10, 20, 30),
                              table_dims=(4, 8, 16))
    for sparse in (True, False):
        with pytest.raises(ValueError, match="heterogeneous table group"):
            t_dlrm.make_train_step_ragged(
                het, max_l=MAX_L, sparse=sparse,
                mesh=Mesh((("model", None, 0, 2),)))
    params = t_dlrm.init(torch.Generator().manual_seed(0), het,
                         device="cpu")
    with pytest.raises(ValueError, match="OnlineGroupTrainer"):
        OnlineTrainer(het, params, max_l=MAX_L, device="cpu")


# ---------------------------------------------------------------------------
# online trainer and launcher
# ---------------------------------------------------------------------------

def test_online_trainer_lowers_the_loss():
    """As tests/test_training.py's dense-grad baseline does for the
    reference: 15 steps on a drifting Zipf stream lower the loss."""
    params = t_dlrm.params_from_numpy(_np_params(), "cpu")
    trainer = OnlineTrainer(CFG, params, max_l=5, lr=LR, device="cpu")
    gen = make_drifting_zipf(J_CFG, batch_size=32, mean_l=3, max_l=5,
                             seed=2)
    losses = trainer.train(next(gen) for _ in range(15))
    assert trainer.steps == 15 and len(losses) == 15
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_online_trainer_matches_the_train_step():
    np_params = _np_params()
    batches = _batches(3)
    trainer = OnlineTrainer(CFG, t_dlrm.params_from_numpy(np_params, "cpu"),
                            max_l=MAX_L, lr=LR, sparse=False, device="cpu")
    trainer.train(batches)
    params, losses, _ = _t_trajectory(np_params, batches, sparse=False)
    assert trainer.losses == losses
    for a, b in zip(tree_leaves(trainer.params), tree_leaves(params)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("kw", [{"cfg": DLRM_HET_SMOKE}])
def test_online_trainer_refuses_what_is_not_ported(kw):
    """A heterogeneous table group trains through OnlineGroupTrainer
    (tests/test_torch_group_online.py), which OnlineTrainer names when it
    refuses one (telemetry, once refused here, is ported:
    tests/test_torch_obs.py)."""
    cfg = kw["cfg"]
    params = t_dlrm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(ValueError, match="OnlineGroupTrainer"):
        OnlineTrainer(cfg, params, max_l=MAX_L, device="cpu")


def test_trainer_and_launcher_run_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = t_dlrm.params_from_numpy(_np_params(), "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OnlineTrainer(CFG, params, max_l=MAX_L)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_launch.main(["--smoke", "--ragged", "--steps", "1"])


@pytest.mark.parametrize("dense_grads", [False, True])
def test_launcher_smoke_on_cpu(dense_grads):
    argv = ["--smoke", "--ragged", "--device", "cpu", "--steps", "4",
            "--log-every", "2", "--batch-size", "8"]
    out = io.StringIO()
    with redirect_stdout(out):
        loss = t_launch.main(argv + (["--dense-grads"] if dense_grads
                                     else []))
    lines = out.getvalue().splitlines()
    assert [ln.split()[:2] for ln in lines[:2]] == [["step", "0"],
                                                    ["step", "2"]]
    assert lines[-1] == f"final loss {loss:.4f}" and np.isfinite(loss)


def test_launcher_refuses_the_fixed_layout():
    """Without --ragged the launcher trains the fixed layout with the
    dense-gradient step, so it refuses --dense-grads there (the flag
    picks the ragged baseline) rather than drop it silently."""
    with pytest.raises(SystemExit):
        t_launch.main(["--smoke", "--device", "cpu", "--dense-grads"])
