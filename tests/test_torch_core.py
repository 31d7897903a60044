"""The port's configs, data, sparse layout, embedding source, dense engine
and DLRM model against the JAX reference, on the same numpy inputs and
the reference's params carried across with ``params_from_numpy``.

Tolerances (fp32; XLA and torch sum in different orders):
  * the int32 layout helpers (segment ids, dense ids, flattened ids) and
    the numpy data draws must match exactly;
  * reduced bags: <= 6 terms of ~1e-2 (arena init scale) -> atol=1e-6;
  * MLP and interaction outputs, logits: O(1) values through K <= 64
    products -> rtol=atol=1e-5; probabilities -> atol=1e-5.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm as j_cfgs
from repro.core import dense_engine as j_de
from repro.core import dlrm as j_dlrm
from repro.core import embedding_source as j_es
from repro.core import sparse_engine as j_se
from repro.data import DLRMSynthetic as JSynthetic
from repro_torch.configs import dlrm as t_cfgs
from repro_torch.core import dense_engine as t_de
from repro_torch.core import dlrm as t_dlrm
from repro_torch.core import embedding_source as t_es
from repro_torch.core import sparse_engine as t_se
from repro_torch.data import DLRMSynthetic as TSynthetic

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CFG = t_cfgs.DLRM_SMOKE
J_CFG = j_cfgs.DLRM_SMOKE
MAX_L = 6


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, j_dlrm.init(jax.random.PRNGKey(0), J_CFG))


@pytest.fixture(scope="module")
def params(np_params):
    return t_dlrm.params_from_numpy(np_params, "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _ragged(dist, seed=3, b=8):
    return JSynthetic(J_CFG, seed=seed).ragged_batch(
        b, dist=dist, mean_l=3, max_l=MAX_L, pad_to=b * CFG.n_tables * MAX_L)


# ---------------------------------------------------------------------------
# configs and data: copies, not imports, so they are checked field for field
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(j_cfgs.DLRM_CONFIGS) + ["smoke"])
def test_configs_match_reference(name):
    j = j_cfgs.DLRM_SMOKE if name == "smoke" else j_cfgs.DLRM_CONFIGS[name]
    t = t_cfgs.DLRM_SMOKE if name == "smoke" else t_cfgs.DLRM_CONFIGS[name]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.n_interact_features, t.table_bytes, t.resolved_table_rows) == \
        (j.n_interact_features, j.table_bytes, j.resolved_table_rows)
    assert t_dlrm.top_mlp_in_dim(t) == j_dlrm.top_mlp_in_dim(j)


@pytest.mark.parametrize("kind,dist", [("batch", None), ("ragged", "fixed"),
                                       ("ragged", "uniform"),
                                       ("ragged", "poisson")])
def test_synthetic_draws_bit_identical(kind, dist):
    j, t = JSynthetic(J_CFG, seed=11), TSynthetic(CFG, seed=11)
    for _ in range(2):              # the generator state advances alike
        if kind == "batch":
            jb, tb = j.batch(5), t.batch(5)
        else:
            jb = j.ragged_batch(5, dist=dist, mean_l=3, max_l=MAX_L,
                                pad_to=5 * CFG.n_tables * MAX_L)
            tb = t.ragged_batch(5, dist=dist, mean_l=3, max_l=MAX_L,
                                pad_to=5 * CFG.n_tables * MAX_L)
        assert jb.keys() == tb.keys()
        for k in jb:
            np.testing.assert_array_equal(np.asarray(jb[k]), np.asarray(tb[k]))
            assert np.asarray(jb[k]).dtype == np.asarray(tb[k]).dtype


@pytest.mark.parametrize("name,n_bytes", [("dlrm1", 1_211_524),
                                          ("dlrm6", 4_520_068)])
def test_mlp_weights_are_not_table_one_sizes(name, n_bytes):
    """The reference's configs/dlrm.py docstring gives Table I's MLP
    sizes (57.4 KB, 557 KB), but its widths hold 302,881 and 1,130,017
    fp32 parameters. Both packages build the same widths."""
    shapes = jax.eval_shape(lambda: j_dlrm.init(jax.random.PRNGKey(0),
                                                j_cfgs.DLRM_CONFIGS[name]))
    ref_bytes = 4 * sum(int(np.prod(a.shape)) for part in ("bottom", "top")
                        for a in jax.tree.leaves(shapes[part]))
    small = dataclasses.replace(t_cfgs.DLRM_CONFIGS[name], rows_per_table=1)
    t = t_dlrm.init(torch.Generator().manual_seed(0), small, device="cpu")
    port_bytes = 4 * sum(p.numel() for part in ("bottom", "top")
                         for layer in t[part] for p in layer)
    assert ref_bytes == port_bytes == n_bytes


def test_feature_interaction_width_is_d_plus_pairs():
    """The reference's dense_engine.feature_interaction docstring says it
    returns (B, F*D'); it returns ((B, D + F(F-1)/2), feats)."""
    b, t, d = 3, CFG.n_tables, CFG.emb_dim
    f = t + 1
    x, feats = j_de.feature_interaction(jnp.ones((b, d)),
                                        jnp.ones((b, t, d)))
    assert x.shape == (b, d + f * (f - 1) // 2) != (b, f * d)
    assert feats.shape == (b, f, d)
    px, pfeats = t_de.feature_interaction(torch.ones(b, d),
                                          torch.ones(b, t, d))
    assert tuple(px.shape) == x.shape and tuple(pfeats.shape) == feats.shape


def test_heterogeneous_configs_are_refused():
    het = dataclasses.replace(CFG, table_rows=(10, 20, 30),
                              table_dims=(4, 8, 16))
    with pytest.raises(NotImplementedError, match="Queue 1, item 8"):
        TSynthetic(het)
    with pytest.raises(NotImplementedError, match="Queue 1, item 8"):
        t_dlrm.arena_spec(het)


# ---------------------------------------------------------------------------
# sparse engine: arena layout and the ragged relayout (exact, int32)
# ---------------------------------------------------------------------------

def test_arena_spec_matches_reference():
    j, t = j_dlrm.arena_spec(J_CFG), t_dlrm.arena_spec(CFG)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.total_rows, t.null_row) == (j.total_rows, j.null_row)


def test_init_arena_zero_null_row():
    spec = t_dlrm.arena_spec(CFG)
    arena = t_se.init_arena(torch.Generator().manual_seed(0), spec)
    assert arena.shape == (spec.total_rows, spec.dim)
    assert arena.dtype == torch.float32
    assert not arena[spec.null_row].any()
    assert 0.005 < arena[:spec.null_row].std().item() < 0.02   # scale 0.01


def _layout_cases():
    """(indices, offsets) streams: empty bags, padded tails, no ids."""
    cases = [(_ragged("uniform")["indices"], _ragged("uniform")["offsets"]),
             (_ragged("poisson", seed=5)["indices"],
              _ragged("poisson", seed=5)["offsets"])]
    off = np.array([0, 0, 2, 2, 2, 5, 5], np.int32)          # empty bags
    cases.append((np.array([7, 8, 9, 1, 2, 0, 0, 0], np.int32), off))
    cases.append((np.zeros(0, np.int32), np.zeros(7, np.int32)))  # no ids
    return cases


@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("max_l", [MAX_L, 0])
def test_ragged_dense_ids_exact(case, max_l):
    idx, off = _layout_cases()[case]
    fill = 999
    got = t_se.ragged_dense_ids(_t(idx), _t(off), max_l=max_l, fill=fill)
    want = j_se.ragged_dense_ids(jnp.asarray(idx), jnp.asarray(off),
                                 max_l=max_l, fill=fill)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", range(4))
def test_flatten_and_segment_ids_exact(case):
    idx, off = _layout_cases()[case]
    spec_t, spec_j = t_dlrm.arena_spec(CFG), j_dlrm.arena_spec(J_CFG)
    got = t_se.flatten_ragged_indices(spec_t, _t(idx), _t(off))
    want = j_se.flatten_ragged_indices(spec_j, jnp.asarray(idx),
                                       jnp.asarray(off))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    n = len(idx)
    np.testing.assert_array_equal(
        t_se.ragged_segment_ids(_t(off), n).numpy(),
        np.asarray(j_se.ragged_segment_ids(jnp.asarray(off), n)))
    for g, w in zip(t_se.ragged_position_tables(_t(off), n, CFG.n_tables),
                    j_se.ragged_position_tables(jnp.asarray(off), n,
                                                CFG.n_tables)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# embedding source, dense engine, model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dist", ["fixed", "uniform", "poisson"])
def test_lookup_bags_matches_reference(np_params, params, dist):
    rb = _ragged(dist)
    got = t_es.lookup_bags(t_es.FpArena(params["arena"]),
                           t_dlrm.arena_spec(CFG), _t(rb["indices"]),
                           _t(rb["offsets"]), max_l=MAX_L)
    want = j_es.lookup_bags(j_es.FpArena(jnp.asarray(np_params["arena"])),
                            j_dlrm.arena_spec(J_CFG),
                            jnp.asarray(rb["indices"]),
                            jnp.asarray(rb["offsets"]), max_l=MAX_L)
    assert got.shape == (8, CFG.n_tables, CFG.emb_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_mlp_apply_matches_reference(np_params, params):
    x = np.random.RandomState(2).randn(9, CFG.dense_features).astype(
        np.float32)
    for name in ("bottom", "top"):
        xin = x if name == "bottom" else np.random.RandomState(3).randn(
            9, t_dlrm.top_mlp_in_dim(CFG)).astype(np.float32)
        got = t_de.mlp_apply(params[name], _t(xin))
        want = j_de.mlp_apply([tuple(map(jnp.asarray, p))
                               for p in np_params[name]], jnp.asarray(xin))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_feature_interaction_matches_reference():
    rng = np.random.RandomState(4)
    bot = rng.randn(5, CFG.emb_dim).astype(np.float32)
    emb = rng.randn(5, CFG.n_tables, CFG.emb_dim).astype(np.float32)
    got_x, got_f = t_de.feature_interaction(_t(bot), _t(emb))
    want_x, want_f = j_de.feature_interaction(jnp.asarray(bot),
                                              jnp.asarray(emb))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))


@pytest.mark.parametrize("dist", ["fixed", "uniform", "poisson"])
def test_forward_ragged_matches_reference(np_params, params, dist):
    rb = _ragged(dist, seed=21)
    got = t_dlrm.forward_ragged(params, CFG, _t(rb["dense"]),
                                _t(rb["indices"]), _t(rb["offsets"]),
                                max_l=MAX_L)
    want = j_dlrm.forward_ragged(
        jax.tree.map(jnp.asarray, np_params), J_CFG,
        jnp.asarray(rb["dense"]), jnp.asarray(rb["indices"]),
        jnp.asarray(rb["offsets"]), max_l=MAX_L)
    assert got.shape == (8,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_ragged_serve_step_matches_reference(np_params, params):
    rb = _ragged("poisson", seed=8)
    step = t_dlrm.make_ragged_serve_step(CFG, max_l=MAX_L)
    got = step(params, {k: _t(rb[k]) for k in ("dense", "indices",
                                               "offsets")})
    assert got.is_inference()
    want = j_dlrm.make_ragged_serve_step(J_CFG, max_l=MAX_L)(
        jax.tree.map(jnp.asarray, np_params),
        {k: jnp.asarray(rb[k]) for k in ("dense", "indices", "offsets")})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_params_from_numpy_round_trips(np_params, params):
    back = jax.tree.map(np.asarray, {
        "bottom": [(w.numpy(), b.numpy()) for w, b in params["bottom"]],
        "top": [(w.numpy(), b.numpy()) for w, b in params["top"]],
        "arena": params["arena"].numpy()})
    jax.tree.map(np.testing.assert_array_equal, back,
                 jax.tree.map(np.asarray, {k: np_params[k] for k in back}))


def test_init_matches_reference_structure(np_params):
    t = t_dlrm.init(torch.Generator().manual_seed(0), CFG, device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), np_params)
    assert jax.tree.map(lambda a: tuple(a.shape), {
        "bottom": [tuple(p) for p in t["bottom"]],
        "top": [tuple(p) for p in t["top"]], "arena": t["arena"]},
        is_leaf=lambda a: isinstance(a, torch.Tensor)) == shapes
    assert not t["arena"][t_dlrm.arena_spec(CFG).null_row].any()


# ---------------------------------------------------------------------------
# guards: the entry points run on the card; the port imports no JAX
# ---------------------------------------------------------------------------

def test_entry_points_refuse_to_run_on_the_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_dlrm.init(torch.Generator().manual_seed(0), CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_dlrm.params_from_numpy({"bottom": [], "top": [],
                                  "arena": np.zeros((2, 2), np.float32)})


def test_init_generator_must_match_device():
    with pytest.raises(ValueError, match="generator"):
        t_dlrm.init(torch.Generator().manual_seed(0), CFG, device="meta")


def test_port_imports_neither_jax_nor_the_reference():
    code = ("import sys\n"
            "import repro_torch, repro_torch.serving, repro_torch.data\n"
            "import repro_torch.core.dlrm, repro_torch.kernels.ops\n"
            "import repro_torch.kernels._build\n"
            "import repro_torch.optim, repro_torch.training.sparse_optim\n"
            "import repro_torch.training.online, repro_torch.launch.train\n"
            "import repro_torch.kernels.embedding_gather\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
