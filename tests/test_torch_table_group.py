"""The port's table groups and heterogeneous DLRM against the JAX
reference, on shared numpy inputs with the reference's params carried
across (``params_from_numpy``), and the group laws within the port.

Against the reference: the config copies field by field, the
heterogeneous draws exactly, ``forward_ragged`` (interleaved and
per-table streams) and the fixed ``forward`` on a group, the group row
gradients, three sparse and three dense-gradient group train steps, the
per-table hit counts and trace histograms, the group engine's
probabilities and hit rates, and blobs across packages. Within the port,
bit for bit: the grouped lookup and its gradients against the per-table
loop over fp, cached, int8 and mixed members, the fixed layout against
the ragged one, a ``VersionedSource`` round trip, a ``replace_member``
swap served after ``adopt_source`` against a fresh engine.

Every op runs its plain version here (CPU tensors); the kernels are held
at these paths' shapes on the card by ``chip_smoke.py`` phase 12.

Tolerances (fp32; XLA and torch add in different orders):
  * int32 results (draws, touched rows, hit and lookup counts, trace
    histograms, int8 codes) exactly;
  * lookups: bags of <= 6 rows of O(1) -> atol=1e-5;
  * logits / probabilities: K <= 64 products of O(1) through a sigmoid
    -> rtol=atol=1e-5;
  * row gradients: a row's <= ~20 terms of O(1e-1) -> rtol=atol=1e-5;
  * train steps, 3 steps on DLRM_HET_SMOKE at lr 1e-2: per-step loss
    rtol=1e-5, params atol=5e-6 (as ``test_torch_training.py``: row-wise
    Adagrad moves a row by up to 10 lr a step, and two summation orders
    change that move by a few 1e-6 of itself);
  * within the port, on the CPU, torch.equal / np.array_equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm as j_cfgs
from repro.core import dlrm as j_dlrm
from repro.core import embedding_source as j_es
from repro.core import sparse_engine as j_se
from repro.data import DLRMSynthetic as JSynthetic
from repro.serving import RecEngine as JRecEngine
from repro.serving import requests_from_ragged_batch as j_requests
from repro.training import group_row_grads as j_group_row_grads
from repro_torch.configs import dlrm as t_cfgs
from repro_torch.core import dlrm as t_dlrm
from repro_torch.core import embedding_source as es
from repro_torch.core import sparse_engine as se
from repro_torch.data import DLRMSynthetic as TSynthetic
from repro_torch.optim import tree_leaves
from repro_torch.serving import RecEngine
from repro_torch.serving import requests_from_ragged_batch as t_requests
from repro_torch.training import (OnlineGroupTrainer, OnlineTrainer,
                                  VersionedSource, group_row_grads)

torch.set_num_threads(1)

HET = t_cfgs.DLRM_HET_SMOKE
J_HET = j_cfgs.DLRM_HET_SMOKE
# a narrow inventory drawn as dlrm_het2 is, cut to a test's size
NARROW = dict(seed=3, max_rows=2_000, bottom_mlp=(64, 16), top_mlp=(64, 1),
              emb_dim=16)
MAX_L = 6
LR = 1e-2

# (vocabs, dims): a vocab-1 table, a dim-1 table, a one-table group,
# uneven sizes (the reference suite's inventories)
INVENTORIES = (
    ((40, 7, 1), (8, 4, 1)),
    ((1, 300, 12), (1, 16, 8)),
    ((25,), (8,)),
    ((13, 13, 13, 13), (4, 8, 16, 2)),
)
KIND_PATTERNS = (("fp",), ("int8", "fp"), ("cached", "fp", "int8"),
                 ("cached_int8", "cached", "fp"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _specs_of(vocabs, dims):
    return tuple(se.ArenaSpec(1, v, d) for v, d in zip(vocabs, dims))


def _het_case(rng, vocabs, b, max_l, pad=0):
    """Interleaved (sample, table) ragged batch with the hard edges in: an
    empty bag, a full bag, a table whose every bag is empty while another
    is dense, a duplicate index and a padded tail."""
    t_count = len(vocabs)
    n_bags = b * t_count
    lens = rng.randint(0, max_l + 1, n_bags).astype(np.int32)
    if t_count > 1:
        lens[0::t_count] = 0
        lens[1::t_count] = max_l
    else:
        lens[0], lens[-1] = 0, max_l
    off = np.zeros(n_bags + 1, np.int32)
    np.cumsum(lens, out=off[1:])
    n = int(off[-1])
    seg = np.searchsorted(off[1:], np.arange(n), side="right")
    table = seg % t_count
    idx = np.empty(n, np.int32)
    for t in range(t_count):
        m = table == t
        idx[m] = rng.randint(0, vocabs[t], int(m.sum()))
    if n >= 2 and table[n - 1] == table[n - 2]:
        idx[n - 1] = idx[n - 2]
    return np.concatenate([idx, np.zeros(pad, np.int32)]), off


def _np_group(vocabs, dims, kinds, seed):
    """Per-table numpy arenas (scale 1, null row zero), each member's kind
    and, for the cached ones, a trace histogram and K."""
    rng = np.random.RandomState(seed)
    out = []
    for t, (v, d) in enumerate(zip(vocabs, dims)):
        a = rng.randn(v + 1, d).astype(np.float32)
        a[v] = 0.0
        out.append((kinds[t % len(kinds)], a, rng.rand(v + 1),
                    min(4, v)))
    return out


def _t_group(vocabs, dims, np_group):
    members = []
    for (kind, a, counts, k), sp in zip(np_group, _specs_of(vocabs, dims)):
        arena = _t(a)
        cold = (es.QuantizedArena.from_arena(arena)
                if kind in ("int8", "cached_int8") else es.FpArena(arena))
        if kind.startswith("cached"):
            cold = es.CachedSource(hot=se.build_hot_cache(arena, sp, counts,
                                                          k), cold=cold)
        members.append(cold)
    return es.TableGroupSource(members=tuple(members),
                               specs=_specs_of(vocabs, dims))


def _j_group(vocabs, dims, np_group):
    specs = tuple(j_se.ArenaSpec(1, v, d) for v, d in zip(vocabs, dims))
    members = []
    for (kind, a, counts, k), sp in zip(np_group, specs):
        arena = jnp.asarray(a)
        cold = (j_es.QuantizedArena.from_arena(arena)
                if kind in ("int8", "cached_int8") else j_es.FpArena(arena))
        if kind.startswith("cached"):
            cold = j_es.CachedSource(hot=j_se.build_hot_cache(
                arena, sp, counts, k), cold=cold)
        members.append(cold)
    return j_es.TableGroupSource(members=tuple(members), specs=specs)


def _streams(idx, off, t_count):
    idx_t, off_t = TSynthetic.ragged_per_table(
        {"indices": idx, "offsets": off}, t_count)
    return [_t(i) for i in idx_t], [_t(o) for o in off_t]


def _np_params(cfg, seed=0):
    return jax.tree.map(np.asarray, j_dlrm.init(jax.random.PRNGKey(seed),
                                                cfg))


# ---------------------------------------------------------------------------
# configs and draws
# ---------------------------------------------------------------------------

def test_het_configs_are_the_reference_field_by_field():
    assert set(t_cfgs.DLRM_HET_CONFIGS) == set(j_cfgs.DLRM_HET_CONFIGS)
    pairs = [(t_cfgs.DLRM_HET_CONFIGS[k], j_cfgs.DLRM_HET_CONFIGS[k])
             for k in t_cfgs.DLRM_HET_CONFIGS]
    pairs += [(HET, J_HET),
              (t_cfgs.make_heterogeneous("narrow", 5, **NARROW),
               j_cfgs.make_heterogeneous("narrow", 5, **NARROW))]
    for t, j in pairs:
        assert dataclasses.astuple(t) == dataclasses.astuple(j)
        assert (t.heterogeneous, t.table_bytes, t.resolved_table_rows,
                t.resolved_table_dims, t.n_interact_features) == \
            (j.heterogeneous, j.table_bytes, j.resolved_table_rows,
             j.resolved_table_dims, j.n_interact_features)
        assert dataclasses.astuple(t_dlrm.arena_spec(t)) == \
            dataclasses.astuple(j_dlrm.arena_spec(j))
        assert [dataclasses.astuple(s) for s in t_dlrm.member_specs(t)] == \
            [dataclasses.astuple(s) for s in j_dlrm.member_specs(j)]
        assert t_dlrm.top_mlp_in_dim(t) == j_dlrm.top_mlp_in_dim(j)
    # the inventory the card runs (chip_smoke.py phase 12)
    het2 = t_cfgs.DLRM_HET_CONFIGS["dlrm_het2"]
    assert het2.n_tables == 26 and het2.lookups_per_table == 38
    assert (min(het2.table_rows), max(het2.table_rows)) == (2_307, 223_260)
    assert set(het2.table_dims) == {8, 16, 32, 64}
    assert het2.table_bytes == 104_231_936


def test_table_plans_are_the_reference():
    cfg = t_cfgs.DLRM_HET_CONFIGS["dlrm_het2"]
    j_cfg = j_cfgs.DLRM_HET_CONFIGS["dlrm_het2"]
    hot = np.argsort(-np.asarray(cfg.table_alphas), kind="stable")[:13]
    k = [min(2048, r // 4) if t in hot else 0
         for t, r in enumerate(cfg.table_rows)]
    plans = t_dlrm.table_plans(cfg, cache_k=k, quantize_rows_above=100_000)
    j_plans = j_dlrm.table_plans(j_cfg, cache_k=k,
                                 quantize_rows_above=100_000)
    assert [dataclasses.astuple(p) for p in plans] == \
        [dataclasses.astuple(p) for p in j_plans]
    # phase 12's mixed plan: three int8 tables, none of them cached
    assert sorted(p.rows for p in plans if p.quantize) == \
        [152_832, 214_305, 223_260]
    assert sum(p.cache_k > 0 for p in plans) == 13
    assert not any(p.quantize and p.cache_k for p in plans)


@pytest.mark.parametrize("cfg_name", ["smoke", "narrow"])
@pytest.mark.parametrize("draw", ["batch", "poisson", "uniform", "fixed",
                                  "padded"])
def test_het_draws_are_the_reference(cfg_name, draw):
    if cfg_name == "smoke":
        t_cfg, j_cfg = HET, J_HET
    else:
        t_cfg = t_cfgs.make_heterogeneous("narrow", 5, **NARROW)
        j_cfg = j_cfgs.make_heterogeneous("narrow", 5, **NARROW)
    t_data, j_data = TSynthetic(t_cfg, seed=4), JSynthetic(j_cfg, seed=4)
    for _ in range(2):               # the generator's state carries on
        if draw == "batch":
            got, want = t_data.batch(7), j_data.batch(7)
        else:
            kw = ({"dist": draw} if draw != "padded"
                  else {"pad_to": 7 * t_cfg.n_tables * 2 * 4})
            got = t_data.ragged_batch(7, mean_l=4, **kw)
            want = j_data.ragged_batch(7, mean_l=4, **kw)
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
    if draw == "batch":
        rows = np.asarray(t_cfg.table_rows)
        assert (got["indices"] < rows[None, :, None]).all()
        return
    for pad in (None, 40, [40 + t for t in range(t_cfg.n_tables)]):
        t_idx, t_off = TSynthetic.ragged_per_table(got, t_cfg.n_tables, pad)
        j_idx, j_off = JSynthetic.ragged_per_table(want, j_cfg.n_tables,
                                                   pad)
        for a, b in zip(t_idx + t_off, j_idx + j_off):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


# ---------------------------------------------------------------------------
# the tentpole law: grouped dispatch == the per-table loop, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kinds", KIND_PATTERNS)
@pytest.mark.parametrize("inventory", INVENTORIES)
def test_group_lookup_equals_per_table_loop(inventory, kinds):
    vocabs, dims = inventory
    seed = len(vocabs) * 7 + len(kinds)
    rng = np.random.RandomState(seed)
    np_group = _np_group(vocabs, dims, kinds, seed)
    group = _t_group(vocabs, dims, np_group)
    idx, off = _het_case(rng, vocabs, b=3, max_l=5, pad=4)
    spec = group.envelope_spec
    got = es.lookup_bags(group, spec, _t(idx), _t(off), max_l=5)
    idx_t, off_t = _streams(idx, off, len(vocabs))
    assert torch.equal(got, es.lookup_bags_per_table(group, idx_t, off_t,
                                                     max_l=5))
    for t, (m, sp) in enumerate(zip(group.members, group.specs)):
        own = es.lookup_bags(m, sp, idx_t[t], off_t[t], max_l=5)[:, 0, :]
        assert torch.equal(got[:, t, :sp.dim], own.to(got.dtype))
        assert not got[:, t, sp.dim:].any()
    # and the reference's group on the same members
    j_group = _j_group(vocabs, dims, np_group)
    want = j_es.lookup_bags(j_group, j_group.envelope_spec, jnp.asarray(idx),
                            jnp.asarray(off), max_l=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("kinds", KIND_PATTERNS)
@pytest.mark.parametrize("inventory", INVENTORIES[:2] + INVENTORIES[3:])
def test_group_grads_equal_per_table_loop(inventory, kinds):
    """Autograd through the grouped lookup == through the per-table loop,
    leaf for leaf (arenas, hot rows and int8 scales), bit for bit."""
    vocabs, dims = inventory
    seed = len(vocabs) + 11 * len(kinds)
    rng = np.random.RandomState(seed)
    group = _t_group(vocabs, dims, _np_group(vocabs, dims, kinds, seed))
    leaves = [t for t in es.source_structure(group)[1]
              if t.dtype.is_floating_point]
    for t in leaves:
        t.requires_grad_()
    idx, off = _het_case(rng, vocabs, b=2, max_l=4, pad=3)
    idx_t, off_t = _streams(idx, off, len(vocabs))
    spec = group.envelope_spec
    w = torch.from_numpy(rng.randn(2, len(vocabs), spec.dim)
                         .astype(np.float32))
    grouped = (es.lookup_bags(group, spec, _t(idx), _t(off), max_l=4)
               * w).sum()
    loop = (es.lookup_bags_per_table(group, idx_t, off_t, max_l=4)
            * w).sum()
    g1 = torch.autograd.grad(grouped, leaves, allow_unused=True)
    g2 = torch.autograd.grad(loop, leaves, allow_unused=True)
    assert any(g is not None for g in g1)
    for a, b in zip(g1, g2):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


def test_group_fixed_layout_matches_ragged(rng):
    vocabs, dims = (30, 9, 1), (8, 2, 1)
    group = _t_group(vocabs, dims, _np_group(vocabs, dims,
                                             ("cached", "int8", "fp"), 5))
    spec = group.envelope_spec
    b, t, l = 3, len(vocabs), 4
    idx = np.stack([rng.randint(0, vocabs[j], (b, l)) for j in range(t)],
                   axis=1).astype(np.int32)
    fixed = es.lookup_fixed(group, spec, _t(idx))
    off = torch.arange(b * t + 1, dtype=torch.int32) * l
    ragged = es.lookup_bags(group, spec, _t(idx.reshape(-1)), off, max_l=l)
    assert torch.equal(fixed, ragged)


def test_group_degenerate_shapes():
    for vocabs, dims in (((7,), (4,)), ((1, 50), (8, 8)), ((5, 5), (1, 16))):
        rng = np.random.RandomState(0)
        group = _t_group(vocabs, dims, _np_group(vocabs, dims,
                                                 ("fp", "int8"), 3))
        idx, off = _het_case(rng, vocabs, b=2, max_l=3, pad=2)
        got = es.lookup_bags(group, group.envelope_spec, _t(idx), _t(off),
                             max_l=3)
        idx_t, off_t = _streams(idx, off, len(vocabs))
        assert torch.equal(got, es.lookup_bags_per_table(group, idx_t,
                                                         off_t, max_l=3))
        if len(vocabs) > 1:
            assert not got[:, 0, :].any()       # table 0's bags are empty


def test_group_non_divisible_bag_count_raises():
    group = _t_group((7, 9), (4, 4), _np_group((7, 9), (4, 4), ("fp",), 1))
    idx = torch.tensor([0, 1, 2], dtype=torch.int32)
    off = torch.tensor([0, 1, 2, 3], dtype=torch.int32)   # 3 bags, 2 tables
    with pytest.raises(ValueError) as exc:
        es.lookup_bags(group, group.envelope_spec, idx, off, max_l=2)
    msg = str(exc.value)
    assert "n_bags=3" in msg and "t_count=2" in msg and "lookup_bags" in msg
    for fn in (group.reduce_flat, group.reduce_dense):
        with pytest.raises(TypeError, match="no shared arena layout"):
            fn(group.envelope_spec, idx, off, max_l=2) \
                if fn == group.reduce_flat else fn(group.envelope_spec, off)


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_l", [None, 5])
def test_group_hit_counts_and_trace_counts_are_the_reference(max_l):
    vocabs, dims = (40, 7, 300, 1), (8, 4, 16, 1)
    np_group = _np_group(vocabs, dims, ("fp", "cached", "cached_int8",
                                        "int8"), 8)
    group, j_group = (_t_group(vocabs, dims, np_group),
                      _j_group(vocabs, dims, np_group))
    # table 0's bags all empty, table 1's (4 of 7 rows hot) all full
    idx, off = _het_case(np.random.RandomState(4), vocabs, b=5, max_l=5,
                         pad=6)
    hits, looks = es.group_hit_counts(group, _t(idx), _t(off), max_l=max_l)
    j_hits, j_looks = j_es.group_hit_counts(j_group, jnp.asarray(idx),
                                            jnp.asarray(off), max_l=max_l)
    assert hits.dtype == looks.dtype == torch.int32
    np.testing.assert_array_equal(hits.numpy(), np.asarray(j_hits))
    np.testing.assert_array_equal(looks.numpy(), np.asarray(j_looks))
    assert hits[0] == looks[0] == 0 and hits[1] > 0
    assert looks.sum() == off[-1]
    counts = es.group_trace_counts(group.specs, idx, off)
    j_counts = j_es.group_trace_counts(j_group.specs, idx, off)
    for a, b in zip(counts, j_counts):
        np.testing.assert_array_equal(a, b)
    assert sum(int(c.sum()) for c in counts) == off[-1]


def test_group_describe_and_bytes_are_the_reference():
    vocabs, dims = (12, 5, 1), (8, 4, 1)
    np_group = _np_group(vocabs, dims, ("cached_int8", "fp", "int8"), 9)
    group, j_group = (_t_group(vocabs, dims, np_group),
                      _j_group(vocabs, dims, np_group))
    assert es.describe_source(group) == j_es.describe_source(j_group) == \
        "group[cached(int8),fp,int8]"
    assert es.source_bytes(group) == j_es.source_bytes(j_group)
    tree = es.describe_source(group, multiline=True)
    assert tree == j_es.describe_source(j_group, multiline=True)
    assert "table[2] vocab=1 dim=1" in tree


# ---------------------------------------------------------------------------
# the model: forward on a group against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg_name", ["smoke", "narrow"])
def test_forwards_match_reference(cfg_name):
    if cfg_name == "smoke":
        t_cfg, j_cfg = HET, J_HET
    else:
        t_cfg = t_cfgs.make_heterogeneous("narrow", 5, **NARROW)
        j_cfg = j_cfgs.make_heterogeneous("narrow", 5, **NARROW)
    np_params = _np_params(j_cfg, seed=2)
    params = t_dlrm.params_from_numpy(np_params, "cpu")
    assert len(params["tables"]) == len(params["proj"]) == t_cfg.n_tables
    j_params = jax.tree.map(jnp.asarray, np_params)
    data = JSynthetic(j_cfg, seed=6)
    rb = data.ragged_batch(5, mean_l=3, max_l=MAX_L, pad_to=5 * MAX_L
                           * t_cfg.n_tables)
    want = np.asarray(j_dlrm.forward_ragged(
        j_params, j_cfg, jnp.asarray(rb["dense"]), jnp.asarray(rb["indices"]),
        jnp.asarray(rb["offsets"]), max_l=MAX_L))
    got = t_dlrm.forward_ragged(params, t_cfg, _t(rb["dense"]),
                                _t(rb["indices"]), _t(rb["offsets"]),
                                max_l=MAX_L)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # per-table streams: the same bags, bit for bit within the port
    idx_t, off_t = _streams(rb["indices"], rb["offsets"], t_cfg.n_tables)
    per = t_dlrm.forward_ragged(params, t_cfg, _t(rb["dense"]), idx_t, off_t,
                                max_l=[MAX_L] * t_cfg.n_tables)
    assert torch.equal(per, got)
    # the fixed layout
    fb = data.batch(4)
    want = np.asarray(j_dlrm.forward(j_params, j_cfg,
                                     jnp.asarray(fb["dense"]),
                                     jnp.asarray(fb["indices"])))
    got = t_dlrm.forward(params, t_cfg, _t(fb["dense"]), _t(fb["indices"]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # a served group of the reference's plan over the same params
    counts = es.group_trace_counts(t_dlrm.member_specs(t_cfg),
                                   rb["indices"], rb["offsets"])
    plans = t_dlrm.table_plans(t_cfg, cache_k=[4, 0] * (t_cfg.n_tables // 2)
                               + [4] * (t_cfg.n_tables % 2),
                               quantize_rows_above=100)
    src = es.SourceSpec(tables=plans).build(params["tables"], None, counts)
    j_src = j_es.SourceSpec(tables=j_dlrm.table_plans(
        j_cfg, cache_k=[4, 0] * (t_cfg.n_tables // 2)
        + [4] * (t_cfg.n_tables % 2), quantize_rows_above=100)).build(
        j_params["tables"], None, counts)
    want = np.asarray(j_dlrm.forward_ragged(
        j_params, j_cfg, jnp.asarray(rb["dense"]), jnp.asarray(rb["indices"]),
        jnp.asarray(rb["offsets"]), max_l=MAX_L, source=j_src))
    got = t_dlrm.forward_ragged(params, t_cfg, _t(rb["dense"]),
                                _t(rb["indices"]), _t(rb["offsets"]),
                                max_l=MAX_L, source=src)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_init_draws_a_group_from_the_generator():
    params = t_dlrm.init(torch.Generator().manual_seed(0), HET, device="cpu")
    again = t_dlrm.init(torch.Generator().manual_seed(0), HET, device="cpu")
    assert "arena" not in params
    for sp, a, p in zip(t_dlrm.member_specs(HET), params["tables"],
                        params["proj"]):
        assert a.shape == (sp.total_rows, sp.dim) and not a[-1].any()
        assert p.shape == (sp.dim, HET.emb_dim)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(again)))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_l", [None, 4])
def test_group_row_grads_match_autodiff_and_reference(max_l, rng):
    """group_row_grads scattered == autograd of the group lookup w.r.t.
    each member arena (null rows pinned at zero), and == the reference's
    group_row_grads: touched rows exactly, gradients within 1e-5."""
    vocabs, dims = (20, 6, 1), (8, 4, 1)
    np_group = _np_group(vocabs, dims, ("fp",), 2)
    group = _t_group(vocabs, dims, np_group)
    specs = group.specs
    for m in group.members:
        m.arena.requires_grad_()
    spec = group.envelope_spec
    idx, off = _het_case(np.random.RandomState(2), vocabs, b=3, max_l=4,
                         pad=2)
    n_bags = off.shape[0] - 1
    w = rng.randn(n_bags // len(vocabs), len(vocabs),
                  spec.dim).astype(np.float32)
    loss = (es.lookup_bags(group, spec, _t(idx), _t(off), max_l=4)
            * _t(w)).sum()
    g_auto = torch.autograd.grad(loss, [m.arena for m in group.members])
    per_table = group_row_grads(specs, _t(w.reshape(n_bags, spec.dim)),
                                _t(idx), _t(off), max_l=max_l)
    j_per_table = j_group_row_grads(
        tuple(j_se.ArenaSpec(1, v, d) for v, d in zip(vocabs, dims)),
        jnp.asarray(w.reshape(n_bags, spec.dim)), jnp.asarray(idx),
        jnp.asarray(off), max_l=max_l)
    for t, sp in enumerate(specs):
        rows, row_g = per_table[t]
        j_rows, j_row_g = j_per_table[t]
        assert rows.dtype == torch.int32
        np.testing.assert_array_equal(rows.numpy(), np.asarray(j_rows))
        np.testing.assert_allclose(row_g.numpy(), np.asarray(j_row_g),
                                   rtol=1e-5, atol=1e-5)
        dense = torch.zeros_like(g_auto[t])
        real = rows != sp.null_row
        dense.index_add_(0, rows[real].long(), row_g[real])
        want = g_auto[t].clone()
        want[sp.null_row] = 0.0
        np.testing.assert_allclose(dense.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


_KEYS = ("dense", "indices", "offsets", "labels")


def _het_batches(n, seed=1):
    data = JSynthetic(J_HET, seed=seed)
    return [data.ragged_batch(4, dist="poisson", mean_l=3, max_l=MAX_L,
                              pad_to=4 * HET.n_tables * MAX_L)
            for _ in range(n)]


def _t_steps(np_params, batches, sparse):
    opt, step = t_dlrm.make_train_step_ragged(HET, max_l=MAX_L, lr=LR,
                                              sparse=sparse)
    params = t_dlrm.params_from_numpy(np_params, "cpu")
    state = opt.init(params)
    out = []
    for b in batches:
        params, state, loss, rows = step(params, state,
                                         {k: _t(b[k]) for k in _KEYS})
        out.append((float(loss), [r.numpy() for r in rows]))
    return params, out


@pytest.mark.parametrize("sparse", [True, False])
def test_group_train_step_matches_reference(sparse):
    np_params = _np_params(J_HET)
    batches = _het_batches(3)
    opt, step = j_dlrm.make_train_step_ragged(J_HET, max_l=MAX_L, lr=LR,
                                              sparse=sparse)
    j_params = jax.tree.map(jnp.asarray, np_params)
    state = opt.init(j_params)
    step = jax.jit(step)
    j_out = []
    for b in batches:
        j_params, state, loss, rows = step(j_params, state,
                                           {k: jnp.asarray(b[k])
                                            for k in _KEYS})
        j_out.append((float(loss), [np.asarray(r) for r in rows]))
    params, out = _t_steps(np_params, batches, sparse)
    for (loss, rows), (j_loss, j_rows) in zip(out, j_out):
        np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
        assert len(rows) == HET.n_tables
        for r, jr in zip(rows, j_rows):
            assert r.dtype == np.int32
            np.testing.assert_array_equal(r, jr)
    for key in ("bottom", "top", "tables", "proj"):
        for got, want in zip(tree_leaves(params[key]),
                             jax.tree.leaves(j_params[key])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=5e-6)
    for sp, a, a0 in zip(t_dlrm.member_specs(HET), params["tables"],
                         np_params["tables"]):
        assert not a[sp.null_row].any()
    assert max(np.abs(a.numpy() - a0).max()
               for a, a0 in zip(params["tables"], np_params["tables"])) > 1e-3


def test_group_train_step_sparse_equals_dense_grad():
    """The per-table row-wise sparse step == the dense-gradient baseline
    over 3 steps (per-table Adagrad accumulators included)."""
    np_params = _np_params(J_HET)
    batches = _het_batches(3, seed=2)
    ps, out_s = _t_steps(np_params, batches, True)
    pd, out_d = _t_steps(np_params, batches, False)
    for (ls, rs), (ld, rd) in zip(out_s, out_d):
        np.testing.assert_allclose(ls, ld, rtol=1e-6)
    assert set(ps) == set(pd)
    for key in ps:
        for a, b in zip(tree_leaves(ps[key]), tree_leaves(pd[key])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-7)


def test_fixed_train_step_on_a_group_matches_reference():
    np_params = _np_params(J_HET, seed=3)
    fb = JSynthetic(J_HET, seed=8).batch(4)
    opt, step = j_dlrm.make_train_step(J_HET)
    j_params = jax.tree.map(jnp.asarray, np_params)
    j_params, _, j_loss = jax.jit(step)(j_params, opt.init(j_params),
                                        {k: jnp.asarray(fb[k]) for k in
                                         ("dense", "indices", "labels")})
    opt, step = t_dlrm.make_train_step(HET)
    params = t_dlrm.params_from_numpy(np_params, "cpu")
    params, _, loss = step(params, opt.init(params),
                           {k: _t(fb[k]) for k in
                            ("dense", "indices", "labels")})
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    assert set(params) == set(j_params) == {"bottom", "top", "tables",
                                            "proj"}
    for key in params:
        for got, want in zip(tree_leaves(params[key]),
                             jax.tree.leaves(j_params[key])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=5e-6)


def test_online_group_trainer_is_refused():
    """A heterogeneous config trains online through the port's
    OnlineGroupTrainer (tests/test_torch_group_online.py): OnlineTrainer
    refuses it, naming the class to use."""
    params = t_dlrm.init(torch.Generator().manual_seed(0), HET, device="cpu")
    with pytest.raises(ValueError, match="OnlineGroupTrainer"):
        OnlineTrainer(HET, params, max_l=MAX_L, device="cpu")
    tr = OnlineGroupTrainer(HET, params, max_l=MAX_L,
                            plans=t_dlrm.table_plans(HET), device="cpu")
    assert isinstance(tr.serving_source(), es.TableGroupSource)


def test_sharded_members_are_refused():
    """Sharded members serve (item 13, across ranks in
    tests/test_torch_sharded_dist.py); what stays refused: a mesh that is
    not the port's, and sharded group training, in the reference's
    words."""
    params = t_dlrm.init(torch.Generator().manual_seed(0), HET, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        t_dlrm.group_source(params, HET, mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        es.SourceSpec(tables=t_dlrm.table_plans(HET), mesh=object()).build(
            params["tables"], None)
    with pytest.raises(ValueError, match="heterogeneous table group"):
        t_dlrm.make_train_step_ragged(HET, max_l=MAX_L, sharded=True)


# ---------------------------------------------------------------------------
# plans, serving, artifacts
# ---------------------------------------------------------------------------

def test_group_plan_validation():
    plans = (es.TablePlan(rows=10, dim=4),)
    with pytest.raises(ValueError, match="TablePlan"):
        es.SourceSpec(tables=plans, cache_k=8)
    with pytest.raises(ValueError, match="fixed"):
        es.SourceSpec(tables=plans, layout="fixed")
    with pytest.raises(ValueError, match="TablePlan"):
        es.TablePlan(rows=10, dim=4, cache_k=2, tiers=object())
    spec = es.SourceSpec(tables=(es.TablePlan(rows=10, dim=4, cache_k=2),
                                 es.TablePlan(rows=5, dim=8, quantize=True)))
    assert spec.cached and spec.path_name() == "grouped"
    assert not es.SourceSpec(tables=plans).cached
    arenas = [se.init_arena(torch.Generator().manual_seed(t), tp.arena_spec)
              for t, tp in enumerate(spec.tables)]
    src = spec.build(arenas, None)
    assert isinstance(src, es.TableGroupSource)
    assert isinstance(src.members[0], es.CachedSource)
    assert src.members[0].coherent
    assert isinstance(src.members[1], es.QuantizedArena)
    assert es.describe_source(src) == "group[cached(fp),int8]"
    tree = es.describe_source(src, multiline=True)
    assert len(tree.splitlines()) >= 5 and "table[1]" in tree
    with pytest.raises(ValueError, match="arenas"):
        spec.build(arenas[:1], None)


def _het_engine(params, plans, counts, **kw):
    kw = {"max_l": MAX_L, "max_batch": 4, "max_wait_ms": 0.0,
          "buckets": (4,), "device": "cpu", **kw}
    return RecEngine(HET, params, source=es.SourceSpec(tables=plans),
                     cache_trace=counts, **kw)


def _serve(engine, reqs):
    for r in reqs:
        engine.submit(r)
    engine.step(force=True)
    engine.drain()
    return np.array([r.prob for r in reqs])


def test_group_engine_serves_with_per_table_hit_stats():
    """RecEngine over a group plan against the reference's engine:
    probabilities within 1e-5, per-table hit rates equal (None for the
    member without a cache); a one-member swap under a bumped version
    resets the counters; stale and structure-changing swaps refused."""
    np_params = _np_params(J_HET)
    params = t_dlrm.params_from_numpy(np_params, "cpu")
    specs = t_dlrm.member_specs(HET)
    rb = JSynthetic(J_HET, seed=3).ragged_batch(4, dist="poisson", mean_l=3,
                                                max_l=MAX_L)
    counts = es.group_trace_counts(specs, rb["indices"], rb["offsets"])
    plans = t_dlrm.table_plans(HET, cache_k=(16, 8, 0))
    j_plans = j_dlrm.table_plans(J_HET, cache_k=(16, 8, 0))
    j_engine = JRecEngine(J_HET, np_params,
                          source=j_es.SourceSpec(tables=j_plans),
                          cache_trace=counts, max_l=MAX_L, max_batch=4,
                          max_wait_ms=0.0, buckets=(4,))
    engine = _het_engine(params, plans, counts)
    engine.warmup()
    want = _serve(j_engine, j_requests(rb, HET.n_tables))
    got = _serve(engine, t_requests(rb, HET.n_tables))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    s, j_s = engine.stats(), j_engine.stats()
    assert s["path"] == j_s["path"] == "grouped"
    assert s["source"] == j_s["source"] == "group[cached(fp),cached(fp),fp]"
    hr = s["cache_hit_rate"]
    assert hr == j_s["cache_hit_rate"] and set(hr) == {0, 1, 2}
    assert hr[2] is None and 0.0 < hr[0] <= 1.0
    assert engine._hit_snapshot()["per_table"] == \
        {k: tuple(v) for k, v in j_engine._hit_snapshot()
         ["per_table"].items()}
    direct = torch.sigmoid(t_dlrm.forward_ragged(
        params, HET, _t(rb["dense"]), _t(rb["indices"]), _t(rb["offsets"]),
        max_l=MAX_L, source=engine.source)).numpy()
    np.testing.assert_allclose(got, direct, rtol=1e-5, atol=1e-5)
    # one member's hot cache swapped under a bumped version: counters reset
    new_hot = se.build_hot_cache(params["tables"][0], specs[0],
                                 np.roll(counts[0], 3), 16)
    engine.update_source(es.replace_member(
        engine.source, 0, es.with_hot_cache(engine.source.members[0],
                                            new_hot)), version=2)
    assert torch.equal(engine.source.members[0].hot.hot_rows,
                       new_hot.hot_rows)
    assert engine.stats()["cache_hit_rate"][0] is None
    _serve(engine, t_requests(rb, HET.n_tables))
    assert engine.stats()["cache_hit_rate"][0] is not None
    with pytest.raises(ValueError, match="stale"):
        engine.update_source(es.replace_member(
            engine.source, 0, engine.source.members[0]), version=1)
    with pytest.raises(ValueError, match="structure"):
        engine.update_source(es.replace_member(
            engine.source, 0, engine.source.members[0].cold), version=3)
    assert engine.captures == 0 and engine._c_cold.value == 0


def test_member_swap_equals_a_fresh_engine():
    """A replace_member swap copied into the engine's own source
    (adopt_source: only the swapped member's tensors written, every
    address kept) serves what a fresh engine over the new group serves,
    bit for bit; a params assignment rebinds every member and
    re-quantizes the downgrade group."""
    params = t_dlrm.params_from_numpy(_np_params(J_HET, seed=5), "cpu")
    specs = t_dlrm.member_specs(HET)
    rb = JSynthetic(J_HET, seed=7).ragged_batch(8, dist="poisson", mean_l=3,
                                                max_l=MAX_L)
    counts = es.group_trace_counts(specs, rb["indices"], rb["offsets"])
    plans = t_dlrm.table_plans(HET, cache_k=(16, 0, 0),
                               quantize_rows_above=100)
    engine = _het_engine(params, plans, counts)
    ptrs = [t.data_ptr() for t in es.source_structure(engine.source)[1]]
    fresh_hot = se.build_hot_cache(params["tables"][0], specs[0],
                                   np.roll(counts[0], 5), 16)
    swapped = es.replace_member(engine.source, 0, es.with_hot_cache(
        engine.source.members[0], fresh_hot))
    engine.update_source(swapped, version=1)
    assert [t.data_ptr() for t in es.source_structure(engine.source)[1]] \
        == ptrs
    other = RecEngine(HET, params, source=swapped, max_l=MAX_L, max_batch=4,
                      max_wait_ms=0.0, buckets=(4,), device="cpu")
    got = _serve(engine, t_requests(rb, HET.n_tables))
    want = _serve(other, t_requests(rb, HET.n_tables))
    np.testing.assert_array_equal(got, want)
    # params assignment: members rebound in place, downgrade re-quantized
    engine.enable_downgrade()
    p2 = {k: tuple(t * 1.5 for t in v) if k in ("tables", "proj") else v
          for k, v in params.items()}
    engine.params = p2
    assert [t.data_ptr() for t in es.source_structure(engine.source)[1]] \
        == ptrs
    assert torch.equal(engine.source.members[2].arena, p2["tables"][2])
    for m, a in zip(engine.downgrade_source.members, p2["tables"]):
        want_q = es.QuantizedArena.from_arena(a)
        assert torch.equal(m.q, want_q.q) and torch.equal(m.scales,
                                                           want_q.scales)


def test_group_downgrade_serves_the_int8_group():
    params = t_dlrm.params_from_numpy(_np_params(J_HET, seed=6), "cpu")
    rb = JSynthetic(J_HET, seed=9).ragged_batch(4, dist="poisson", mean_l=3,
                                                max_l=MAX_L)
    engine = _het_engine(params, t_dlrm.table_plans(HET), None)
    down = engine.enable_downgrade()
    assert es.describe_source(down) == "group[int8,int8,int8]"
    engine.warmup()
    reqs = t_requests(rb, HET.n_tables)
    engine.settle(engine.dispatch(reqs, downgraded=True))
    got = np.array([r.prob for r in reqs])
    assert all(r.downgraded for r in reqs)
    step = t_dlrm.make_ragged_serve_step(HET, max_l=MAX_L)
    batch, _ = engine._assemble(reqs, 4)
    np.testing.assert_array_equal(
        got, step(engine.params, batch, down).numpy()[:4].astype(np.float64))
    primary = step(engine.params, batch, engine.source).numpy()[:4]
    assert np.abs(got - primary).max() <= 0.05   # the reference's bound


def test_group_artifact_roundtrip_mixed_members():
    """A mixed group round-trips within the port, and blobs decode across
    packages leaf for leaf (the specs included)."""
    vocabs, dims = (12, 5, 1), (8, 4, 1)
    np_group = _np_group(vocabs, dims, ("cached_int8", "fp", "int8"), 9)
    group, j_group = (_t_group(vocabs, dims, np_group),
                      _j_group(vocabs, dims, np_group))
    back = VersionedSource.deserialize(VersionedSource(group, 11).serialize(),
                                       device="cpu")
    assert back.version == 11 and isinstance(back.source, es.TableGroupSource)
    assert back.source.specs == group.specs
    assert es.source_structure(back.source)[0] == \
        es.source_structure(group)[0]
    for a, b in zip(es.source_structure(group)[1],
                    es.source_structure(back.source)[1]):
        assert torch.equal(a, b)
    mine = VersionedSource.deserialize(
        j_es.VersionedSource(j_group, 3).serialize(), device="cpu")
    theirs = j_es.VersionedSource.deserialize(
        VersionedSource(group, 4).serialize())
    assert es.source_structure(mine.source)[0] == \
        es.source_structure(group)[0]
    for a, b, c in zip(es.source_structure(mine.source)[1],
                       jax.tree_util.tree_leaves(j_group),
                       jax.tree_util.tree_leaves(theirs.source)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    assert [dataclasses.astuple(s) for s in theirs.source.specs] == \
        [dataclasses.astuple(s) for s in group.specs]
