"""The port's hybrid sparse/dense pipeline against ``repro.core.hybrid``:
the naive baseline, the fixed and ragged micro-batch pipelines, the
pipelined serve step and the ragged micro-batch split, on the same numpy
inputs with the reference's params carried across.

On the CPU the pipeline runs its stages one after the other; on the card
the lookups go on a side stream (``chip_smoke.py`` phase 7 runs both
pipelines there and holds them to the single-shot forwards).

Tolerances:
  * the micro-batch split (ids and offsets): exact;
  * logits and probabilities against the reference: fp32 sums of O(1)
    over K <= 64 in another order -> rtol=atol=1e-5.
Within the port, on the CPU, a pipelined forward equals its single-shot
forward bit for bit: each bag, sample and output row goes through the
same arithmetic, and torch's matmul gives each of these rows the same
bits at 8 rows a micro-batch as at 32 (one thread, as every test file
here runs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.dlrm import DLRM_SMOKE as J_CFG
from repro.core import dlrm as j_dlrm
from repro.core import hybrid as j_hybrid
from repro.data import DLRMSynthetic
from repro_torch.configs.dlrm import DLRM_SMOKE as CFG
from repro_torch.core import dlrm as t_dlrm
from repro_torch.core import embedding_source as es
from repro_torch.core import hybrid
from repro_torch.core import sparse_engine as se

torch.set_num_threads(1)

B = 32
MAX_L = 2 * CFG.lookups_per_table


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(a):
    return np.asarray(a)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, j_dlrm.init(jax.random.PRNGKey(6), J_CFG))


@pytest.fixture(scope="module")
def params(np_params):
    return t_dlrm.params_from_numpy(np_params, "cpu")


@pytest.fixture(scope="module")
def j_params(np_params):
    return jax.tree.map(jnp.asarray, np_params)


def _fixed(seed=1, b=B):
    return DLRMSynthetic(J_CFG, seed=seed).batch(b)


def _ragged(seed=2, b=B, dist="poisson"):
    return DLRMSynthetic(J_CFG, seed=seed).ragged_batch(
        b, dist=dist, max_l=MAX_L, pad_to=b * CFG.n_tables * MAX_L)


def test_baseline_forward_matches_jax(params, j_params):
    b = _fixed()
    got = hybrid.baseline_forward(params, CFG, _t(b["dense"]),
                                  _t(b["indices"]))
    want = j_hybrid.baseline_forward(j_params, J_CFG,
                                     jnp.asarray(b["dense"]),
                                     jnp.asarray(b["indices"]))
    np.testing.assert_allclose(got.numpy(), _n(want), rtol=1e-5, atol=1e-5)
    single = t_dlrm.forward(params, CFG, _t(b["dense"]), _t(b["indices"]))
    np.testing.assert_allclose(got.numpy(), single.detach().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_pipelined_forward_matches_jax_and_single_shot(params, j_params,
                                                       n_micro):
    b = _fixed(seed=3)
    got = hybrid.pipelined_forward(params, CFG, _t(b["dense"]),
                                   _t(b["indices"]), n_micro)
    want = j_hybrid.pipelined_forward(j_params, J_CFG,
                                      jnp.asarray(b["dense"]),
                                      jnp.asarray(b["indices"]), n_micro)
    np.testing.assert_allclose(got.detach().numpy(), _n(want), rtol=1e-5,
                               atol=1e-5)
    single = t_dlrm.forward(params, CFG, _t(b["dense"]), _t(b["indices"]))
    assert torch.equal(got, single)


def test_pipelined_serve_step_matches_jax(params, j_params):
    b = _fixed(seed=4)
    got = hybrid.make_pipelined_serve_step(CFG, 4)(
        params, {"dense": _t(b["dense"]), "indices": _t(b["indices"])})
    want = j_hybrid.make_pipelined_serve_step(J_CFG, 4)(
        j_params, {"dense": jnp.asarray(b["dense"]),
                   "indices": jnp.asarray(b["indices"])})
    assert got.is_inference()
    np.testing.assert_allclose(got.numpy(), _n(want), rtol=1e-5, atol=1e-5)
    assert torch.equal(got, t_dlrm.make_serve_step(CFG)(
        params, {"dense": _t(b["dense"]), "indices": _t(b["indices"])}))


@pytest.mark.parametrize("n_micro", [2, 4])
def test_split_ragged_microbatches_matches_jax(n_micro):
    rb = _ragged(seed=5)
    idx, off = hybrid.split_ragged_microbatches(
        _t(rb["indices"]), _t(rb["offsets"]), n_micro, MAX_L)
    j_idx, j_off = j_hybrid.split_ragged_microbatches(
        jnp.asarray(rb["indices"]), jnp.asarray(rb["offsets"]), n_micro,
        MAX_L)
    assert idx.dtype == torch.int32 and off.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), _n(j_idx))
    np.testing.assert_array_equal(off.numpy(), _n(j_off))


@pytest.mark.parametrize("dist,n_micro", [("poisson", 4), ("uniform", 2),
                                          ("fixed", 4)])
def test_pipelined_forward_ragged_matches_jax_and_single_shot(
        params, j_params, dist, n_micro):
    rb = _ragged(seed=6, dist=dist)
    args = ("dense", "indices", "offsets")
    got = hybrid.pipelined_forward_ragged(
        params, CFG, *(_t(rb[k]) for k in args), max_l=MAX_L,
        n_micro=n_micro)
    want = j_hybrid.pipelined_forward_ragged(
        j_params, J_CFG, *(jnp.asarray(rb[k]) for k in args), max_l=MAX_L,
        n_micro=n_micro)
    np.testing.assert_allclose(got.detach().numpy(), _n(want), rtol=1e-5,
                               atol=1e-5)
    single = t_dlrm.forward_ragged(params, CFG, *(_t(rb[k]) for k in args),
                                   max_l=MAX_L)
    assert torch.equal(got, single)


def test_pipeline_tails_reduce_only_the_null_row(params, monkeypatch):
    """n_micro + 1 lookups; the last (the tail's dummy) reduces ids that
    all flatten to the zero null row, or all-empty bags."""
    seen = []
    real_fixed, real_bags = es.lookup_fixed, es.lookup_bags

    def fixed(src, spec, ids):
        seen.append(("fixed", se.flatten_indices(spec, ids)))
        return real_fixed(src, spec, ids)

    def bags(src, spec, idx, off, *, max_l):
        seen.append(("bags", off))
        return real_bags(src, spec, idx, off, max_l=max_l)

    monkeypatch.setattr(es, "lookup_fixed", fixed)
    monkeypatch.setattr(es, "lookup_bags", bags)
    b, rb = _fixed(seed=7), _ragged(seed=7)
    hybrid.pipelined_forward(params, CFG, _t(b["dense"]), _t(b["indices"]),
                             4)
    hybrid.pipelined_forward_ragged(
        params, CFG, _t(rb["dense"]), _t(rb["indices"]), _t(rb["offsets"]),
        max_l=MAX_L, n_micro=4)
    assert [k for k, _ in seen] == ["fixed"] * 5 + ["bags"] * 5
    null_row = CFG.n_tables * CFG.rows_per_table
    assert (seen[4][1] == null_row).all()
    assert not (seen[3][1] == null_row).all()
    assert not seen[9][1].any() and seen[8][1][-1] > 0


def test_pipelines_refuse_what_they_cannot_split(params):
    b, rb = _fixed(seed=8), _ragged(seed=8)
    with pytest.raises(ValueError, match="micro-batches"):
        hybrid.pipelined_forward(params, CFG, _t(b["dense"]),
                                 _t(b["indices"]), 5)
    with pytest.raises(ValueError, match="micro-batches"):
        hybrid.pipelined_forward_ragged(
            params, CFG, _t(rb["dense"]), _t(rb["indices"]),
            _t(rb["offsets"]), max_l=MAX_L, n_micro=3)
    with pytest.raises(ValueError, match="bags"):
        hybrid.pipelined_forward_ragged(
            params, CFG, _t(rb["dense"][:16]), _t(rb["indices"]),
            _t(rb["offsets"]), max_l=MAX_L, n_micro=4)
    # a mesh is the port's launch.mesh.Mesh (item 13 is ported)
    with pytest.raises(TypeError, match="Mesh"):
        hybrid.pipelined_forward(params, CFG, _t(b["dense"]),
                                 _t(b["indices"]), 4, mesh=object())
