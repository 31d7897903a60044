"""The port's RG-LRU block (``repro_torch.models.rglru``) against the
reference's ``repro.models.rglru`` on the same numpy inputs and the
reference's own params (carried across through numpy).

Tolerances:
  * fp32 against the reference, 1e-5: the same gates and conv in fp32;
    the recurrence is a scan on both sides, associated in another tree
    (the reference's ``associative_scan``, the port's log-depth
    Hillis-Steele passes), so they agree to fp32 rounding, not bit for
    bit.
  * the port's scan against its own stepwise ``rec_step``: the
    reference's 1e-4 for its own scan against its step
    (tests/test_models.py:162-175).
  * ``init_rec``'s Lambda: computed in fp32 on both sides from the same
    formula, within 1e-5 relative: ``linspace`` rounds some of its points
    one ulp apart in the two frameworks, and log(expm1(-log(a) / 8))
    near a = 1 scales one ulp of a (6e-8) up to ~7e-6 of Lambda.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RGLRUConfig as JRGLRUConfig
from repro.models import params as j_params
from repro.models import rglru as j_rglru
from repro_torch.configs.base import RGLRUConfig
from repro_torch.models import api, rglru
from repro_torch.models.params import Builder

torch.set_num_threads(1)

TOL = 1e-5


def _params(w=16, d=16, seed=0):
    """(port params on the CPU, JAX params) from the reference's
    init_rec."""
    jp, _ = j_params.split(j_rglru.init_rec(
        j_params.Builder(jax.random.PRNGKey(seed), dtype=jnp.float32),
        JRGLRUConfig(lru_width=w, conv_width=4), d))
    return api.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), jp


def _x(shape, seed=0):
    a = (np.random.RandomState(seed).randn(*shape) * 0.3).astype(np.float32)
    return torch.from_numpy(a), jnp.asarray(a)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("s", [1, 2, 7, 10, 64])
def test_rec_full_matches_reference(s):
    """Lengths on either side of every power of two the scan doubles
    through, and S = 1 (no pass at all)."""
    rcfg = RGLRUConfig(lru_width=16, conv_width=4)
    tp, jp = _params()
    tx, jx = _x((2, s, 16), seed=s)
    y, st = rglru.rec_full(tp, rcfg, tx)
    jy, jst = j_rglru.rec_full(jp, JRGLRUConfig(lru_width=16, conv_width=4),
                               jx)
    _close(y, jy)
    _close(st["h"], jst["h"])
    _close(st["conv"], jst["conv"])
    assert st["h"].dtype == torch.float32 and st["h"].shape == (2, 16)
    assert st["conv"].shape == (2, 3, 16)


def test_rec_full_carries_h0_into_step_zero():
    rcfg = RGLRUConfig(lru_width=16, conv_width=4)
    tp, jp = _params(seed=1)
    tx, jx = _x((2, 9, 16), seed=2)
    th, jh = _x((2, 16), seed=3)
    y, st = rglru.rec_full(tp, rcfg, tx, h0=th)
    jy, jst = j_rglru.rec_full(jp, JRGLRUConfig(lru_width=16, conv_width=4),
                               jx, h0=jh)
    _close(y, jy)
    _close(st["h"], jst["h"])


@pytest.mark.parametrize("with_state", [False, True])
def test_conv_full_matches_reference(with_state):
    """The causal depthwise conv, taps summed in the reference's order,
    from zeros or from a carried history."""
    tp, jp = _params(seed=2)
    tx, jx = _x((2, 5, 16), seed=4)
    ts, js = _x((2, 3, 16), seed=5) if with_state else (None, None)
    out, st = rglru._conv_full(tp, tx, 4, ts)
    j_out, j_st = j_rglru._conv_full(jp, jx, 4, js)
    _close(out, j_out, 1e-6)
    _close(st, j_st, 0.0)


def test_rec_step_matches_reference_over_a_sequence():
    rcfg = RGLRUConfig(lru_width=16, conv_width=4)
    j_rcfg = JRGLRUConfig(lru_width=16, conv_width=4)
    tp, jp = _params(seed=3)
    tx, jx = _x((2, 6, 16), seed=6)
    st = rglru.init_rec_state(rcfg, 16, 2, torch.float32)
    jst = j_rglru.init_rec_state(j_rcfg, 16, 2, jnp.float32)
    for t in range(6):
        y, st = rglru.rec_step(tp, rcfg, tx[:, t:t + 1], st)
        jy, jst = j_rglru.rec_step(jp, j_rcfg, jx[:, t:t + 1], jst)
        _close(y, jy)
        _close(st["h"], jst["h"])
        _close(st["conv"], jst["conv"])


@pytest.mark.parametrize("s", [10, 33])
def test_log_depth_scan_equals_stepwise(s):
    """The reference's law (tests/test_models.py:162), in the port: the
    whole-sequence scan against one rec_step a token, 1e-4."""
    rcfg = RGLRUConfig(lru_width=16, conv_width=4)
    tp, _ = _params(seed=4)
    tx, _ = _x((2, s, 16), seed=7)
    y_full, st_full = rglru.rec_full(tp, rcfg, tx)
    st = rglru.init_rec_state(rcfg, 16, 2, torch.float32)
    ys = []
    for t in range(s):
        y_t, st = rglru.rec_step(tp, rcfg, tx[:, t:t + 1], st)
        ys.append(y_t[:, 0])
    np.testing.assert_allclose(y_full.numpy(), torch.stack(ys, 1).numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(st_full["h"].numpy(), st["h"].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_scan_is_the_recurrence():
    """``_scan`` against h_t = a_t h_{t-1} + b_t in float64, at lengths
    that are and are not powers of two."""
    g = torch.Generator().manual_seed(0)
    for s in (1, 2, 3, 8, 13, 100):
        a = torch.rand((3, s, 5), generator=g, dtype=torch.float64)
        b = torch.randn((3, s, 5), generator=g, dtype=torch.float64)
        h = torch.zeros((3, 5), dtype=torch.float64)
        want = []
        for t in range(s):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        torch.testing.assert_close(rglru._scan(a, b), torch.stack(want, 1),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_rec_tree_shapes_and_lambda(dtype):
    """The port's init_rec: the reference's leaves, shapes and dtypes
    (Lambda fp32 whatever the params' dtype), ``ba`` = -1 and ``conv_b``
    / ``bi`` zero, and Lambda from the reference's formula."""
    dt = getattr(torch, dtype)
    rcfg = RGLRUConfig(lru_width=48, conv_width=4)
    got = rglru.init_rec(Builder(torch.Generator().manual_seed(0), dtype=dt,
                                 device="cpu"), rcfg, 32)
    want, _ = j_params.split(j_rglru.init_rec(
        j_params.Builder(jax.random.PRNGKey(0), dtype=getattr(jnp, dtype)),
        JRGLRUConfig(lru_width=48, conv_width=4), 32))
    assert got.keys() == want.keys()
    for k in got:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).split(".")[-1] == want[k].dtype.name, k
    assert got["lam"].dtype == torch.float32
    assert (got["ba"] == -1).all() and not got["conv_b"].any()
    assert not got["bi"].any()
    np.testing.assert_allclose(got["lam"].numpy(), np.asarray(want["lam"]),
                               rtol=1e-5, atol=0)
    # a ~ U[0.9, 0.999] at r = 1
    a = torch.exp(-rglru._C * torch.nn.functional.softplus(got["lam"]))
    np.testing.assert_allclose(a[[0, -1]].numpy(), [0.9, 0.999], rtol=1e-5)
