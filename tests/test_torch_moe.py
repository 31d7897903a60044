"""The port's fixed-capacity MoE (``repro_torch.models.moe``) against the
reference's ``repro.models.moe`` on the same numpy inputs and the
reference's own params (through numpy): the capacity, routing, dispatch
slots, the load-balance loss, the expert FFN and the whole layer.

Every comparison first asserts that the expert indices and dispatch
slots are equal (in fp32 both sides route alike), then compares values.

Tolerances:
  * fp32: 1e-5 (rtol and atol): the same fp32 math summed in other
    orders (router softmax, the expert products, the weighted sum over
    k; seen below 1e-6).
  * bf16: rtol 2e-2 (the reference's, tests/test_models.py) and atol
    two bf16 ulps of the largest output, 2^-6 max |y|: each side rounds
    the expert rows, of magnitude up to max |y|, to bf16 and sums k of
    them, so an output near zero can sit a rounding of its largest
    term away (seen: 0.055 at max |y| = 13).
  * indices, slots, the validity mask and the capacity: exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.models import moe as j_moe
from repro.models.params import Builder as JBuilder
from repro.models.params import split
from repro_torch.configs import base as t_base
from repro_torch.launch.mesh import Mesh
from repro_torch.models import api, moe
from repro_torch.models.params import Builder

torch.set_num_threads(1)

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2 ** -6)}


def _close(got, want, dtype):
    """fp32: rtol = atol = 1e-5; bf16: rtol 2e-2, atol 2^-6 max |y|."""
    rtol, atol = TOL[dtype]
    want = _np(want)
    if dtype == "bfloat16":
        atol *= np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=atol)

# (name, E, k, cf, dense residual): the kimi and arctic smoke configs'
# MoEs, one whose capacity factor drops choices, and a wider top-8
MCFGS = {
    "kimi-smoke": (8, 2, 2.0, None),
    "arctic-smoke": (8, 2, 2.0, 64),
    "dropping": (8, 2, 0.5, None),
    "top8-of-16": (16, 8, 1.25, None),
}


def _mcfgs(name):
    e, k, cf, res = MCFGS[name]
    kw = dict(n_experts=e, top_k=k, expert_ff=32, capacity_factor=cf,
              dense_residual_ff=res)
    return t_base.MoEConfig(**kw), j_base.MoEConfig(**kw)


def _params(name, dtype, d=24, seed=0):
    """(port params, JAX params) of one MoE layer from the reference's
    ``init_moe``."""
    _, j_m = _mcfgs(name)
    j_p = split(j_moe.init_moe(
        JBuilder(jax.random.PRNGKey(seed), dtype=getattr(jnp, dtype)), j_m,
        d))[0]
    return api.params_from_numpy(jax.tree.map(np.asarray, j_p), "cpu"), j_p


def _x(t, d, seed):
    return np.random.RandomState(seed).randn(t, d).astype(np.float32)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("t", [1, 4, 7, 64, 2048])
@pytest.mark.parametrize("name", sorted(MCFGS))
def test_capacity_matches_reference(name, t):
    m, j_m = _mcfgs(name)
    assert moe._capacity(t, m) == j_moe._capacity(t, j_m, 1)
    assert moe._capacity(t, m) % 8 == 0 and moe._capacity(t, m) >= 8


@pytest.mark.parametrize("name", sorted(MCFGS))
def test_route_matches_reference(name):
    m, j_m = _mcfgs(name)
    p, j_p = _params(name, "float32")
    x = _x(40, 24, seed=1)
    w, idx, probs = moe._route(torch.from_numpy(x), p["wr"], m)
    j_w, j_idx, j_probs = j_moe._route(jnp.asarray(x), j_p["wr"], j_m)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(w.numpy(), np.asarray(j_w), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(probs.numpy(), np.asarray(j_probs),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_route_breaks_ties_to_the_lower_index_as_top_k():
    """Equal router columns give equal probabilities: both keep the
    lower expert index first, as ``jax.lax.top_k`` does."""
    m, j_m = _mcfgs("top8-of-16")
    rng = np.random.RandomState(2)
    wr = rng.randn(24, 16).astype(np.float32)
    wr[:, 9] = wr[:, 3]
    wr[:, 12] = wr[:, 3]
    wr[:, 15] = wr[:, 0]
    x = _x(50, 24, seed=3)
    _, idx, probs = moe._route(torch.from_numpy(x), torch.from_numpy(wr), m)
    _, j_idx, _ = j_moe._route(jnp.asarray(x), jnp.asarray(wr), j_m)
    assert bool((probs[:, 9] == probs[:, 3]).all())
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))


@pytest.mark.parametrize("cap", [1, 3, 8, 64])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_slots_match_reference(k, cap):
    """Token-major ranks within each expert; past capacity, the drop
    slot E * C."""
    e = 16
    idx = np.stack([np.random.RandomState(i).choice(e, k, replace=False)
                    for i in range(37)]).astype(np.int32)
    slot, valid = moe._slots(torch.from_numpy(idx).long(), e, cap)
    j_slot, j_valid = j_moe._slots(jnp.asarray(idx), e, cap)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(j_slot))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    if cap == 1:
        assert not valid.all() and (slot[~valid] == e * cap).all()
    live = slot[valid]
    assert live.unique().numel() == live.numel()      # one choice a slot


@pytest.mark.parametrize("name", sorted(MCFGS))
def test_aux_loss_matches_reference(name):
    m, j_m = _mcfgs(name)
    p, j_p = _params(name, "float32")
    x = _x(33, 24, seed=4)
    _, idx, probs = moe._route(torch.from_numpy(x), p["wr"], m)
    _, j_idx, j_probs = j_moe._route(jnp.asarray(x), j_p["wr"], j_m)
    got = moe._aux_loss(probs, idx, m)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(),
                               float(j_moe._aux_loss(j_probs, j_idx, j_m)),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_ffn_matches_reference(dtype):
    p, j_p = _params("kimi-smoke", dtype)
    x = np.random.RandomState(5).randn(8, 8, 24).astype(np.float32)
    got = moe._expert_ffn(torch.from_numpy(x).to(getattr(torch, dtype)),
                          p["wg"], p["wu"], p["wd"])
    want = j_moe._expert_ffn(jnp.asarray(x, getattr(jnp, dtype)),
                             j_p["wg"], j_p["wu"], j_p["wd"])
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("t", [5, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(MCFGS))
def test_moe_local_matches_reference(name, dtype, t):
    m, j_m = _mcfgs(name)
    p, j_p = _params(name, dtype)
    x = _x(t, 24, seed=6 + t)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x, getattr(jnp, dtype))
    # the routing first: the same experts and the same slots
    cap = moe._capacity(t, m)
    _, idx, _ = moe._route(xt.float(), p["wr"], m)
    _, j_idx, _ = j_moe._route(xj.astype(jnp.float32), j_p["wr"], j_m)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    slot, valid = moe._slots(idx, m.n_experts, cap)
    j_slot, j_valid = j_moe._slots(j_idx, m.n_experts, cap)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(j_slot))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    if name == "dropping" and t == 64:
        assert not valid.all()                    # choices do drop
    y, aux = moe._moe_local(xt, p, m)
    j_y, j_aux = j_moe._moe_local(xj, j_p, j_m)
    assert y.dtype == xt.dtype and y.shape == (t, 24)
    _close(y, j_y, dtype)
    np.testing.assert_allclose(aux.item(), float(j_aux), rtol=1e-5)


def test_dropped_choices_add_nothing():
    """A token all of whose choices were dropped gets zeros; one with a
    choice left gets that expert's row times its weight alone."""
    m, _ = _mcfgs("dropping")
    p, _ = _params("dropping", "float32")
    x = torch.from_numpy(_x(64, 24, seed=9))
    y, _ = moe._moe_local(x, p, m)
    w, idx, _ = moe._route(x, p["wr"], m)
    cap = moe._capacity(64, m)
    _, valid = moe._slots(idx, m.n_experts, cap)
    valid = valid.view(64, m.top_k)
    none = ~valid.any(-1)
    assert none.any()
    assert not y[none].any()
    one = valid.sum(-1) == 1
    t = int(torch.nonzero(one)[0])
    j = int(torch.nonzero(valid[t])[0])
    e = int(idx[t, j])
    row = moe._expert_ffn(x[t][None, None], p["wg"][e:e + 1],
                          p["wu"][e:e + 1], p["wd"][e:e + 1])[0, 0]
    torch.testing.assert_close(y[t], row * w[t, j], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["kimi-smoke", "dropping"])
def test_apply_moe_matches_reference(name, dtype):
    m, j_m = _mcfgs(name)
    p, j_p = _params(name, dtype)
    x = np.random.RandomState(7).randn(2, 12, 24).astype(np.float32)
    y, aux = moe.apply_moe(p, m, torch.from_numpy(x).to(getattr(torch,
                                                                dtype)))
    j_y, j_aux = j_moe.apply_moe(j_p, j_m, jnp.asarray(x,
                                                       getattr(jnp, dtype)))
    assert y.shape == (2, 12, 24)
    _close(y, j_y, dtype)
    np.testing.assert_allclose(aux.item(), float(j_aux), rtol=1e-5)


def test_apply_moe_gradients_match_reference():
    """fp32: the gradients of a scalar of the layer's output plus its aux
    loss, for the input and every param, against ``jax.grad``."""
    m, j_m = _mcfgs("dropping")
    p, j_p = _params("dropping", "float32")
    x = np.random.RandomState(8).randn(2, 10, 24).astype(np.float32)
    proj = np.random.RandomState(9).randn(24).astype(np.float32)

    def j_f(j_p, xj):
        y, aux = j_moe.apply_moe(j_p, j_m, xj)
        return (y @ jnp.asarray(proj)).sum() + aux

    j_gp, j_gx = jax.grad(j_f, argnums=(0, 1))(j_p, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe.apply_moe(leaves, m, xt)
    ((y @ torch.from_numpy(proj)).sum() + aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_gx),
                               rtol=1e-5, atol=1e-5)
    for k, v in leaves.items():
        ref = np.asarray(j_gp[k])
        np.testing.assert_allclose(v.grad.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


def test_init_moe_follows_the_reference_shapes_dtypes_and_scales():
    """Router fp32 (d, E); experts in the builder's dtype. The scale is
    the reference's fan_in = shape[0] rule, which is E for the experts,
    not d (recorded in ROADMAP Queue 3)."""
    m, _ = _mcfgs("top8-of-16")
    d = 64
    p = moe.init_moe(Builder(torch.Generator().manual_seed(0),
                             dtype=torch.bfloat16, device="cpu"), m, d)
    _, j_p = _params("top8-of-16", "bfloat16", d=d)
    for k, v in p.items():
        assert tuple(v.shape) == j_p[k].shape
        assert str(v.dtype).split(".")[-1] == j_p[k].dtype.name
    assert p["wr"].dtype == torch.float32
    for k, fan_in in (("wr", d), ("wg", 16), ("wd", 16)):
        std = p[k].float().std().item()
        assert abs(std - fan_in ** -0.5) < 0.05 * fan_in ** -0.5, k


def test_apply_moe_refuses_a_mesh():
    m, _ = _mcfgs("kimi-smoke")
    p, _ = _params("kimi-smoke", "float32")
    x = torch.randn(1, 3, 24, generator=torch.Generator().manual_seed(0))
    # a mesh the sequence does not divide takes the local path, as the
    # reference's does (the expert-parallel path is held across gloo
    # ranks in test_torch_mesh2d.py); so does a one-rank mesh
    y, _ = moe.apply_moe(p, m, x, mesh=Mesh((("model", None, 0, 2),)))
    assert torch.equal(y, moe.apply_moe(p, m, x)[0])
    y, _ = moe.apply_moe(p, m, x, mesh=Mesh((("model", None, 0, 1),)))
    assert torch.equal(y, moe.apply_moe(p, m, x)[0])


def test_config_copies_equal_the_reference():
    for name in MCFGS:
        m, j_m = _mcfgs(name)
        assert dataclasses.asdict(m) == dataclasses.asdict(j_m)
