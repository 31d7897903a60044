"""The port's multi-head latent attention (``repro_torch.models.mla``)
against the reference's ``repro.models.mla`` on minicpm3-4b's smoke
widths, with the reference's own params (through numpy): the full
path below and at the chunked threshold, the latents a prefill hands
the cache, the cache built on a ring, and decode absorbed and naive.

Tolerances:
  * fp32: 1e-5 (rtol and atol): the same fp32 math in other orders
    (seen below 1e-6).
  * bf16: the reference's 2e-2 / 5e-2 (tests/test_models.py): every
    product rounded to bf16 on both sides, in other orders. The caches
    are bf16 on both sides: their leaves within one bf16 ulp (2^-7
    relative) in fp32, 5e-2 in bf16.
  * absorbed against naive within the port: the reference's own 1e-3
    (tests/test_models.py:107), fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.models import mla as j_mla
from repro.models.params import Builder as JBuilder
from repro.models.params import split
from repro_torch.configs import registry
from repro_torch.models import api, layers, mla

torch.set_num_threads(1)

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 5e-2)}
ARCH = "minicpm3-4b"


def _cfgs(dtype):
    return (registry.get_smoke(ARCH).replace(dtype=dtype),
            j_registry.get_smoke(ARCH).replace(dtype=dtype))


_PARAMS = {}


def _params(dtype):
    """(port params, JAX params) of one MLA layer from the reference's
    ``init_mla``."""
    if dtype not in _PARAMS:
        _, j_cfg = _cfgs(dtype)
        j_p = split(j_mla.init_mla(
            JBuilder(jax.random.PRNGKey(0), dtype=getattr(jnp, dtype)),
            j_cfg.attention, j_cfg.d_model))[0]
        _PARAMS[dtype] = (api.params_from_numpy(
            jax.tree.map(np.asarray, j_p), "cpu"), j_p)
    return _PARAMS[dtype]


def _x(b, s, d, dtype, seed):
    a = np.random.RandomState(seed).randn(b, s, d).astype(np.float32)
    return (torch.from_numpy(a).to(getattr(torch, dtype)),
            jnp.asarray(a, getattr(jnp, dtype)))


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               rtol=TOL[dtype][0], atol=TOL[dtype][1])


@pytest.mark.parametrize("s", [1, 16, layers.CHUNKED_THRESHOLD])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_full_matches_reference(dtype, s):
    """S = 2048 takes the chunked path on both sides (the qk depth 12
    differs from the v depth 8: never the flash kernel)."""
    cfg, j_cfg = _cfgs(dtype)
    p, j_p = _params(dtype)
    b = 1 if s == layers.CHUNKED_THRESHOLD else 2
    x, xj = _x(b, s, cfg.d_model, dtype, seed=s)
    got, (c_kv, k_rope) = mla.mla_full(p, cfg.attention, x, torch.arange(s),
                                       cfg.d_model, return_latent=True)
    want, (j_c, j_r) = j_mla.mla_full(j_p, j_cfg.attention, xj,
                                      jnp.arange(s), cfg.d_model,
                                      return_latent=True)
    assert got.dtype == x.dtype and got.shape == (b, s, cfg.d_model)
    _close(got, want, dtype)
    assert c_kv.shape == j_c.shape and k_rope.shape == j_r.shape
    _close(c_kv, j_c, dtype)
    _close(k_rope, j_r, dtype)
    plain = mla.mla_full(p, cfg.attention, x, torch.arange(s), cfg.d_model)
    assert torch.equal(plain, got)


def test_mla_full_at_the_threshold_never_reaches_the_flash_op(monkeypatch):
    from repro_torch.kernels import ops

    def refuse(*a, **k):
        raise AssertionError("MLA reached the flash op")
    monkeypatch.setattr(ops, "flash_attention_gqa", refuse)
    cfg, _ = _cfgs("float32")
    p, _ = _params("float32")
    s = layers.CHUNKED_THRESHOLD
    x, _ = _x(1, s, cfg.d_model, "float32", seed=1)
    assert torch.isfinite(mla.mla_full(p, cfg.attention, x, torch.arange(s),
                                       cfg.d_model)).all()


@pytest.mark.parametrize("s,max_len", [(6, 8), (8, 8), (20, 8), (13, 32)])
def test_cache_from_latent_matches_reference(s, max_len):
    """The last min(S, max_len) latents, each in slot position %
    max_len: a ring when the prompt is longer than the cache."""
    cfg, j_cfg = _cfgs("float32")
    p, j_p = _params("float32")
    x, xj = _x(2, s, cfg.d_model, "float32", seed=2)
    _, (c_kv, k_rope) = mla.mla_full(p, cfg.attention, x, torch.arange(s),
                                     cfg.d_model, return_latent=True)
    _, (j_c, j_r) = j_mla.mla_full(j_p, j_cfg.attention, xj, jnp.arange(s),
                                   cfg.d_model, return_latent=True)
    got = mla.cache_from_latent(cfg.attention, c_kv, k_rope, max_len)
    want = j_mla.cache_from_latent(j_cfg.attention, j_c, j_r, max_len)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["slot_pos"].numpy(),
                                  np.asarray(want["slot_pos"]))
    for k in ("c_kv", "k_rope"):
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_allclose(got[k].float().numpy(), _np(want[k]),
                                   rtol=2 ** -7, atol=0)
    if s > max_len:
        assert sorted(got["slot_pos"].tolist()) == list(range(s - max_len,
                                                              s))


def test_init_mla_cache_matches_reference():
    cfg, j_cfg = _cfgs("bfloat16")
    got = mla.init_mla_cache(cfg.attention, 3, 10)
    want = j_mla.init_mla_cache(j_cfg.attention, 3, 10)
    assert got.keys() == want.keys()
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == want[k].dtype.name
        np.testing.assert_array_equal(got[k].float().numpy(), _np(want[k]))


@pytest.mark.parametrize("absorbed", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_reference(dtype, absorbed):
    """Three steps from a prefill's cache, the second past a slot that
    the ring reuses (prompt 10, cache 11: the third step wraps)."""
    cfg, j_cfg = _cfgs(dtype)
    p, j_p = _params(dtype)
    x, xj = _x(2, 10, cfg.d_model, dtype, seed=3)
    _, (c_kv, k_rope) = mla.mla_full(p, cfg.attention, x, torch.arange(10),
                                     cfg.d_model, return_latent=True)
    _, (j_c, j_r) = j_mla.mla_full(j_p, j_cfg.attention, xj,
                                   jnp.arange(10), cfg.d_model,
                                   return_latent=True)
    cache = mla.cache_from_latent(cfg.attention, c_kv, k_rope, 11)
    j_cache = j_mla.cache_from_latent(j_cfg.attention, j_c, j_r, 11)
    for pos in (10, 11, 12):
        h, hj = _x(2, 1, cfg.d_model, dtype, seed=pos)
        got, cache2 = mla.mla_decode(p, cfg.attention, h, pos, cache,
                                     cfg.d_model, absorbed=absorbed)
        want, j_cache = j_mla.mla_decode(j_p, j_cfg.attention, hj,
                                         jnp.asarray(pos), j_cache,
                                         cfg.d_model, absorbed=absorbed)
        assert cache2 is cache                       # written in place
        _close(got, want, dtype)
        np.testing.assert_array_equal(cache["slot_pos"].numpy(),
                                      np.asarray(j_cache["slot_pos"]))
        for k in ("c_kv", "k_rope"):
            tol = dict(rtol=2 ** -7, atol=0) if dtype == "float32" else \
                dict(rtol=0, atol=5e-2)
            np.testing.assert_allclose(cache[k].float().numpy(),
                                       _np(j_cache[k]), **tol)


def test_absorbed_equals_naive():
    """The reference's law (tests/test_models.py:107) in the port, fp32:
    weight-absorbed latent scoring == naive reconstruction."""
    cfg, _ = _cfgs("float32")
    p, _ = _params("float32")
    acfg = cfg.attention
    rng = np.random.RandomState(4)
    cache = mla.init_mla_cache(acfg, 2, 8, torch.float32)
    for pos in range(3):
        h = torch.from_numpy(rng.randn(2, 1, cfg.d_model).astype(np.float32))
        _, cache = mla.mla_decode(p, acfg, h, pos, cache, cfg.d_model)
    x = torch.from_numpy(rng.randn(2, 1, cfg.d_model).astype(np.float32))
    saved = {k: v.clone() for k, v in cache.items()}
    out_a, _ = mla.mla_decode(p, acfg, x, 3, cache, cfg.d_model,
                              absorbed=True)
    cache = saved
    out_n, _ = mla.mla_decode(p, acfg, x, 3, cache, cfg.d_model,
                              absorbed=False)
    np.testing.assert_allclose(out_a.numpy(), out_n.numpy(), rtol=1e-3,
                               atol=1e-3)


def test_init_mla_follows_the_reference_tree_and_dtypes():
    from repro_torch.models.params import Builder
    cfg, _ = _cfgs("bfloat16")
    got = mla.init_mla(Builder(torch.Generator().manual_seed(0),
                               dtype=torch.bfloat16, device="cpu"),
                       cfg.attention, cfg.d_model)
    _, want = _params("bfloat16")

    def leaves(t, pre=""):
        if isinstance(t, dict):
            return {k2: v2 for k, v in t.items()
                    for k2, v2 in leaves(v, f"{pre}/{k}").items()}
        return {pre: t}
    g, w = leaves(got), leaves(want)
    assert g.keys() == w.keys()
    for k in g:
        assert tuple(g[k].shape) == w[k].shape, k
        assert str(g[k].dtype).split(".")[-1] == w[k].dtype.name, k
