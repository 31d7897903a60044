"""The port's RWKV-6 blocks (``repro_torch.models.rwkv6``) against the
reference's ``repro.models.rwkv6`` on the same numpy inputs and the
reference's own params (carried across through numpy).

Tolerances:
  * fp32 against the reference's same form (sequential against its
    sequential, chunked against its chunked), 1e-5: the same ops in the
    same order, products summed in another order.
  * the port's chunked form against its own sequential form: the
    reference's 1e-3 for its own two forms (tests/test_models.py:130-144;
    the chunked form divides by exp(cum) where the sequential one
    multiplies by w step by step).
  * state carry (a prefix, then the rest from its state, against the
    whole sequence): the reference's 1e-4 (tests/test_models.py:146).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RWKVConfig as JRWKVConfig
from repro.models import params as j_params
from repro.models import rwkv6 as j_rwkv6
from repro_torch.configs.base import RWKVConfig
from repro_torch.models import api, rwkv6
from repro_torch.models.params import Builder

torch.set_num_threads(1)

TOL = 1e-5
RCFG = dict(head_dim=8, decay_lora=8, token_shift_lora=4, chunk_size=8)


def _time_mix(d=32, seed=0):
    jp, _ = j_params.split(j_rwkv6.init_time_mix(
        j_params.Builder(jax.random.PRNGKey(seed), dtype=jnp.float32),
        JRWKVConfig(**RCFG), d))
    return api.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), jp


def _x(shape, seed=0):
    a = (np.random.RandomState(seed).randn(*shape) * 0.3).astype(np.float32)
    return torch.from_numpy(a), jnp.asarray(a)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("s", [1, 8, 12, 32])
def test_time_mix_matches_reference(chunked, s):
    """Both forms against the reference's same form; where the chunk
    does not divide S (12) or S = 1 both sides take the sequential form
    (``rwkv6.py:155``)."""
    tp, jp = _time_mix()
    tx, jx = _x((2, s, 32), seed=s)
    y, st = rwkv6.time_mix_full(tp, RWKVConfig(**RCFG), tx, chunked=chunked)
    jy, jst = j_rwkv6.time_mix_full(jp, JRWKVConfig(**RCFG), jx,
                                    chunked=chunked)
    _close(y, jy)
    _close(st["S"], jst["S"])
    _close(st["x_prev"], jst["x_prev"], 0.0)
    assert st["S"].dtype == torch.float32 and st["S"].shape == (2, 4, 8, 8)


def test_chunked_equals_sequential():
    """The reference's law (tests/test_models.py:130) in the port."""
    tp, _ = _time_mix()
    tx, _ = _x((2, 32, 32), seed=9)
    y_seq, st_seq = rwkv6.time_mix_full(tp, RWKVConfig(**RCFG), tx,
                                        chunked=False)
    y_chk, st_chk = rwkv6.time_mix_full(tp, RWKVConfig(**RCFG), tx,
                                        chunked=True)
    np.testing.assert_allclose(y_seq.numpy(), y_chk.numpy(), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(st_seq["S"].numpy(), st_chk["S"].numpy(),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("chunked", [False, True])
def test_state_carry_equals_full_sequence(chunked):
    """[a; b] at once == a, then b from a's state (the reference's law,
    tests/test_models.py:146), and the carried step against the
    reference's."""
    tp, jp = _time_mix(d=16, seed=1)
    tx, jx = _x((1, 16, 16), seed=10)
    rcfg = RWKVConfig(**RCFG)
    y_full, _ = rwkv6.time_mix_full(tp, rcfg, tx, chunked=chunked)
    _, st = rwkv6.time_mix_full(tp, rcfg, tx[:, :8], chunked=chunked)
    y2, _ = rwkv6.time_mix_full(tp, rcfg, tx[:, 8:], state=st,
                                chunked=chunked)
    np.testing.assert_allclose(y_full[:, 8:].numpy(), y2.numpy(), rtol=1e-4,
                               atol=1e-4)
    _, jst = j_rwkv6.time_mix_full(jp, JRWKVConfig(**RCFG), jx[:, :8],
                                   chunked=chunked)
    jy2, _ = j_rwkv6.time_mix_full(jp, JRWKVConfig(**RCFG), jx[:, 8:],
                                   state=jst, chunked=chunked)
    _close(y2, jy2)


def test_wkv_scan_and_chunked_match_reference_from_a_state():
    """The two WKV forms alone, from a nonzero state."""
    rng = np.random.RandomState(3)
    r, k, v = (rng.randn(2, 16, 3, 8).astype(np.float32) * 0.5
               for _ in range(3))
    w = rng.uniform(0.5, 1.0, (2, 16, 3, 8)).astype(np.float32)
    u = rng.randn(3, 8).astype(np.float32) * 0.1
    s0 = rng.randn(2, 3, 8, 8).astype(np.float32) * 0.1
    t = [torch.from_numpy(a) for a in (r, k, v, w, u, s0)]
    j = [jnp.asarray(a) for a in (r, k, v, w, u, s0)]
    for got, want in ((rwkv6._wkv_scan(*t), j_rwkv6._wkv_scan(*j)),
                      (rwkv6._wkv_chunked(*t, 8),
                       j_rwkv6._wkv_chunked(*j, 8))):
        _close(got[0], want[0])
        _close(got[1], want[1])


@pytest.mark.parametrize("with_state", [False, True])
def test_channel_mix_matches_reference(with_state):
    jp, _ = j_params.split(j_rwkv6.init_channel_mix(
        j_params.Builder(jax.random.PRNGKey(2), dtype=jnp.float32), 16, 48))
    tp = api.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tx, jx = _x((2, 5, 16), seed=11)
    tst, jst = (None, None)
    if with_state:
        tprev, jprev = _x((2, 16), seed=12)
        tst, jst = {"x_prev": tprev}, {"x_prev": jprev}
    y, st = rwkv6.channel_mix_full(tp, tx, tst)
    jy, jst2 = j_rwkv6.channel_mix_full(jp, jx, jst)
    _close(y, jy)
    _close(st["x_prev"], jst2["x_prev"], 0.0)


def test_inits_follow_the_reference_tree():
    """Leaves, shapes and dtypes of both inits and both state inits;
    ``w_base`` -6 and ``ln_w`` ones, fp32 whatever the params' dtype."""
    b = Builder(torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                device="cpu")
    jb = j_params.Builder(jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    pairs = [(rwkv6.init_time_mix(b, RWKVConfig(**RCFG), 32),
              j_params.split(j_rwkv6.init_time_mix(jb, JRWKVConfig(**RCFG),
                                                   32))[0]),
             (rwkv6.init_channel_mix(b, 32, 48),
              j_params.split(j_rwkv6.init_channel_mix(jb, 32, 48))[0]),
             (rwkv6.init_tm_state(RWKVConfig(**RCFG), 32, 3),
              j_rwkv6.init_tm_state(JRWKVConfig(**RCFG), 32, 3)),
             (rwkv6.init_cm_state(32, 3), j_rwkv6.init_cm_state(32, 3))]
    for got, want in pairs:
        assert got.keys() == want.keys()
        for k in got:
            assert tuple(got[k].shape) == want[k].shape, k
            assert str(got[k].dtype).split(".")[-1] == want[k].dtype.name, k
    tm = pairs[0][0]
    assert (tm["w_base"] == -6).all() and (tm["ln_w"] == 1).all()
