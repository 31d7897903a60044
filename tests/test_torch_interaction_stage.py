"""The dense engine's interaction stage as one op, on the CPU.

``ops.feature_interaction`` is the stage (features, the kept pairs of X
X^T, the concat with the bottom MLP's output) and its VJP; on the card it
is one ``interaction`` launch each way (``csrc/interaction.cu``), which
``chip_smoke.py`` phase 2 holds against the plain versions here. On the
CPU: the op against the JAX ``dense_engine.feature_interaction`` (both
outputs, the reference's interaction through its XLA oracle and through
the Pallas kernel in interpret mode) and its gradients against
``jax.grad`` through the reference; ``ref.feature_interaction_backward``
against autograd of ``ref.feature_interaction``; a numpy model of the
kernel's pair enumeration against ``jnp.tril_indices``; the dense engine
calling the op; and the wrappers' guards.

Tolerances (fp32; XLA, torch and the kernel sum in different orders):
  * the kept pairs: D <= 32 products of O(1) values -> rtol=atol=1e-5;
    the features and the bottom copy are copies -> exact;
  * the gradients: F - 1 <= 50 products of O(1) values plus the
    pass-throughs -> rtol=atol=1e-5;
  * the pair enumeration is integer arithmetic -> exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dense_engine as j_de
from repro.kernels import ops as j_ops
from repro_torch.core import dense_engine as t_de
from repro_torch.kernels import embedding_gather as t_eg
from repro_torch.kernels import feature_interaction as t_fi
from repro_torch.kernels import fused_dispatch as t_fd
from repro_torch.kernels import gemm as t_gm
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

# (B, T, D): batches of 1, 9 and 32; DLRM(1)'s 5 tables (F = 6), 3, and
# the 50 tables of DLRM(2), (4) and (5) (F = 51); the smoke config's and
# Table I's widths
SHAPES = [(b, t, d) for b in (1, 9, 32) for t in (3, 5, 50)
          for d in (16, 32)]
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(b, t, d):
    rng = np.random.RandomState(b * 1000 + t * 10 + d)
    bot = rng.randn(b, d).astype(np.float32)
    emb = rng.randn(b, t, d).astype(np.float32)
    p = (t + 1) * t // 2
    g = rng.randn(b, d + p).astype(np.float32)
    gf = rng.randn(b, t + 1, d).astype(np.float32)
    return bot, emb, g, gf


@pytest.fixture(params=["xla", "interpret"])
def j_impl(request):
    """The reference's interaction through its XLA oracle or its Pallas
    kernel in interpret mode; the JAX package's setting is restored."""
    before = j_ops._IMPL
    j_ops.set_impl(request.param)
    try:
        yield request.param
    finally:
        j_ops.set_impl(before)


# ---------------------------------------------------------------------------
# the op against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,t,d", SHAPES)
def test_feature_interaction_matches_jax(j_impl, b, t, d):
    bot, emb, _, _ = _inputs(b, t, d)
    out, feats = ops.feature_interaction(_t(bot), _t(emb))
    want_out, want_feats = j_de.feature_interaction(jnp.asarray(bot),
                                                    jnp.asarray(emb))
    p = (t + 1) * t // 2
    assert out.shape == (b, d + p) and out.dtype == torch.float32
    np.testing.assert_array_equal(feats.numpy(), np.asarray(want_feats))
    np.testing.assert_array_equal(out[:, :d].numpy(), bot)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)


@pytest.mark.parametrize("b,t,d", SHAPES)
def test_feature_interaction_grads_match_jax(b, t, d):
    """Gradients of both inputs through both outputs (a cotangent for the
    output and one for the features) against jax.grad of the reference."""
    bot, emb, g, gf = _inputs(b, t, d)
    tb, te = _t(bot).requires_grad_(), _t(emb).requires_grad_()
    out, feats = ops.feature_interaction(tb, te)
    d_bot, d_emb = torch.autograd.grad((out, feats), (tb, te),
                                       (_t(g), _t(gf)))

    def loss(a, e):
        o, f = j_de.feature_interaction(a, e)
        return jnp.sum(o * g) + jnp.sum(f * gf)

    want_bot, want_emb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(bot),
                                                       jnp.asarray(emb))
    np.testing.assert_allclose(d_bot.numpy(), np.asarray(want_bot), **TOL)
    np.testing.assert_allclose(d_emb.numpy(), np.asarray(want_emb), **TOL)


@pytest.mark.parametrize("which", ["out", "feats"])
def test_feature_interaction_grads_of_one_output(which):
    """A loss of one output alone: the other's gradient never
    materialises (None in the backward), as in the DLRM head, which
    drops the features."""
    bot, emb, g, gf = _inputs(9, 5, 16)
    tb, te = _t(bot).requires_grad_(), _t(emb).requires_grad_()
    out, feats = ops.feature_interaction(tb, te)
    y, cot = (out, g) if which == "out" else (feats, gf)
    d_bot, d_emb = torch.autograd.grad(y, (tb, te), _t(cot))

    def loss(a, e):
        o, f = j_de.feature_interaction(a, e)
        return jnp.sum((o if which == "out" else f) * cot)

    want_bot, want_emb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(bot),
                                                       jnp.asarray(emb))
    np.testing.assert_allclose(d_bot.numpy(), np.asarray(want_bot), **TOL)
    np.testing.assert_allclose(d_emb.numpy(), np.asarray(want_emb), **TOL)


@pytest.mark.parametrize("with_feats_grad", [False, True])
@pytest.mark.parametrize("b,t,d", [(1, 3, 16), (9, 5, 32), (4, 50, 16)])
def test_plain_backward_matches_autograd(b, t, d, with_feats_grad):
    """``ref.feature_interaction_backward``, what the card's backward
    kernel is held against, against autograd of the plain forward."""
    bot, emb, g, gf = _inputs(b, t, d)
    tb, te = _t(bot).requires_grad_(), _t(emb).requires_grad_()
    out, feats = ref.feature_interaction(tb, te)
    ys, cots = (out,), (_t(g),)
    if with_feats_grad:
        ys, cots = (out, feats), (_t(g), _t(gf))
    want_bot, want_emb = torch.autograd.grad(ys, (tb, te), cots)
    d_bot, d_emb = ref.feature_interaction_backward(
        _t(g), _t(gf) if with_feats_grad else None, _t(bot), _t(emb))
    assert d_bot.shape == (b, d) and d_emb.shape == (b, t, d)
    torch.testing.assert_close(d_bot, want_bot, **TOL)
    torch.testing.assert_close(d_emb, want_emb, **TOL)


def test_dense_engine_calls_the_stage_op(monkeypatch):
    """The dense engine's stage is the one op (one launch on the card);
    the old composition through ``interaction_tril`` is off the path."""
    calls = []
    real = ops.feature_interaction

    def spy(bottom_out, reduced_embs):
        calls.append((tuple(bottom_out.shape), tuple(reduced_embs.shape)))
        return real(bottom_out, reduced_embs)

    def refuse(x):
        raise AssertionError("interaction_tril is off the dense path")

    monkeypatch.setattr(ops, "feature_interaction", spy)
    monkeypatch.setattr(ops, "interaction_tril", refuse)
    bot, emb, _, _ = _inputs(9, 5, 16)
    out, feats = t_de.feature_interaction(_t(bot), _t(emb))
    assert calls == [((9, 16), (9, 5, 16))]
    want_out, want_feats = ref.feature_interaction(_t(bot), _t(emb))
    assert torch.equal(out, want_out) and torch.equal(feats, want_feats)


# ---------------------------------------------------------------------------
# the kernel's pair enumeration, modelled in numpy
# ---------------------------------------------------------------------------

def pair_of(p: np.ndarray):
    """csrc/interaction.cu's pair_of: the row guessed in float32 from the
    inverse of p = i (i - 1) / 2 + j, then corrected in integers."""
    p = np.asarray(p, dtype=np.int64)
    guess = (np.float32(1) + np.sqrt(np.float32(8) * p.astype(np.float32)
                                     + np.float32(1))) * np.float32(0.5)
    r = guess.astype(np.int64)
    while np.any(r * (r - 1) // 2 > p):
        r = np.where(r * (r - 1) // 2 > p, r - 1, r)
    while np.any((r + 1) * r // 2 <= p):
        r = np.where((r + 1) * r // 2 <= p, r + 1, r)
    return r, p - r * (r - 1) // 2


@pytest.mark.parametrize("f", list(range(1, 52)))
def test_pair_enumeration_is_jnp_tril_order(f):
    """Pair p of the forward is (i, j) of jnp.tril_indices(F, k=-1), and
    the backward's index of (i, j) or (j, i) is p again."""
    p = np.arange(f * (f - 1) // 2)
    i, j = pair_of(p)
    li, lj = jnp.tril_indices(f, k=-1)
    np.testing.assert_array_equal(i, np.asarray(li))
    np.testing.assert_array_equal(j, np.asarray(lj))
    for a, c in ((i, j), (j, i)):
        hi, lo = np.maximum(a, c), np.minimum(a, c)
        np.testing.assert_array_equal(hi * (hi - 1) // 2 + lo, p)


# ---------------------------------------------------------------------------
# the wrappers' guards: CUDA tensors only, refused before any build
# ---------------------------------------------------------------------------

def _counts():
    return ({m: m.launches for m in (t_fd, t_gm, t_fi, t_eg)},
            t_fd.cached_launches, t_eg.bag_launches, t_eg.sls_launches,
            t_fd.int4_launches)


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_stage_wrappers_refuse_cpu_tensors(which):
    """A wrapper launches its kernel or raises; it never computes on the
    CPU (and never builds anything to find that out)."""
    before = _counts()
    with pytest.raises(ValueError, match="CUDA device"):
        if which == "forward":
            t_fi.feature_interaction(torch.ones(2, 4), torch.ones(2, 3, 4))
        else:
            t_fi.feature_interaction_backward(
                torch.ones(2, 10), None, torch.ones(2, 4),
                torch.ones(2, 3, 4))
    assert _counts() == before


@pytest.fixture
def any_device(monkeypatch):
    """The wrappers' checks as they run on CUDA tensors: ``require``
    with its device test passed; building or launching fails the test."""
    from repro_torch.kernels import _build
    real = _build.require

    def require(t, name, *, dtype, ndim):
        try:
            real(t, name, dtype=dtype, ndim=ndim)
        except ValueError as e:
            if "CUDA device" not in str(e):
                raise

    def no_build(*a, **k):
        raise AssertionError("built or launched")

    monkeypatch.setattr(_build, "require", require)
    monkeypatch.setattr(_build, "function", no_build)


_G = torch.ones(2, 10)
_BOT = torch.ones(2, 4)
_EMB = torch.ones(2, 3, 4)
_BAD = {
    "f64 bottom": (lambda: t_fi.feature_interaction(_BOT.double(), _EMB),
                   "float32"),
    "bf16 embs": (lambda: t_fi.feature_interaction(_BOT, _EMB.bfloat16()),
                  "float32"),
    "2-d embs": (lambda: t_fi.feature_interaction(_BOT, torch.ones(2, 12)),
                 "3 dims"),
    "non-contiguous embs": (
        lambda: t_fi.feature_interaction(
            _BOT, torch.ones(2, 4, 3).transpose(1, 2)), "contiguous"),
    "bottom of another batch": (
        lambda: t_fi.feature_interaction(torch.ones(3, 4), _EMB),
        r"expected \(2, 4\)"),
    "bottom of another width": (
        lambda: t_fi.feature_interaction(torch.ones(2, 5), _EMB),
        r"expected \(2, 4\)"),
    "past shared memory": (
        lambda: t_fi.feature_interaction(torch.ones(1, 64),
                                         torch.ones(1, 900, 64)),
        "shared memory"),
    "full matrix past shared memory": (
        lambda: t_fi.interaction(torch.ones(1, 1000, 64)), "shared memory"),
    "f64 g": (lambda: t_fi.feature_interaction_backward(
        _G.double(), None, _BOT, _EMB), "float32"),
    "g of another width": (lambda: t_fi.feature_interaction_backward(
        torch.ones(2, 9), None, _BOT, _EMB), r"expected \(2, 10\)"),
    "non-contiguous g_feats": (lambda: t_fi.feature_interaction_backward(
        _G, torch.ones(2, 4, 4).transpose(1, 2), _BOT, _EMB), "contiguous"),
    "g_feats of another shape": (lambda: t_fi.feature_interaction_backward(
        _G, torch.ones(2, 3, 4), _BOT, _EMB), r"expected \(2, 4, 4\)"),
    "backward past shared memory": (
        lambda: t_fi.feature_interaction_backward(
            torch.ones(1, 64 + 900 * 899 // 2), None, torch.ones(1, 64),
            torch.ones(1, 899, 64)), "shared memory"),
}


@pytest.mark.parametrize("name", sorted(_BAD))
def test_stage_wrappers_refuse(any_device, name):
    """What the kernels cannot take is refused before a build: dtypes,
    ranks, strides, mismatched shapes and samples past the 227 KB of
    shared memory."""
    fn, msg = _BAD[name]
    before = _counts()
    with pytest.raises(ValueError, match=msg):
        fn()
    assert _counts() == before


def test_stage_op_refuses_other_and_mixed_devices():
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.feature_interaction(torch.ones(2, 4, device="meta"),
                                torch.ones(2, 3, 4, device="meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.feature_interaction(torch.ones(2, 4),
                                torch.ones(2, 3, 4, device="meta"))


@pytest.mark.parametrize("f", [2, 6, 51])
def test_n_pairs(f):
    assert t_fi.n_pairs(f) == len(np.asarray(jnp.tril_indices(f, k=-1)[0]))
