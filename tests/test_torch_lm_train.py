"""The port's LM training path against the JAX package, for the three
smoke configs (smollm-360m, h2o-danube-1.8b, qwen1.5-4b): the chunked
attention and the flash op's backward, the loss, gradients and
``make_train_step`` (accumulation, clipping), ``default_optimizer``,
``LMSynthetic``, the ``Prefetcher`` and the launcher's LM half. Params
come from the reference's ``api.init`` through numpy.

Tolerances:
  * fp32: attention outputs and gradients, losses and grad norms within
    1e-5 (relative, or of the leaf's largest gradient): the same fp32
    math summed in other orders (seen: 2e-6).
  * bf16: the reference's own 2e-2 on attention outputs
    (tests/test_models.py) and 5e-2 of a leaf's largest gradient: every
    matmul output is rounded to bf16 on both sides, in other orders
    (seen: 2.2e-2). Losses within 2e-3 and grad norms within 5e-3,
    relative (seen: 1e-4 and 2e-3).
  * train steps: AdamW's first steps move a param by ~lr * sign(g), so an
    element whose gradient is within rounding of zero may step the other
    way on one side: params agree within 1e-5 (fp32) but for at most
    1e-3 of the elements, and none further apart than 2 lr a step; in
    bf16 within one bf16 ulp of the param (2^-7 |p|) plus 2 lr a step,
    since each side rounds each step's result to bf16.
  * within the port, exactly: the op's backward against autograd
    through ``_sdpa_chunked``, remat on against off, a resumed launcher
    run against an uninterrupted one.
"""
import io
import time
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.configs import registry as j_registry
from repro.data import LMSynthetic as JLMSynthetic
from repro.models import api as j_api
from repro.models import embedding as j_emb
from repro.models import layers as j_layers
from repro_torch.configs import base as t_base
from repro_torch.configs import registry
from repro_torch.data import LMSynthetic, Prefetcher, make_placer
from repro_torch.kernels import ops
from repro_torch.launch import train as t_train
from repro_torch.models import api, embedding, layers, transformer
from repro_torch.optim import tree_leaves, tree_map

torch.set_num_threads(1)

ARCHS = ("smollm-360m", "h2o-danube-1.8b", "qwen1.5-4b")
LR = 3e-4                      # default_optimizer's
CLIP = 0.1                     # below every smoke grad norm (~2.1-2.8)


def _cfgs(arch, dtype):
    return (registry.get_smoke(arch).replace(dtype=dtype),
            j_registry.get_smoke(arch).replace(dtype=dtype))


def _params(arch, dtype):
    """(port params on the CPU, JAX params) from the reference's init;
    fresh each call, since the port's train step works in place."""
    _, j_cfg = _cfgs(arch, dtype)
    j_params = j_api.init(jax.random.PRNGKey(0), j_cfg)[0]
    return (api.params_from_numpy(jax.tree.map(np.asarray, j_params), "cpu"),
            j_params)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _tokens(cfg, b, s, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _grads(params, cfg, tokens, remat=True):
    """(loss, grads) of the port's loss by autograd."""
    req = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = api.loss(req, cfg, {"tokens": torch.from_numpy(tokens)},
                    remat=remat)
    it = iter(torch.autograd.grad(loss, tree_leaves(req)))
    return loss.detach(), tree_map(lambda _: next(it), req)


def _grads_close(got, want, tol):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for name in g:
        assert g[name].dtype == getattr(torch, str(w[name].dtype)), name
        ref = _np(w[name])
        err = np.abs(g[name].float().numpy() - ref).max()
        assert err <= tol * np.abs(ref).max(), (name, err, np.abs(ref).max())


# ---------------------------------------------------------------------------
# the chunked attention and the flash op's backward
# ---------------------------------------------------------------------------

def _qkvg(b, s, kh, g, hd, dtype, seed=0):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(b, s, kh, g, hd), rng.randn(b, s, kh, hd),
            rng.randn(b, s, kh, hd), rng.randn(b, s, kh, g, hd)]
    return [a.astype(np.float32) for a in arrs], dtype


def _as(a, dtype):
    return (torch.from_numpy(a).to(getattr(torch, dtype)),
            jnp.asarray(a, getattr(jnp, dtype)))


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)],
                         ids=["causal", "window", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_chunked_and_its_gradients_match_reference(causal, window,
                                                        dtype):
    """GQA (2 kv heads of 3 queries), 64 positions in q chunks of 16 and
    kv chunks of 32: the output and the gradients of q, k and v."""
    (q, k, v, g), _ = _qkvg(2, 64, 2, 3, 8, dtype)
    pos = np.arange(64)
    tq, jq = _as(q, dtype)
    tk, jk = _as(k, dtype)
    tv, jv = _as(v, dtype)
    tg, jg = _as(g, dtype)
    tq, tk, tv = (t.requires_grad_() for t in (tq, tk, tv))
    out = layers._sdpa_chunked(tq, tk, tv, torch.from_numpy(pos),
                               torch.from_numpy(pos), causal, window, 16, 32)
    grads = torch.autograd.grad(out, (tq, tk, tv), tg)

    def f(q_, k_, v_):
        return j_layers._sdpa_chunked(q_, k_, v_, jnp.asarray(pos),
                                      jnp.asarray(pos), causal, window,
                                      16, 32)
    want, vjp = jax.vjp(f, jq, jk, jv)
    assert out.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.detach().float().numpy(), _np(want),
                               rtol=tol, atol=tol)
    for got, w in zip(grads, vjp(jg)):
        w = _np(w)
        assert np.abs(got.float().numpy() - w).max() <= tol * max(
            1.0, np.abs(w).max())


def test_sdpa_chunked_refuses_chunks_that_do_not_divide():
    (q, k, v, _), _ = _qkvg(1, 48, 1, 1, 4, "float32")
    pos = torch.arange(48)
    with pytest.raises(ValueError, match="do not divide"):
        layers._sdpa_chunked(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), pos, pos, True, None, 32,
                             16)


@pytest.mark.parametrize("s,window", [(64, None), (2048, None), (2048, 300)],
                         ids=["S64", "S2048", "S2048_window"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_backward_is_autograd_through_the_chunked_path(s, window, dtype):
    """The op's gradients equal autograd through ``_sdpa_chunked`` at the
    op's chunks (``pick_chunk(S, 1024)``) bit for bit, and two backward
    passes agree bit for bit."""
    (q, k, v, g), _ = _qkvg(1, s, 1, 3, 20, dtype, seed=s)
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype))
               .requires_grad_() for a in (q, k, v))
    g = torch.from_numpy(g).to(getattr(torch, dtype)).reshape(1, s, 3, 20)
    h = q.reshape(1, s, 3, 20)
    out = ops.flash_attention_gqa(h, k, v, causal=True, window=window)
    got = torch.autograd.grad(out, (q, k, v), g)
    again = torch.autograd.grad(
        ops.flash_attention_gqa(h, k, v, causal=True, window=window),
        (q, k, v), g)
    pos = torch.arange(s)
    c = layers.pick_chunk(s, layers.Q_CHUNK)
    ref = layers._sdpa_chunked(q, k, v, pos, pos, True, window, c, c)
    want = torch.autograd.grad(ref.reshape(1, s, 3, 20), (q, k, v), g)
    for a, b, w in zip(got, again, want):
        assert a.dtype == w.dtype and torch.equal(a, w)
        assert torch.equal(a, b)


def _attn_params(arch, dtype):
    params, j_params = _params(arch, dtype)
    return (transformer._layer(params["layers"], 0)["attn"],
            jax.tree.map(lambda a: a[0], j_params["layers"])["attn"])


@pytest.mark.parametrize("arch", ["smollm-360m", "h2o-danube-1.8b"])
def test_attention_full_gradients_at_the_flash_threshold(arch):
    """S = 2048 takes the op (its plain version forward, the chunked
    recompute backward); the reference takes its chunked path off the
    TPU, and ``jax.grad`` differentiates it. fp32, danube's window of
    16 included."""
    cfg, j_cfg = _cfgs(arch, "float32")
    p, j_p = _attn_params(arch, "float32")
    s = layers.CHUNKED_THRESHOLD
    rng = np.random.RandomState(7)
    x = rng.randn(1, s, cfg.d_model).astype(np.float32)
    g = rng.randn(1, s, cfg.d_model).astype(np.float32)
    p = tree_map(lambda t: t.detach().requires_grad_(), p)
    xt = torch.from_numpy(x).requires_grad_()
    out = layers.attention_full(p, cfg.attention, xt, torch.arange(s),
                                cfg.d_model)
    got = torch.autograd.grad(out, [xt] + tree_leaves(p),
                              torch.from_numpy(g))

    def f(x_, p_):
        return j_layers.attention_full(p_, j_cfg.attention, x_,
                                       jnp.arange(s), cfg.d_model)
    _, vjp = jax.vjp(f, jnp.asarray(x), j_p)
    dx, dp = vjp(jnp.asarray(g))
    want = [dx] + [dp[k] for k in p]
    for a, w in zip(got, want):
        w = _np(w)
        assert np.abs(a.numpy() - w).max() <= 1e-5 * np.abs(w).max()


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

def test_cross_entropy_matches_reference():
    """Padded vocab (300 of 384, pads at -1e30 as the head leaves them),
    a mask with zeros; the value and its gradient."""
    rng = np.random.RandomState(3)
    logits = (3 * rng.randn(2, 9, 384)).astype(np.float32)
    logits[..., 300:] = -1e30
    labels = rng.randint(0, 300, (2, 9)).astype(np.int32)
    mask = (rng.rand(2, 9) < 0.7).astype(np.float32)
    lt = torch.from_numpy(logits).requires_grad_()
    got = embedding.cross_entropy(lt, torch.from_numpy(labels),
                                  torch.from_numpy(mask))
    (dg,) = torch.autograd.grad(got, lt)

    def f(lg):
        return j_emb.cross_entropy(lg, jnp.asarray(labels), jnp.asarray(mask))
    want, dw = jax.value_and_grad(f)(jnp.asarray(logits))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(dg.numpy(), np.asarray(dw), rtol=1e-5,
                               atol=1e-7)
    assert not dg[..., 300:].any()
    zero = embedding.cross_entropy(lt, torch.from_numpy(labels),
                                   torch.zeros(2, 9))
    assert zero.item() == 0.0


def test_head_masking_leaves_no_gradient_on_the_pad_rows():
    """``_mask_pad`` writes -1e30 into the pad columns in place; the tied
    table's pad rows (and an untied head's pad columns) get a zero
    gradient, as under the reference's ``where``."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 5, 8).astype(np.float32))
    table = torch.from_numpy(rng.randn(256, 8).astype(np.float32))
    table.requires_grad_()
    w = torch.from_numpy(rng.randn(8, 256).astype(np.float32))
    w.requires_grad_()
    labels = torch.from_numpy(rng.randint(0, 200, (2, 5)))
    for head, leaf in ((embedding.lm_head(x, table, 200), table),
                       (embedding.lm_head_untied(x, w, 200), w)):
        loss = embedding.cross_entropy(head, labels, torch.ones(2, 5))
        (g,) = torch.autograd.grad(loss, leaf)
        pads = g[200:] if leaf is table else g[:, 200:]
        assert not pads.any() and g.abs().sum() > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_reference(arch, dtype):
    cfg, j_cfg = _cfgs(arch, dtype)
    params, j_params = _params(arch, dtype)
    toks = _tokens(cfg, 2, 16, seed=1)
    loss, grads = _grads(params, cfg, toks)
    j_loss, j_grads = jax.value_and_grad(j_api.loss)(
        j_params, j_cfg, {"tokens": jnp.asarray(toks)})
    assert loss.dtype == torch.float32
    rtol, gtol = (1e-5, 1e-5) if dtype == "float32" else (2e-3, 5e-2)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=rtol)
    _grads_close(grads, j_grads, gtol)
    # remat recomputes each layer in the backward: the same bits
    loss2, grads2 = _grads(params, cfg, toks, remat=False)
    assert torch.equal(loss, loss2)
    for a, b in zip(tree_leaves(grads), tree_leaves(grads2)):
        assert torch.equal(a, b)


def test_loss_at_the_flash_threshold_goes_through_the_op_backward(
        monkeypatch):
    """smollm's smoke config at S = 2048, fp32: the forward takes the op
    (plain flash forward on the CPU), the backward recomputes through
    ``_sdpa_chunked`` once a layer; loss and grads against ``jax.grad``
    through the reference's chunked path."""
    cfg, j_cfg = _cfgs("smollm-360m", "float32")
    params, j_params = _params("smollm-360m", "float32")
    toks = _tokens(cfg, 1, 2048, seed=2)
    calls = []
    chunked = layers._sdpa_chunked

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return chunked(*a, **kw)
    monkeypatch.setattr(layers, "_sdpa_chunked", counted)
    loss, grads = _grads(params, cfg, toks)
    assert len(calls) == cfg.n_layers
    j_loss, j_grads = jax.value_and_grad(j_api.loss)(
        j_params, j_cfg, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    _grads_close(grads, j_grads, 1e-5)


def test_params_can_take_gradients():
    """``init`` and ``params_from_numpy`` build under ``no_grad``, not
    ``inference_mode``: their leaves take ``requires_grad_()``."""
    cfg, _ = _cfgs("smollm-360m", "bfloat16")
    for params in (api.init(torch.Generator().manual_seed(0), cfg,
                            device="cpu"), _params("smollm-360m",
                                                   "bfloat16")[0]):
        for t in tree_leaves(params):
            assert not t.is_inference() and not t.requires_grad
            t.requires_grad_()


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _steps_close(got, want, dtype, n_steps):
    g, w = _leaves(got), _leaves(want)
    limit = 2 * LR * n_steps
    for name in g:
        a, b = g[name].float().numpy(), _np(w[name])
        err = np.abs(a - b)
        if dtype == "float32":
            assert (err > 1e-5).mean() <= 1e-3, name
            assert err.max() <= limit + 1e-5, name
        else:
            assert (err <= n_steps * 2 ** -7 * np.abs(b) + limit).all(), name


@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in ARCHS]
                         + [("smollm-360m", "bfloat16")])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_the_jitted_reference(arch, dtype, microbatches):
    """Three steps of the default optimizer (layerwise AdamW) with the
    grad norm clipped to 0.1, against the reference's jitted step."""
    cfg, j_cfg = _cfgs(arch, dtype)
    params, j_params = _params(arch, dtype)
    name, opt, step = api.make_train_step(cfg, grad_clip=CLIP,
                                          microbatches=microbatches)
    j_name, j_opt, j_step = j_api.make_train_step(
        j_cfg, grad_clip=CLIP, microbatches=microbatches)
    assert name == j_name == "adamw"
    state, j_state = opt.init(params), j_opt.init(j_params)
    j_step = jax.jit(j_step)
    rtol = 1e-5 if dtype == "float32" else 2e-3
    gtol = 1e-5 if dtype == "float32" else 5e-3
    for i in range(3):
        toks = _tokens(cfg, 4, 16, seed=10 + i)
        new, state, m = step(params, state, {"tokens": torch.from_numpy(toks)})
        assert new is params                       # in place
        j_params, j_state, j_m = j_step(j_params, j_state,
                                        {"tokens": jnp.asarray(toks)})
        assert float(j_m["grad_norm"]) > CLIP      # the clip bites
        np.testing.assert_allclose(m["loss"].item(), float(j_m["loss"]),
                                   rtol=rtol)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(j_m["grad_norm"]), rtol=gtol)
        _steps_close(params, j_params, dtype, i + 1)
    assert state["step"] == int(j_state["step"]) == 3


def test_accumulation_adds_in_the_param_dtype_in_order():
    """microbatches = 2 equals, bit for bit, zeros + g0 + g1 in the
    params' dtype, divided by 2, then the clip and the update; the loss is
    the mean of the two."""
    cfg, _ = _cfgs("smollm-360m", "bfloat16")
    toks = _tokens(cfg, 4, 16, seed=5)
    p1, _ = _params("smollm-360m", "bfloat16")
    _, opt, step = api.make_train_step(cfg, microbatches=2)
    s1 = opt.init(p1)
    _, _, m = step(p1, s1, {"tokens": torch.from_numpy(toks)})

    from repro_torch import optim
    p2, _ = _params("smollm-360m", "bfloat16")
    l0, g0 = _grads(p2, cfg, toks[:2])
    l1, g1 = _grads(p2, cfg, toks[2:])
    acc = tree_map(torch.zeros_like, p2)
    for g in (g0, g1):
        tree_map(torch.Tensor.add_, acc, g)
    grads, norm = optim.clip_by_global_norm(tree_map(lambda g: g / 2, acc),
                                            1.0)
    s2 = opt.init(p2)
    opt.update(grads, s2, p2)
    assert m["loss"].item() == torch.stack([l0, l1]).mean().item()
    assert torch.equal(m["grad_norm"], norm)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        assert torch.equal(a, b)


def test_default_optimizer_matches_reference():
    for arch in ARCHS:
        cfg, j_cfg = _cfgs(arch, "bfloat16")
        assert api.default_optimizer(cfg)[0] == j_api.default_optimizer(
            j_cfg)[0] == "adamw"
    big = registry.get_arch("qwen1.5-4b").replace(
        d_model=4096, moe=t_base.MoEConfig())
    j_big = j_registry.get_arch("qwen1.5-4b").replace(
        d_model=4096, moe=j_base.MoEConfig())
    assert api.default_optimizer(big)[0] == j_api.default_optimizer(
        j_big)[0] == "adafactor"
    # the same update on the smoke params (fp32, random grads)
    cfg, j_cfg = _cfgs("h2o-danube-1.8b", "float32")
    params, j_params = _params("h2o-danube-1.8b", "float32")
    rng = np.random.RandomState(6)
    g = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32),
                     j_params)
    for (_, opt), (_, j_opt) in ((api.default_optimizer(cfg),
                                  j_api.default_optimizer(j_cfg)),
                                 (api.default_optimizer(big),
                                  j_api.default_optimizer(j_big))):
        p = tree_map(torch.clone, params)
        p, _ = opt.update(api.params_from_numpy(g, "cpu"), opt.init(p), p)
        j_p, _ = j_opt.update(jax.tree.map(jnp.asarray, g),
                              j_opt.init(j_params), j_params)
        for name, t in _leaves(p).items():
            np.testing.assert_allclose(t.numpy(), _np(_leaves(j_p)[name]),
                                       rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# data: LMSynthetic, the Prefetcher, make_placer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm-360m", "qwen1.5-4b"])
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_lm_synthetic_equals_reference(arch, smoke):
    get = (registry.get_smoke if smoke else registry.get_arch)
    j_get = (j_registry.get_smoke if smoke else j_registry.get_arch)
    for seed in (0, 3):
        got, want = LMSynthetic(get(arch), seed), JLMSynthetic(j_get(arch),
                                                               seed)
        for b, s in ((2, 16), (3, 70), (1, 9)):
            a, w = got.batch(b, s), want.batch(b, s)
            assert a.keys() == w.keys() == {"tokens"}
            assert a["tokens"].dtype == np.int32
            np.testing.assert_array_equal(a["tokens"], w["tokens"])


def test_lm_synthetic_refuses_unported_inputs():
    """No input is unported any more: the family alone decides a
    batch's form, so a config made an encoder-decoder gets frames of
    ``enc_memory_len`` before its tokens, equal to the reference's."""
    cfg = registry.get_smoke("smollm-360m").replace(family="encdec")
    j_cfg = j_registry.get_smoke("smollm-360m").replace(family="encdec")
    got, want = LMSynthetic(cfg).batch(1, 8), JLMSynthetic(j_cfg).batch(1, 8)
    assert got.keys() == want.keys() == {"frames", "tokens"}
    assert got["frames"].shape == (1, cfg.enc_memory_len, cfg.d_model)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def _gen(n):
    for i in range(n):
        yield {"x": np.full((2,), i, np.int32)}


def test_prefetcher_keeps_order_and_ends():
    """The order of the iterator, then StopIteration on the end
    sentinel (tests/test_substrates.py:250)."""
    pf = Prefetcher(_gen(5), depth=2)
    assert [int(b["x"][0]) for b in pf] == [0, 1, 2, 3, 4]
    pf.close()
    pf = Prefetcher(_gen(2), depth=2)
    assert int(next(pf)["x"][0]) == 0 and int(next(pf)["x"][0]) == 1
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetcher_surfaces_the_worker_exception():
    def bad():
        yield {"x": np.zeros(1)}
        raise KeyError("lost shard")
    pf = Prefetcher(bad(), depth=2)
    assert next(pf)["x"].shape == (1,)
    with pytest.raises(KeyError, match="lost shard"):
        next(pf)


def test_prefetcher_runs_at_most_depth_ahead():
    """The bounded queue: with nobody reading, the worker has placed at
    most ``depth`` batches and holds one more."""
    placed = []
    pf = Prefetcher(_gen(50), depth=3, place=lambda b: placed.append(1) or b)
    deadline = time.time() + 60
    while len(placed) < 4 and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)
    assert len(placed) == 4
    assert [int(next(pf)["x"][0]) for _ in range(3)] == [0, 1, 2]
    pf.close()


def test_make_placer_on_the_cpu_and_refuses_a_mesh():
    batch = {"tokens": np.arange(6, dtype=np.int32).reshape(2, 3)}
    out = make_placer("cpu")(batch)
    assert out["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(out["tokens"].numpy(), batch["tokens"])
    batch["tokens"][0, 0] = 99                   # the tensor owns a copy
    assert out["tokens"][0, 0].item() == 0
    pf = Prefetcher(_gen(3), place=make_placer("cpu"))
    assert [b["x"][0].item() for b in pf] == [0, 1, 2]
    from repro_torch.launch.mesh import Mesh
    # a mesh is the port's Mesh, and placing onto one needs the specs
    # (the blocks are held in test_torch_mesh2d.py)
    with pytest.raises(TypeError, match="Mesh"):
        make_placer("cpu", mesh=object())
    with pytest.raises(ValueError, match="batch_specs"):
        make_placer("cpu", mesh=Mesh((("model", None, 0, 2),)))


# ---------------------------------------------------------------------------
# the launcher's LM half
# ---------------------------------------------------------------------------

def _launch(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        args = t_train.parse_args(argv)
        loss, state = t_train.train_lm(args)
    return loss, state, out.getvalue().splitlines()


def test_launcher_trains_an_lm_and_resumes_bit_for_bit(tmp_path):
    """An uninterrupted run of 4 steps against 2 steps, a checkpoint and
    a resumed run of the last 2: the same losses and the same final
    params and optimizer state, bit for bit."""
    base = ["--arch", "smollm-360m", "--smoke", "--device", "cpu",
            "--batch-size", "2", "--seq-len", "24", "--log-every", "1"]
    loss, (params, state), lines = _launch(base + ["--steps", "4"])
    assert [ln.split()[:2] for ln in lines[:4]] == [
        ["step", str(i)] for i in range(4)]
    assert lines[-2:] == ["straggler events: 0", f"final loss {loss:.4f}"]
    ckpt = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    _launch(base + ckpt + ["--steps", "2"])
    loss2, (params2, state2), lines2 = _launch(
        base + ckpt + ["--steps", "4", "--resume"])
    assert lines2[0] == "resumed from step 1"
    # "step N loss L gnorm G (seconds)": all but the time
    assert [ln.split()[:6] for ln in lines2[1:3]] == [
        ln.split()[:6] for ln in lines[2:4]]
    assert loss2 == loss
    for a, b in zip(tree_leaves((params, state)),
                    tree_leaves((params2, state2))):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b)


def test_launcher_main_runs_an_lm_and_refuses_the_rest():
    out = io.StringIO()
    with redirect_stdout(out):
        loss = t_train.main(["--arch", "qwen1.5-4b", "--smoke", "--device",
                             "cpu", "--steps", "2", "--batch-size", "2",
                             "--seq-len", "16"])
    assert np.isfinite(loss)
    assert out.getvalue().splitlines()[-1] == f"final loss {loss:.4f}"
    for argv in (["--arch", "rwkv6-7b", "--ragged"], ["--arch", "gpt-2"],
                 ["--arch", "smollm-360m", "--ragged"]):
        with pytest.raises(SystemExit):
            t_train.main(argv + ["--smoke", "--device", "cpu"])
