"""The port's recurrent decoders against the JAX package, at the smoke
configs: recurrentgemma-9b (the ``hybrid`` family: RG-LRU blocks and
local attention in a (rec, rec, attn) pattern; also cut to 5 layers,
one group and a tail of (rec, rec), the full config's shape) and
rwkv6-7b (the ``ssm`` family, attention-free). Configs, the params
tree, forward, prefill and its cache (the ring cache of the windowed
attention included), decode, the prefill/decode law, the loss and its
gradients, one ``make_train_step``, the decode engine, ``LMSynthetic``
and both launchers. Params come from the reference's ``api.init``
through numpy.

Tolerances (``test_torch_lm_families.py``'s, for the same reasons: the
same ops in fp32 summed in another order; in bf16 the two frameworks
round at other places), and where they differ, why:
  * fp32: logits and losses 1e-5; gradients 1e-4 of the leaf's largest
    (see the test); caches and recurrent states 1e-5 of the leaf's
    largest, compared in fp32 (``prefill``'s cache dtype set to fp32 on
    both sides, so no bf16 rounding boundary sits between them).
  * bf16: the reference's 2e-2 / 5e-2 (tests/test_models.py); caches
    and states 5e-2 of the leaf's largest; the loss 2e-3 relative;
    gradients as the test says.
  * one train step (fp32): params within 1e-5 but for 1e-3 of the
    elements, none further than 2 lr.
  * the port's own prefill/decode law: the reference's 2e-2 / 5e-2.
  * the decode engine: greedy tokens equal (fp32).
"""
import dataclasses
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.data import LMSynthetic as JLMSynthetic
from repro.models import api as j_api
from repro.models import transformer as j_transformer
from repro.serving import DecodeEngine as JDecodeEngine
from repro.serving import Request as JRequest
from repro_torch.configs import registry
from repro_torch.data import LMSynthetic
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import api, transformer
from repro_torch.optim import tree_leaves, tree_map
from repro_torch.serving import DecodeEngine, Request

torch.set_num_threads(1)

# (arch, n_layers or None): recurrentgemma's smoke config is one group;
# at 5 layers it has a tail of (rec, rec), as the full config's 38 do
CASES = [("recurrentgemma-9b", None), ("recurrentgemma-9b", 5),
         ("rwkv6-7b", None)]
IDS = ["recurrentgemma", "recurrentgemma-tail", "rwkv6"]
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 5e-2)}
LR = 3e-4


def _cfgs(arch, dtype, n_layers=None):
    kw = {"dtype": dtype}
    if n_layers is not None:
        kw["n_layers"] = n_layers
    return (registry.get_smoke(arch).replace(**kw),
            j_registry.get_smoke(arch).replace(**kw))


_PARAMS = {}


def _params(arch, dtype, n_layers=None):
    """(port params on the CPU, JAX params) from the reference's init; a
    fresh port copy each call (the train step works in place)."""
    key = (arch, dtype, n_layers)
    if key not in _PARAMS:
        _, j_cfg = _cfgs(arch, dtype, n_layers)
        _PARAMS[key] = j_api.init(jax.random.PRNGKey(0), j_cfg)[0]
    j_params = _PARAMS[key]
    return (api.params_from_numpy(jax.tree.map(np.asarray, j_params), "cpu"),
            j_params)


def _batch(cfg, b=2, s=16, seed=0):
    toks = np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks)}, {"tokens": jnp.asarray(toks)}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}/{k}"))
    return out


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _logits_close(got, want, cfg, tol):
    v = cfg.vocab_size
    np.testing.assert_allclose(got.float().numpy()[..., :v],
                               _np(want)[..., :v], rtol=tol[0], atol=tol[1])
    assert (got.numpy()[..., v:] == -1e30).all()


def _cache_close(got, want, dtype):
    """Leaf by leaf, within the bar (1e-5 fp32, 5e-2 bf16) relative and
    absolute of the leaf's largest value (RWKV's S sums k v over the
    sequence, to ~10; RoPE'd keys reach ~2)."""
    tol = 1e-5 if dtype == "float32" else 5e-2
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for name in g:
        assert tuple(g[name].shape) == w[name].shape, name
        assert str(g[name].dtype).split(".")[-1] == w[name].dtype.name, name
        if name.endswith("slot_pos"):
            np.testing.assert_array_equal(g[name].numpy(),
                                          np.asarray(w[name]))
            continue
        ref = _np(w[name])
        np.testing.assert_allclose(
            g[name].float().numpy(), ref, rtol=tol,
            atol=tol * max(1.0, float(np.abs(ref).max())), err_msg=name)


# ---------------------------------------------------------------------------
# configs, registry, params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-7b"])
def test_configs_equal_the_reference_field_by_field(arch):
    for t_cfg, j_cfg in ((registry.get_arch(arch), j_registry.get_arch(arch)),
                         (registry.get_smoke(arch),
                          j_registry.get_smoke(arch))):
        assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
        assert t_cfg.subquadratic == j_cfg.subquadratic is True
        transformer.check_ported(t_cfg)
    assert arch in registry.ARCH_IDS


def test_hybrid_layout_matches_the_reference():
    """recurrentgemma-9b's 38 layers: 12 (rec, rec, attn) groups and a
    tail of (rec, rec); every depth the reference's layout gives too."""
    cfg = registry.get_arch("recurrentgemma-9b")
    assert transformer._hybrid_layout(cfg) == (12, ("rec", "rec"))
    j_cfg = j_registry.get_arch("recurrentgemma-9b")
    for n in range(3, 41):
        assert (transformer._hybrid_layout(cfg.replace(n_layers=n))
                == j_transformer._hybrid_layout(j_cfg.replace(n_layers=n)))


@pytest.mark.parametrize("arch,n_layers", CASES, ids=IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_follows_the_reference_tree_and_dtypes(arch, n_layers, dtype):
    """The reference's leaves (a hybrid's ``groups`` stacked over the
    groups, its ``tail`` a list), shapes and dtypes; the recurrent
    blocks' constants (``lam``, ``ba``, ``w_base``) as the reference's
    (Lambda within 1e-5 relative: see ``test_torch_rglru.py``)."""
    cfg, _ = _cfgs(arch, dtype, n_layers)
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    ref = _params(arch, dtype, n_layers)
    got, want, carried = _leaves(params), _leaves(ref[1]), _leaves(ref[0])
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape, name
        assert str(t.dtype).split(".")[-1] == want[name].dtype.name, name
        if name.endswith(("/lam", "/ba", "/w_base")):
            np.testing.assert_allclose(t.float().numpy(),
                                       carried[name].float().numpy(),
                                       rtol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# forward, prefill, decode against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,n_layers", CASES, ids=IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(arch, n_layers, dtype):
    cfg, j_cfg = _cfgs(arch, dtype, n_layers)
    params, j_params = _params(arch, dtype, n_layers)
    tb, jb = _batch(cfg)
    got, aux = api.forward(params, cfg, tb)
    want, _ = j_api.forward(j_params, j_cfg, jb)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _logits_close(got, want, cfg, TOL[dtype])
    assert aux.item() == 0.0


def test_rwkv_forward_takes_the_sequential_form_off_the_chunk():
    """S = 17 is no multiple of the smoke chunk (16): both sides take the
    sequential WKV; and ``rwkv_chunked=False`` at S = 16."""
    cfg, j_cfg = _cfgs("rwkv6-7b", "float32")
    params, j_params = _params("rwkv6-7b", "float32")
    tb, jb = _batch(cfg, s=17, seed=4)
    _logits_close(api.forward(params, cfg, tb)[0],
                  j_api.forward(j_params, j_cfg, jb)[0], cfg, TOL["float32"])
    tb, jb = _batch(cfg, seed=5)
    with torch.inference_mode():
        got, _ = transformer.forward(params, cfg, tb, rwkv_chunked=False)
    want, _ = j_transformer.forward(j_params, j_cfg, jb, rwkv_chunked=False)
    _logits_close(got, want, cfg, TOL["float32"])


def _prefill(params, cfg, tb, max_len, dtype):
    """The port's prefill with its cache in fp32 for an fp32 model (see
    the module's note), through the api otherwise."""
    if dtype == "float32":
        with torch.inference_mode():
            return transformer.prefill(params, cfg, tb, max_len,
                                       torch.float32)
    return api.prefill(params, cfg, tb, max_len)


def _j_prefill(j_params, j_cfg, jb, max_len, dtype):
    if dtype == "float32":
        return j_transformer.prefill(j_params, j_cfg, jb, max_len,
                                     jnp.float32)
    return j_api.prefill(j_params, j_cfg, jb, max_len)


@pytest.mark.parametrize("arch,n_layers", CASES, ids=IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,max_len", [(16, 24), (20, 32)],
                         ids=["linear", "past-window"])
def test_prefill_and_decode_match_reference(arch, n_layers, dtype, s,
                                            max_len):
    """Prefill, its cache leaf by leaf, then three decode steps. With
    recurrentgemma's smoke window of 16, max_len 32 makes its attention
    caches rings of 16 slots, and a 20-token prompt puts every decode
    step past the window."""
    cfg, j_cfg = _cfgs(arch, dtype, n_layers)
    params, j_params = _params(arch, dtype, n_layers)
    tb, jb = _batch(cfg, s=s, seed=1)
    got, cache = _prefill(params, cfg, tb, max_len, dtype)
    want, j_cache = _j_prefill(j_params, j_cfg, jb, max_len, dtype)
    _logits_close(got, want, cfg, TOL[dtype])
    _cache_close(cache, j_cache, dtype)
    if cfg.family == "hybrid" and max_len > cfg.attention.window:
        assert cache["groups"]["b2"]["k"].shape[2] == cfg.attention.window
    nxt = np.random.RandomState(2).randint(0, cfg.vocab_size, 2).astype(
        np.int32)
    for pos in range(s, s + 3):
        got, cache2 = api.decode_step(params, cfg, cache,
                                      torch.from_numpy(nxt), pos)
        assert cache2 is cache
        want, j_cache = j_api.decode_step(j_params, j_cfg, j_cache,
                                          jnp.asarray(nxt),
                                          jnp.asarray(pos, jnp.int32))
        _logits_close(got, want, cfg, TOL[dtype])
        _cache_close(cache, j_cache, dtype)
        nxt = torch.argmax(got[:, :cfg.vocab_size], -1).numpy().astype(
            np.int32)


@pytest.mark.parametrize("arch,n_layers", CASES, ids=IDS)
def test_init_cache_matches_reference(arch, n_layers):
    """bf16 models: the reference's tree, shapes, dtypes and zeros. An
    fp32 model's token-shift carries and conv history are fp32 in the
    port from the start (the dtype the reference's first decode step
    gives them; the port writes states in place)."""
    for dtype in ("bfloat16", "float32"):
        cfg, j_cfg = _cfgs(arch, dtype, n_layers)
        for max_len in (8, 32):
            got = api.init_cache(cfg, 3, max_len, device="cpu")
            want = j_api.init_cache(j_cfg, 3, max_len)
            g, w = _leaves(got), _leaves(want)
            assert g.keys() == w.keys()
            for name in g:
                assert tuple(g[name].shape) == w[name].shape, name
                np.testing.assert_array_equal(g[name].float().numpy(),
                                              _np(w[name]))
                state = name.endswith(("/x_prev", "/conv"))
                want_dt = ("float32" if state and dtype == "float32"
                           else w[name].dtype.name)
                assert str(g[name].dtype).split(".")[-1] == want_dt, name


@pytest.mark.parametrize("arch,n_layers", CASES, ids=IDS)
def test_prefill_decode_matches_forward(arch, n_layers):
    """The reference's law (tests/test_models.py:61) in the port, bf16:
    prefill's last logits == forward's at position -2, and
    decode(prefill(prompt), next) == forward(prompt + next)."""
    cfg, _ = _cfgs(arch, "bfloat16", n_layers)
    params, _ = _params(arch, "bfloat16", n_layers)
    tb, _ = _batch(cfg, seed=3)
    logits_pf, cache = api.prefill(params, cfg, tb, 20)
    nxt = torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg.vocab_size, (2, 1)).astype(np.int32))
    full, _ = api.forward(params, cfg,
                          {"tokens": torch.cat([tb["tokens"], nxt], 1)})
    np.testing.assert_allclose(logits_pf.numpy(), full[:, -2].numpy(),
                               rtol=2e-2, atol=2e-2)
    dec, _ = api.decode_step(params, cfg, cache, nxt[:, 0], 16)
    np.testing.assert_allclose(dec.numpy(), full[:, -1].numpy(), rtol=5e-2,
                               atol=5e-2)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,n_layers", CASES, ids=IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_reference(arch, n_layers, dtype):
    """Gradients by autograd against ``jax.grad``. fp32: within 1e-4 of
    the leaf's largest (the decoders' 1e-5 does not hold: the two scans
    associate the recurrence, and its backward, in other trees; the bias
    of RG-LRU's recurrence gate, a sum over every position with
    cancellations, differs by 6.5e-5 of its largest). bf16: against the
    reference's fp32 gradients on the same weights, within 5e-2 of the
    leaf's largest or twice the reference's own bf16 gradients' distance
    from them, whichever is larger (phase 10's bar on the card: a
    recurrence compounds bf16 rounding, and a leaf of small gradients,
    as that bias's, sits at a few ulps of them)."""
    cfg, j_cfg = _cfgs(arch, dtype, n_layers)
    params, j_params = _params(arch, dtype, n_layers)
    tb, jb = _batch(cfg, seed=5)
    req = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = api.loss(req, cfg, tb)
    grads = torch.autograd.grad(loss, tree_leaves(req))
    j_loss, j_grads = jax.value_and_grad(j_api.loss)(j_params, j_cfg, jb)
    rtol, gtol = (1e-5, 1e-4) if dtype == "float32" else (2e-3, 5e-2)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=rtol)
    it = iter(grads)
    g = _leaves(tree_map(lambda _: next(it), req))
    w = _leaves(j_grads)
    assert g.keys() == w.keys()
    floor = {k: 0.0 for k in w}
    if dtype == "bfloat16":
        w16 = w
        w = _leaves(jax.grad(j_api.loss)(
            jax.tree.map(lambda a: a.astype(jnp.float32), j_params),
            j_cfg.replace(dtype="float32"), jb))
        floor = {k: np.abs(_np(w16[k]) - _np(a)).max() for k, a in w.items()}
    for name in g:
        ref = _np(w[name])
        err = np.abs(g[name].float().numpy() - ref).max()
        bound = max(gtol * np.abs(ref).max(), 2 * floor[name])
        assert err <= bound + 1e-30, (name, err, bound)


@pytest.mark.parametrize("arch,n_layers", CASES, ids=IDS)
def test_remat_gives_the_same_gradients(arch, n_layers):
    """Each layer (a hybrid's group) under ``torch.utils.checkpoint``
    recomputes the same values: the gradients equal bit for bit."""
    cfg, _ = _cfgs(arch, "float32", n_layers)
    params, _ = _params(arch, "float32", n_layers)
    tb, _ = _batch(cfg, seed=6)
    out = []
    for remat in (True, False):
        req = tree_map(lambda p: p.detach().requires_grad_(), params)
        out.append(torch.autograd.grad(api.loss(req, cfg, tb, remat=remat),
                                       tree_leaves(req)))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-7b"])
def test_train_step_matches_the_jitted_reference(arch):
    """One step of the default optimizer (layerwise AdamW), clipped at
    0.1, against the reference's jitted step (fp32)."""
    cfg, j_cfg = _cfgs(arch, "float32")
    params, j_params = _params(arch, "float32")
    name, opt, step = api.make_train_step(cfg, grad_clip=0.1)
    j_name, j_opt, j_step = j_api.make_train_step(j_cfg, grad_clip=0.1)
    assert name == j_name == "adamw"
    tb, jb = _batch(cfg, b=4, seed=6)
    params, state, m = step(params, opt.init(params), tb)
    j_params, j_state, j_m = jax.jit(j_step)(j_params, j_opt.init(j_params),
                                             jb)
    np.testing.assert_allclose(m["loss"].item(), float(j_m["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(),
                               float(j_m["grad_norm"]), rtol=1e-5)
    g, w = _leaves(params), _leaves(j_params)
    for name in g:
        err = np.abs(g[name].float().numpy() - _np(w[name]))
        assert (err > 1e-5).mean() <= 1e-3, name
        assert err.max() <= 2 * LR + 1e-5, name


# ---------------------------------------------------------------------------
# serving, data, launchers
# ---------------------------------------------------------------------------

def _serve(engine_cls, request_cls, cfg, params, prompts, n_slots=2):
    engine = engine_cls(cfg, params, n_slots=n_slots, max_len=32)
    reqs = [request_cls(rid=i, prompt=p, max_new_tokens=4 + i % 3)
            for i, p in enumerate(prompts)]
    pending = list(reqs)
    while len(engine.latencies) < len(reqs):
        if engine.idle():
            engine.admit(pending[:n_slots])
            pending = pending[n_slots:]
        engine.step()
    return reqs, engine


@pytest.mark.parametrize("arch,n_layers", CASES, ids=IDS)
def test_decode_engine_matches_reference_engine(arch, n_layers):
    """Greedy tokens equal; the engine's cache stays one set of tensors
    (states written in place), and recurrentgemma's window of 16 is
    passed within a wave (prompts of up to 6 tokens, 6 new)."""
    cfg, j_cfg = _cfgs(arch, "float32", n_layers)
    params, j_params = _params(arch, "float32", n_layers)
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 3, 6, 4, 2)]
    got, engine = _serve(DecodeEngine, Request, cfg, params, prompts)
    want, _ = _serve(JDecodeEngine, JRequest, j_cfg, j_params, prompts)
    for g, w in zip(got, want):
        assert len(g.output) == g.max_new_tokens
        assert g.output == w.output


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-7b"])
def test_lm_synthetic_batch_equals_reference(arch):
    for seed in (0, 3):
        got = LMSynthetic(registry.get_smoke(arch), seed)
        want = JLMSynthetic(j_registry.get_smoke(arch), seed)
        for b, s in ((2, 16), (1, 40)):
            a, w = got.batch(b, s), want.batch(b, s)
            assert a.keys() == w.keys() == {"tokens"}
            np.testing.assert_array_equal(a["tokens"], w["tokens"])


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-7b"])
def test_serve_launcher_serves_the_recurrent_archs_on_cpu(arch):
    out = io.StringIO()
    with redirect_stdout(out):
        stats = t_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--requests", "3", "--batch-size", "2",
                              "--prompt-len", "4", "--new-tokens", "3",
                              "--max-len", "40"])
    assert stats["n"] == 3 and stats["p50_ms"] > 0


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-7b"])
def test_train_launcher_trains_the_recurrent_archs_on_cpu(arch):
    out = io.StringIO()
    with redirect_stdout(out):
        loss = t_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                             "--steps", "2", "--batch-size", "2",
                             "--seq-len", "16"])
    assert np.isfinite(loss)
    assert out.getvalue().splitlines()[-1] == f"final loss {loss:.4f}"
