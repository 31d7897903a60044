"""The port's encoder-decoder (``repro_torch.models.encdec``) against the
JAX package's ``repro.models.encdec``, at seamless-m4t-large-v2's smoke
config: the config, the params tree, the encoder (not causal, at the
direct path's length and at 2,048 frames, where the port takes the
flash op and the reference its chunked path), cross-attention (direct,
and chunked at 2,048 queries), forward, prefill and its caches (the self
K/V and each layer's cross K/V), decode, the prefill/decode law, the
loss and its gradients, one ``make_train_step``, the decode engine with
its zero memory, ``LMSynthetic``'s frames batch and both launchers.
Params come from the reference's ``api.init`` through numpy.

Frames: the port casts them to the params' dtype at the encoder's entry
(``encdec.py``'s note); the reference adds them in their own dtype, so
a bf16 comparison hands the reference bf16 frames, which is the same
input.

Tolerances (``test_torch_lm_families.py``'s, for the same reasons):
  * fp32: logits, encoder memory and losses 1e-5; gradients 1e-5 of the
    leaf's largest; caches compared in fp32 (``prefill``'s cache dtype
    set to fp32 on both sides, so no bf16 rounding boundary sits between
    them) within 1e-5.
  * the encoder at 2,048 frames (fp32): 2e-5, the flash tests' bound for
    the plain flash version against the reference's blocked softmax.
  * bf16: the reference's 2e-2 / 5e-2 (tests/test_models.py); caches
    5e-2 of the leaf's largest; the loss 2e-3 relative.
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
from repro.models import encdec as j_encdec
from repro.models import layers as j_layers
from repro.serving import DecodeEngine as JDecodeEngine
from repro.serving import Request as JRequest
from repro_torch.configs import registry
from repro_torch.data import LMSynthetic
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import api, encdec, layers
from repro_torch.optim import tree_leaves, tree_map
from repro_torch.serving import DecodeEngine, Request

torch.set_num_threads(1)

ARCH = "seamless-m4t-large-v2"
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 5e-2)}
LR = 3e-4


def _cfgs(dtype, **kw):
    return (registry.get_smoke(ARCH).replace(dtype=dtype, **kw),
            j_registry.get_smoke(ARCH).replace(dtype=dtype, **kw))


_PARAMS = {}


def _params(dtype):
    if dtype not in _PARAMS:
        _, j_cfg = _cfgs(dtype)
        _PARAMS[dtype] = j_api.init(jax.random.PRNGKey(0), j_cfg)[0]
    j_params = _PARAMS[dtype]
    return (api.params_from_numpy(jax.tree.map(np.asarray, j_params), "cpu"),
            j_params)


def _batch(cfg, b=2, s=16, seed=0, frames=None):
    """(port batch, JAX batch): frames (B, enc_memory_len or ``frames``,
    D) drawn first, then the target tokens; the JAX side's frames in the
    params' dtype."""
    rng = np.random.RandomState(seed)
    fr = rng.randn(b, frames or cfg.enc_memory_len, cfg.d_model).astype(
        np.float32)
    toks = rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return ({"frames": torch.from_numpy(fr), "tokens": torch.from_numpy(toks)},
            {"frames": jnp.asarray(fr, getattr(jnp, cfg.dtype)),
             "tokens": jnp.asarray(toks)})


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol[0],
                               atol=tol[1])


def _logits_close(got, want, cfg, tol):
    v = cfg.vocab_size
    _close(got[..., :v], want[..., :v], tol)
    assert (got.numpy()[..., v:] == -1e30).all()


def _cache_close(got, want, dtype):
    tol = 1e-5 if dtype == "float32" else 5e-2
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for name in g:
        assert tuple(g[name].shape) == w[name].shape, name
        assert str(g[name].dtype).split(".")[-1] == w[name].dtype.name, name
        ref = _np(w[name])
        np.testing.assert_allclose(
            g[name].float().numpy(), ref, rtol=tol,
            atol=tol * max(1.0, float(np.abs(ref).max())), err_msg=name)


# ---------------------------------------------------------------------------
# config, params
# ---------------------------------------------------------------------------

def test_config_equals_the_reference_field_by_field():
    for t_cfg, j_cfg in ((registry.get_arch(ARCH), j_registry.get_arch(ARCH)),
                         (registry.get_smoke(ARCH),
                          j_registry.get_smoke(ARCH))):
        assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
        assert t_cfg.is_encdec and j_cfg.is_encdec
        encdec.check_ported(t_cfg)
    assert ARCH in registry.ARCH_IDS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_follows_the_reference_tree_and_dtypes(dtype):
    cfg, _ = _cfgs(dtype)
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    got, want = _leaves(params), _leaves(_params(dtype)[1])
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape, name
        assert str(t.dtype).split(".")[-1] == want[name].dtype.name, name


def test_the_families_refuse_each_others_configs():
    from repro_torch.models import transformer
    with pytest.raises(ValueError, match="models.encdec"):
        transformer.check_ported(registry.get_smoke(ARCH))
    with pytest.raises(ValueError, match="models.transformer"):
        encdec.check_ported(registry.get_smoke("smollm-360m"))


# ---------------------------------------------------------------------------
# the encoder and cross-attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frames", [16, 2048])
def test_encode_matches_reference(frames):
    """Not causal; at 2,048 frames the port's attention is the flash op
    (its plain version here), the reference's its chunked path."""
    cfg, j_cfg = _cfgs("float32")
    params, j_params = _params("float32")
    tb, jb = _batch(cfg, b=1, frames=frames, seed=frames)
    with torch.no_grad():
        got = encdec.encode(params, cfg, tb["frames"])
    want = j_encdec.encode(j_params, j_cfg, jb["frames"])
    tol = 1e-5 if frames < 2048 else 2e-5
    _close(got, want, (tol, tol))
    # not causal: the last frame changes the first frame's memory
    tb["frames"][:, -1] += 1.0
    with torch.no_grad():
        moved = encdec.encode(params, cfg, tb["frames"])
    assert not torch.equal(moved[:, 0], got[:, 0])


@pytest.mark.parametrize("s", [5, 2048])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_reference(s, dtype):
    """``memory_kv`` and ``cross_attention_full`` (direct below 2,048
    queries, chunked at 2,048), and ``cross_attention_decode``."""
    cfg, j_cfg = _cfgs(dtype)
    params, j_params = _params(dtype)
    p = {k: v[0] for k, v in params["dec"]["cross"].items()}
    jp = {k: v[0] for k, v in j_params["dec"]["cross"].items()}
    rng = np.random.RandomState(s)
    mem = rng.randn(2, 40, cfg.d_model).astype(np.float32)
    x = rng.randn(2, s, cfg.d_model).astype(np.float32)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    tmem, tx = torch.from_numpy(mem).to(tdt), torch.from_numpy(x).to(tdt)
    jmem, jx = jnp.asarray(mem, jdt), jnp.asarray(x, jdt)
    with torch.no_grad():
        kv = layers.memory_kv(p, cfg.attention, tmem, cfg.d_model)
        got = layers.cross_attention_full(p, cfg.attention, tx, kv,
                                          cfg.d_model)
        dec = layers.cross_attention_decode(p, cfg.attention, tx[:, :1], kv,
                                            cfg.d_model)
    jkv = j_layers.memory_kv(jp, j_cfg.attention, jmem, j_cfg.d_model)
    want = j_layers.cross_attention_full(jp, j_cfg.attention, jx, jkv,
                                         j_cfg.d_model)
    j_dec = j_layers.cross_attention_decode(jp, j_cfg.attention, jx[:, :1],
                                            jkv, j_cfg.d_model)
    _close(kv[0], jkv[0], TOL[dtype])
    _close(got, want, TOL[dtype])
    _close(dec, j_dec, TOL[dtype])


def test_cross_attention_decode_of_zero_memory_is_zero():
    """The reference's engine serves through ``init_cache`` and
    ``decode_step`` alone, so its cross K/V stay zeros: uniform weights
    over zero values, and cross-attention adds exactly 0 @ wo."""
    cfg, _ = _cfgs("bfloat16")
    params, _ = _params("bfloat16")
    p = {k: v[0] for k, v in params["dec"]["cross"].items()}
    cache = api.init_cache(cfg, 2, 8, device="cpu")
    x = torch.randn(2, 1, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0)).bfloat16()
    with torch.no_grad():
        out = layers.cross_attention_decode(
            p, cfg.attention, x, (cache["cross_k"][0], cache["cross_v"][0]),
            cfg.d_model)
    assert not out.any()


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    cfg, j_cfg = _cfgs(dtype)
    params, j_params = _params(dtype)
    tb, jb = _batch(cfg)
    got, aux = api.forward(params, cfg, tb)
    want, _ = j_api.forward(j_params, j_cfg, jb)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _logits_close(got, want, cfg, TOL[dtype])
    assert aux.item() == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    """Prefill (the self caches and each layer's cross K/V of the real
    memory), then three decode steps against the reference's."""
    cfg, j_cfg = _cfgs(dtype)
    params, j_params = _params(dtype)
    tb, jb = _batch(cfg, seed=1)
    if dtype == "float32":
        with torch.inference_mode():
            got, cache = encdec.prefill(params, cfg, tb, 24, torch.float32)
        want, j_cache = j_encdec.prefill(j_params, j_cfg, jb, 24,
                                         jnp.float32)
    else:
        got, cache = api.prefill(params, cfg, tb, 24)
        want, j_cache = j_api.prefill(j_params, j_cfg, jb, 24)
    _logits_close(got, want, cfg, TOL[dtype])
    _cache_close(cache, j_cache, dtype)
    assert cache["cross_k"].shape[:3] == (cfg.dec_layers, 2,
                                          cfg.enc_memory_len)
    nxt = np.random.RandomState(2).randint(0, cfg.vocab_size, 2).astype(
        np.int32)
    for pos in (16, 17, 18):
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


def test_init_cache_matches_reference():
    cfg, j_cfg = _cfgs("bfloat16")
    for max_len in (8, 32):
        got = api.init_cache(cfg, 3, max_len, device="cpu")
        want = j_api.init_cache(j_cfg, 3, max_len)
        g, w = _leaves(got), _leaves(want)
        assert g.keys() == w.keys()
        for name in g:
            assert tuple(g[name].shape) == w[name].shape
            assert str(g[name].dtype).split(".")[-1] == w[name].dtype.name
            np.testing.assert_array_equal(g[name].float().numpy(),
                                          _np(w[name]))


def test_prefill_decode_matches_forward():
    """The reference's law (tests/test_models.py:61) in the port, bf16,
    with the real memory: prefill's last logits == forward's at position
    -2, and decode(prefill(prompt), next) == forward(prompt + next)."""
    cfg, _ = _cfgs("bfloat16")
    params, _ = _params("bfloat16")
    tb, _ = _batch(cfg, seed=3)
    logits_pf, cache = api.prefill(params, cfg, tb, 20)
    nxt = torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg.vocab_size, (2, 1)).astype(np.int32))
    full, _ = api.forward(params, cfg,
                          dict(tb, tokens=torch.cat([tb["tokens"], nxt], 1)))
    np.testing.assert_allclose(logits_pf.numpy(), full[:, -2].numpy(),
                               rtol=2e-2, atol=2e-2)
    dec, _ = api.decode_step(params, cfg, cache, nxt[:, 0], 16)
    np.testing.assert_allclose(dec.numpy(), full[:, -1].numpy(), rtol=5e-2,
                               atol=5e-2)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_reference(dtype):
    cfg, j_cfg = _cfgs(dtype)
    params, j_params = _params(dtype)
    tb, jb = _batch(cfg, seed=5)
    req = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = api.loss(req, cfg, tb)
    grads = torch.autograd.grad(loss, tree_leaves(req))
    j_loss, j_grads = jax.value_and_grad(j_api.loss)(j_params, j_cfg, jb)
    rtol, gtol = (1e-5, 1e-5) if dtype == "float32" else (2e-3, 5e-2)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=rtol)
    it = iter(grads)
    g = _leaves(tree_map(lambda _: next(it), req))
    w = _leaves(j_grads)
    assert g.keys() == w.keys()
    for name in g:
        ref = _np(w[name])
        err = np.abs(g[name].float().numpy() - ref).max()
        assert err <= gtol * np.abs(ref).max() + 1e-30, (name, err)


def test_train_step_matches_the_jitted_reference():
    """One step of the default optimizer (layerwise AdamW), clipped at
    0.1, against the reference's jitted step (fp32)."""
    cfg, j_cfg = _cfgs("float32")
    params, j_params = _params("float32")
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


def test_decode_engine_follows_the_references_zero_memory_engine(
        monkeypatch):
    """The reference's engine (``repro/serving/engine.py:84-107``) serves
    an encoder-decoder through ``init_cache`` and ``decode_step`` alone:
    the encoder never runs and the cross K/V stay zeros. The port's
    engine follows it: the same greedy tokens (fp32), no call of the
    encoder, and zero cross K/V after serving."""
    cfg, j_cfg = _cfgs("float32")
    params, j_params = _params("float32")

    def no_encoder(*a, **k):
        raise AssertionError("the engine ran the encoder")
    monkeypatch.setattr(encdec, "encode", no_encoder)
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 3, 6, 4, 2)]
    got, engine = _serve(DecodeEngine, Request, cfg, params, prompts)
    want, _ = _serve(JDecodeEngine, JRequest, j_cfg, j_params, prompts)
    for g, w in zip(got, want):
        assert len(g.output) == g.max_new_tokens
        assert g.output == w.output
    assert not engine.cache["cross_k"].any()
    assert not engine.cache["cross_v"].any()


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_lm_synthetic_frames_batch_equals_reference(smoke):
    """The frames are drawn before the tokens, as the reference draws
    them: the same seed gives the same arrays, bit for bit."""
    get = registry.get_smoke if smoke else registry.get_arch
    j_get = j_registry.get_smoke if smoke else j_registry.get_arch
    for seed in (0, 3):
        got, want = LMSynthetic(get(ARCH), seed), JLMSynthetic(j_get(ARCH),
                                                               seed)
        for b, s in ((2, 16), (1, 40)):
            a, w = got.batch(b, s), want.batch(b, s)
            assert a.keys() == w.keys() == {"frames", "tokens"}
            assert a["frames"].dtype == np.float32
            assert a["frames"].shape == (b, get(ARCH).enc_memory_len,
                                         get(ARCH).d_model)
            np.testing.assert_array_equal(a["frames"], w["frames"])
            np.testing.assert_array_equal(a["tokens"], w["tokens"])


def test_serve_launcher_serves_the_encoder_decoder_on_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        stats = t_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--requests", "3", "--batch-size", "2",
                              "--prompt-len", "4", "--new-tokens", "3"])
    assert stats["n"] == 3 and stats["p50_ms"] > 0


def test_train_launcher_trains_the_encoder_decoder_on_cpu(monkeypatch):
    """The frames reach the step as bf16, as a vlm model's patches do."""
    seen = []
    real = api.make_train_step

    def spy(cfg, *a, **k):
        name, opt, step = real(cfg, *a, **k)

        def wrapped(params, state, batch):
            seen.append({k: v.dtype for k, v in batch.items()})
            return step(params, state, batch)
        return name, opt, wrapped
    monkeypatch.setattr(api, "make_train_step", spy)
    out = io.StringIO()
    with redirect_stdout(out):
        loss = t_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--steps", "2", "--batch-size", "2",
                             "--seq-len", "16"])
    assert np.isfinite(loss) and len(seen) == 2
    assert seen[0] == {"frames": torch.bfloat16, "tokens": torch.int32}
