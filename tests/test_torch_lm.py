"""The port's dense-decoder LM path against the JAX package, for the three
smoke configs (smollm-360m, h2o-danube-1.8b, qwen1.5-4b): configs,
params, forward, prefill (logits and cache leaf by leaf), decode_step,
attention at the flash threshold, the decode engine and the serve
launcher. Params come from the reference's ``api.init`` through numpy.

Tolerances:
  * f32 configs (``cfg.replace(dtype="float32")``): logits rtol = atol =
    1e-5 (values below ~1, the same fp32 math summed in other orders; seen
    5e-7). The decode cache is bf16 on both sides, as the reference keeps
    it (``dtype=jnp.bfloat16``), so its leaves agree within one bf16 ulp
    (rtol 2**-7: fp32 keys ~1e-7 apart may round either way); and decode
    rounds P to the cache's bf16 on both sides, so its logits keep 1e-5.
  * bf16 configs: the reference's own 2e-2 / 5e-2 (tests/test_models.py):
    every matmul output is rounded to bf16 on both sides, in other
    orders. The cache leaves within 5e-2 (a few bf16 ulps at |k| < 4).
  * attention at S = 2048 against the reference's chunked path (which it
    takes off the TPU): 2e-5, the flash kernel's f32 tolerance.
  * the port's own prefill/decode consistency and ring buffer: the
    reference's 2e-2 / 5e-2, in the working bf16.
  * the decode engine: greedy tokens equal (f32, logits 1e-6 apart).
"""
import dataclasses
import io
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.configs import registry as j_registry
from repro.models import api as j_api
from repro.models import layers as j_layers
from repro.serving import DecodeEngine as JDecodeEngine
from repro.serving import Request as JRequest
from repro_torch.configs import base as t_base
from repro_torch.configs import registry
from repro_torch.launch import serve as t_serve
from repro_torch.models import api, layers, transformer
from repro_torch.serving import DecodeEngine, Request

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("smollm-360m", "h2o-danube-1.8b", "qwen1.5-4b")


def _cfgs(arch, dtype):
    return (registry.get_smoke(arch).replace(dtype=dtype),
            j_registry.get_smoke(arch).replace(dtype=dtype))


_PARAMS = {}


def _params(arch, dtype):
    """(port params on the CPU, JAX params) from the reference's init."""
    key = (arch, dtype)
    if key not in _PARAMS:
        _, j_cfg = _cfgs(arch, dtype)
        j_params = j_api.init(jax.random.PRNGKey(0), j_cfg)[0]
        _PARAMS[key] = (api.params_from_numpy(
            jax.tree.map(np.asarray, j_params), "cpu"), j_params)
    return _PARAMS[key]


def _tokens(cfg, b=2, s=16, seed=0):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _logits_close(got, want, cfg, tol):
    v = cfg.vocab_size
    np.testing.assert_allclose(got.float().numpy()[..., :v],
                               _np(want)[..., :v], rtol=tol[0], atol=tol[1])
    # padded vocab entries are masked on both sides
    assert (got.numpy()[..., v:] == -1e30).all()


TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 5e-2)}


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference_field_by_field(arch):
    for t_cfg, j_cfg in ((registry.get_arch(arch), j_registry.get_arch(arch)),
                         (registry.get_smoke(arch),
                          j_registry.get_smoke(arch))):
        assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
        assert t_cfg.subquadratic == j_cfg.subquadratic
        for t_shape, j_shape in zip(t_base.LM_SHAPES, j_base.LM_SHAPES):
            assert dataclasses.asdict(t_shape) == dataclasses.asdict(j_shape)
            assert (t_base.shape_applicable(t_cfg, t_shape)
                    == j_base.shape_applicable(j_cfg, j_shape))
    assert t_base.SHAPES_BY_NAME.keys() == j_base.SHAPES_BY_NAME.keys()


@pytest.mark.parametrize("arch", j_registry.ARCH_IDS)
def test_registry_refuses_the_unported_architectures(arch):
    """No architecture of the reference is unported any more, so the
    registry refuses none of its ids: each one, full and smoke, is the
    reference's config field by field (the families' own checks are
    ``test_torch_lm_families.py``'s, ``test_torch_recurrent_lm.py``'s
    and ``test_torch_encdec.py``'s)."""
    assert registry.ARCH_IDS == j_registry.ARCH_IDS
    for get, j_get in ((registry.get_arch, j_registry.get_arch),
                       (registry.get_smoke, j_registry.get_smoke)):
        assert dataclasses.asdict(get(arch)) == dataclasses.asdict(
            j_get(arch))


def test_registry_refuses_an_unknown_id():
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_arch("gpt-2")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_from_numpy_round_trip(arch, dtype):
    params, j_params = _params(arch, dtype)
    got, want = _leaves(params), _leaves(j_params)
    assert got.keys() == want.keys()
    assert {"/embed", "/ln_f/w", "/layers/attn/wq"} <= got.keys()
    for name, t in got.items():
        w = np.asarray(want[name])
        assert tuple(t.shape) == w.shape, name
        assert str(t.dtype).split(".")[-1] == w.dtype.name, name
        # the same bits, bf16 included
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), w)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_follows_the_reference_tree_and_dtypes(arch):
    cfg, _ = _cfgs(arch, "bfloat16")
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    got, want = _leaves(params), _leaves(_params(arch, "bfloat16")[1])
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape, name
        assert str(t.dtype).split(".")[-1] == want[name].dtype.name, name
    vocab = cfg.vocab_size
    assert not params["embed"][vocab:].any()
    w = params["layers"]["mlp"]["wg"].float()
    scale = cfg.d_model ** -0.5
    assert abs(w.std().item() - scale) < 0.1 * scale


# ---------------------------------------------------------------------------
# forward, prefill, decode against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(arch, dtype):
    cfg, j_cfg = _cfgs(arch, dtype)
    params, j_params = _params(arch, dtype)
    toks = _tokens(cfg)
    got, aux = api.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    want, _ = j_api.forward(j_params, j_cfg, {"tokens": jnp.asarray(toks)})
    assert got.dtype == torch.float32 and aux == 0.0
    assert got.shape == want.shape
    _logits_close(got, want, cfg, TOL[dtype])


def _cache_close(got, want, dtype):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys() == {"/layers/k", "/layers/v",
                                    "/layers/slot_pos"}
    for name in g:
        assert tuple(g[name].shape) == w[name].shape, name
        assert str(g[name].dtype).split(".")[-1] == w[name].dtype.name
    np.testing.assert_array_equal(g["/layers/slot_pos"].numpy(),
                                  np.asarray(w["/layers/slot_pos"]))
    for name in ("/layers/k", "/layers/v"):
        if dtype == "float32":
            np.testing.assert_allclose(g[name].float().numpy(),
                                       _np(w[name]), rtol=2 ** -7, atol=0)
        else:
            np.testing.assert_allclose(g[name].float().numpy(),
                                       _np(w[name]), rtol=0, atol=5e-2)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(arch, dtype):
    cfg, j_cfg = _cfgs(arch, dtype)
    params, j_params = _params(arch, dtype)
    toks = _tokens(cfg, seed=1)
    # max_len 24 > the danube smoke window of 16: a ring cache there
    got, cache = api.prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                             24)
    want, j_cache = j_api.prefill(j_params, j_cfg,
                                  {"tokens": jnp.asarray(toks)}, 24)
    _logits_close(got, want, cfg, TOL[dtype])
    _cache_close(cache, j_cache, dtype)
    nxt = _tokens(cfg, b=2, s=1, seed=2)[:, 0]
    for pos in (16, 17):
        got, cache = api.decode_step(params, cfg, cache,
                                     torch.from_numpy(nxt), pos)
        want, j_cache = j_api.decode_step(j_params, j_cfg, j_cache,
                                          jnp.asarray(nxt),
                                          jnp.asarray(pos, jnp.int32))
        _logits_close(got, want, cfg, TOL[dtype])
        _cache_close(cache, j_cache, dtype)
        nxt = torch.argmax(got[:, :cfg.vocab_size], -1).numpy().astype(
            np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch):
    cfg, j_cfg = _cfgs(arch, "bfloat16")
    for max_len in (8, 32):
        got = api.init_cache(cfg, 3, max_len, device="cpu")
        want = j_api.init_cache(j_cfg, 3, max_len)
        g, w = _leaves(got), _leaves(want)
        assert g.keys() == w.keys()
        for name in g:
            assert tuple(g[name].shape) == w[name].shape
            np.testing.assert_array_equal(g[name].float().numpy(),
                                          _np(w[name]))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """The port's own consistency (tests/test_models.py:61):
    decode(prefill(prompt), next) == forward(prompt + next), bf16."""
    cfg, _ = _cfgs(arch, "bfloat16")
    params, _ = _params(arch, "bfloat16")
    toks = torch.from_numpy(_tokens(cfg, seed=3))
    logits_pf, cache = api.prefill(params, cfg, {"tokens": toks}, 20)
    nxt = torch.from_numpy(_tokens(cfg, b=2, s=1, seed=4))
    full, _ = api.forward(params, cfg,
                          {"tokens": torch.cat([toks, nxt], 1)})
    np.testing.assert_allclose(logits_pf.numpy(), full[:, -2].numpy(),
                               rtol=2e-2, atol=2e-2)
    dec, _ = api.decode_step(params, cfg, cache, nxt[:, 0],
                             torch.tensor(16, dtype=torch.int32))
    np.testing.assert_allclose(dec.numpy(), full[:, -1].numpy(), rtol=5e-2,
                               atol=5e-2)


def test_swa_ring_buffer_matches_linear_cache():
    """Danube's sliding window (16 in the smoke config): a 24-token
    prompt into a 32-position cache takes a ring of 16 slots, and decoding
    from it equals the full forward (tests/test_models.py:87)."""
    cfg, _ = _cfgs("h2o-danube-1.8b", "bfloat16")
    params, _ = _params("h2o-danube-1.8b", "bfloat16")
    toks = torch.from_numpy(_tokens(cfg, b=1, s=24, seed=5))
    _, ring = api.prefill(params, cfg, {"tokens": toks}, 32)
    assert ring["layers"]["k"].shape[2] == 16
    # positions 8..23, slot = position % 16
    np.testing.assert_array_equal(ring["layers"]["slot_pos"][0].numpy(),
                                  np.r_[16:24, 8:16])
    nxt = torch.from_numpy(_tokens(cfg, b=1, s=1, seed=6))
    full, _ = api.forward(params, cfg, {"tokens": torch.cat([toks, nxt], 1)})
    dec, ring = api.decode_step(params, cfg, ring, nxt[:, 0], 24)
    np.testing.assert_allclose(dec.numpy(), full[:, -1].numpy(), rtol=5e-2,
                               atol=5e-2)
    # the new token overwrote position 8's slot
    assert ring["layers"]["slot_pos"][0, 8].item() == 24


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_full_at_the_flash_threshold(arch):
    """S = 2048 takes ``ops.flash_attention_gqa`` (its plain version on
    the CPU); the reference takes its chunked path off the TPU."""
    cfg, j_cfg = _cfgs(arch, "float32")
    params, j_params = _params(arch, "float32")
    s = layers.CHUNKED_THRESHOLD
    x = np.random.RandomState(7).randn(1, s, cfg.d_model).astype(np.float32)
    p = transformer._layer(params["layers"], 0)["attn"]
    j_p = jax.tree.map(lambda a: a[0], j_params["layers"])["attn"]
    got, (k, v) = layers.attention_full(p, cfg.attention, torch.from_numpy(x),
                                        torch.arange(s), cfg.d_model,
                                        return_kv=True)
    want, (j_k, j_v) = j_layers.attention_full(
        j_p, j_cfg.attention, jnp.asarray(x), jnp.arange(s), cfg.d_model,
        return_kv=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(k.numpy(), np.asarray(j_k), rtol=2e-5,
                               atol=2e-5)


def test_pick_chunk_matches_reference():
    for s in (1, 7, 100, 1024, 2048, 2049, 3000, 4096):
        for target in (1, 64, 1024):
            assert layers.pick_chunk(s, target) == j_layers.pick_chunk(
                s, target)
    assert layers.CHUNKED_THRESHOLD == j_layers.CHUNKED_THRESHOLD


def test_step_factories_call_the_api():
    cfg, _ = _cfgs("smollm-360m", "float32")
    params, _ = _params("smollm-360m", "float32")
    toks = torch.from_numpy(_tokens(cfg, seed=9))
    got, cache = api.make_prefill_step(cfg, 20)(params, {"tokens": toks})
    want, want_cache = api.prefill(params, cfg, {"tokens": toks}, 20)
    assert torch.equal(got, want)
    nxt = toks[:, 0]
    got, _ = api.make_decode_fn(cfg)(params, cache,
                                     {"tokens": nxt, "pos": 16})
    want, _ = api.decode_step(params, cfg, want_cache, nxt, 16)
    assert torch.equal(got, want)


def test_unported_families_are_refused():
    """What the reference's transformer refuses, the port refuses: a
    family other than its decoder, vlm, ssm and hybrid (the
    encoder-decoder goes to ``models.encdec``), and a decoder whose
    attention is neither GQA nor MLA."""
    cfg, _ = _cfgs("smollm-360m", "float32")
    params, _ = _params("smollm-360m", "float32")
    tokens = {"tokens": torch.zeros(1, 4, dtype=torch.int32)}
    for bad, match in ((cfg.replace(family="audio"), "family 'audio'"),
                       (cfg.replace(family="moe"), "family 'moe'"),
                       (cfg.replace(attention=dataclasses.replace(
                           cfg.attention, kind="none")), "attention 'none'")):
        with pytest.raises(ValueError, match=match):
            api.forward(params, bad, tokens)


# ---------------------------------------------------------------------------
# serving
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


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_engine_matches_reference_engine(arch):
    cfg, j_cfg = _cfgs(arch, "float32")
    params, j_params = _params(arch, "float32")
    rng = np.random.RandomState(8)
    # prompts of unequal lengths: the wave left-pads with token 0
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 3, 6, 4, 2)]
    got, engine = _serve(DecodeEngine, Request, cfg, params, prompts)
    want, _ = _serve(JDecodeEngine, JRequest, j_cfg, j_params, prompts)
    for g, w in zip(got, want):
        assert len(g.output) == g.max_new_tokens
        assert g.output == w.output
    stats = engine.stats()
    assert stats["n"] == len(prompts)
    assert 0 < stats["p50_ms"] <= stats["p95_ms"] <= stats["p99_ms"]


def test_serve_launcher_serves_an_lm_on_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        stats = t_serve.main(["--arch", "smollm-360m", "--smoke", "--device",
                              "cpu", "--requests", "4", "--batch-size", "2",
                              "--prompt-len", "4", "--new-tokens", "3"])
    assert stats["n"] == 4 and stats["p50_ms"] > 0
    assert out.getvalue().startswith("lm serve stats:")


def test_serve_launcher_module_runs_and_refuses_the_rest():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "smollm-360m", "--smoke", "--device", "cpu", "--requests", "2",
         "--batch-size", "2", "--prompt-len", "3", "--new-tokens", "2"],
        env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "lm serve stats" in run.stdout
    for arch in ("gpt-2", "rwkv-7"):
        with pytest.raises(SystemExit):
            t_serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
