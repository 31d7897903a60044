"""The port's MoE, MLA and vision-prefix decoders against the JAX package,
for the four smoke configs (kimi-k2-1t-a32b, arctic-480b with its dense
residual branch, minicpm3-4b, internvl2-2b): configs, the params tree,
forward (logits and the MoE aux loss), prefill and its cache, decode,
the reference's prefill/decode law, the loss and its gradients, one
``make_train_step``, the decode engine, ``LMSynthetic``'s vlm batch,
the launchers; and the init's draws, which must keep every dense
decoder's bits. Params come from the reference's ``api.init`` through
numpy.

Routing first: every MoE comparison in fp32 asserts that both sides
chose the same experts and slots (the port's ``_slots`` recorded against
the reference's, layer by layer) before comparing values. In bf16 the
two frameworks round the router's input differently, and a near-tie
can route a token to another expert on one side (a routing flip): that
moves the token's FFN output by a whole expert's share and, through the
token-major ranks, which later choices the capacity drops. So in bf16
the flips are counted over eight prompts against an fp32 evaluation of
the reference on the same (bf16) weights: the port's flips at most twice
the reference's own bf16 flips, plus four pairs (seen over twelve
prompts: 12 against 8 on kimi's smoke config, 16 against 13 on
arctic's). The MoE decoders' bf16 caches are compared at layer 0
(before any MoE), their gradients in fp32 only; logits and losses are
compared as they come out.

Tolerances (``test_torch_lm.py``'s, for the same reasons):
  * fp32: logits, aux and losses 1e-5; gradients 1e-5 of the leaf's
    largest; caches one bf16 ulp (the cache is bf16 on both sides).
  * bf16: the reference's 2e-2 / 5e-2 (tests/test_models.py); caches
    5e-2; the loss 2e-3 relative.
  * one train step (fp32): params within 1e-5 but for 1e-3 of the
    elements, none further than 2 lr (AdamW's first step moves a param
    by ~lr sign(g)).
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
from repro.models import moe as j_moe
from repro.serving import DecodeEngine as JDecodeEngine
from repro.serving import Request as JRequest
from repro_torch.configs import registry
from repro_torch.data import LMSynthetic
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import api, embedding, layers, moe, transformer
from repro_torch.models import params as t_params
from repro_torch.optim import tree_leaves, tree_map
from repro_torch.serving import DecodeEngine, Request

torch.set_num_threads(1)

ARCHS = ("kimi-k2-1t-a32b", "arctic-480b", "minicpm3-4b", "internvl2-2b")
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 5e-2)}
LR = 3e-4


def _cfgs(arch, dtype, **kw):
    return (registry.get_smoke(arch).replace(dtype=dtype, **kw),
            j_registry.get_smoke(arch).replace(dtype=dtype, **kw))


_PARAMS = {}


def _params(arch, dtype):
    """(port params on the CPU, JAX params) from the reference's init;
    a fresh port copy each call (the train step works in place)."""
    key = (arch, dtype)
    if key not in _PARAMS:
        _, j_cfg = _cfgs(arch, dtype)
        _PARAMS[key] = j_api.init(jax.random.PRNGKey(0), j_cfg)[0]
    j_params = _PARAMS[key]
    return (api.params_from_numpy(jax.tree.map(np.asarray, j_params), "cpu"),
            j_params)


def _batch(cfg, b=2, s=16, seed=0):
    """(port batch, JAX batch): tokens, and a vlm model's patches."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
    t, j = {"tokens": torch.from_numpy(toks)}, {"tokens": jnp.asarray(toks)}
    if cfg.family == "vlm":
        pt = rng.randn(b, cfg.n_frontend_tokens, cfg.d_model).astype(
            np.float32)
        t["patches"], j["patches"] = torch.from_numpy(pt), jnp.asarray(pt)
    return t, j


def _fp32(j_params):
    """The reference's params cast to fp32: the same weights."""
    return jax.tree.map(lambda a: a.astype(jnp.float32), j_params)


def _positions(cfg, s):
    return s + (cfg.n_frontend_tokens if cfg.family == "vlm" else 0)


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
    assert (got.numpy()[..., v:] == -1e30).all()


class _Slots:
    """Records each MoE layer's (expert choices, slot, valid) on both
    sides."""

    def __init__(self, monkeypatch):
        self.port, self.ref = [], []
        t_inner, j_inner = moe._slots, j_moe._slots

        def t_spy(idx, e, c):
            out = t_inner(idx, e, c)
            self.port.append(tuple(np.asarray(a) for a in (idx,) + out))
            return out

        def j_spy(idx, e, c):
            # inside the reference's scan: the values reach the host
            # through a callback, in order
            out = j_inner(idx, e, c)
            jax.debug.callback(lambda *a: self.ref.append(
                tuple(np.asarray(x) for x in a)), idx, *out, ordered=True)
            return out
        monkeypatch.setattr(moe, "_slots", t_spy)
        monkeypatch.setattr(j_moe, "_slots", j_spy)

    def _pairs(self):
        jax.effects_barrier()
        assert len(self.port) == len(self.ref) > 0
        pairs = list(zip(self.port, self.ref))
        self.port.clear()
        self.ref.clear()
        return pairs

    def check(self):
        """The same experts, slots and drops, exactly."""
        for (i, s, v), (ji, js, jv) in self._pairs():
            np.testing.assert_array_equal(i, ji)
            np.testing.assert_array_equal(s, js)
            np.testing.assert_array_equal(v, jv)

    def expert_sets(self):
        """(port's, reference's) expert choices, sorted, layer by layer."""
        pairs = self._pairs()
        return ([np.sort(p[0], -1) for p, _ in pairs],
                [np.sort(r[0], -1) for _, r in pairs])


# ---------------------------------------------------------------------------
# configs, registry, params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference_field_by_field(arch):
    for t_cfg, j_cfg in ((registry.get_arch(arch), j_registry.get_arch(arch)),
                         (registry.get_smoke(arch),
                          j_registry.get_smoke(arch))):
        assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    assert arch in registry.ARCH_IDS
    transformer.check_ported(registry.get_arch(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_follows_the_reference_tree_and_dtypes(arch):
    cfg, _ = _cfgs(arch, "bfloat16")
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    got, want = _leaves(params), _leaves(_params(arch, "bfloat16")[1])
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape, name
        assert str(t.dtype).split(".")[-1] == want[name].dtype.name, name
    if cfg.moe is not None:
        assert params["layers"]["moe"]["wr"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["smollm-360m", "h2o-danube-1.8b",
                                  "qwen1.5-4b"])
def test_init_keeps_the_dense_decoders_draws(arch):
    """Each stacked leaf is filled in place layer by layer, and the draws
    keep their order and bits: the same params as drawing every layer's
    tree eagerly and stacking the trees (the init before
    ``init_stacked``)."""
    cfg = registry.get_smoke(arch)
    got = api.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    b = t_params.Builder(torch.Generator().manual_seed(3),
                         dtype=torch.bfloat16, device="cpu")
    want = {"embed": embedding.init_table(b, cfg.vocab_size, cfg.d_model),
            "layers": t_params.stack_layers(
                [transformer._init_attn_block(b, cfg)
                 for _ in range(cfg.n_layers)]),
            "ln_f": layers.init_norm(b, cfg.d_model, cfg.norm)}
    if not cfg.tie_embeddings:
        want["unembed"] = embedding.init_unembed(b, cfg.vocab_size,
                                                 cfg.d_model)
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for name in g:
        assert g[name].dtype == w[name].dtype, name
        assert torch.equal(g[name].view(torch.int16)
                           if g[name].dtype == torch.bfloat16 else g[name],
                           w[name].view(torch.int16)
                           if w[name].dtype == torch.bfloat16 else w[name]), \
            name


def test_normal_draws_a_leaf_past_max_draw_a_block_of_rows_at_a_time(
        monkeypatch):
    """Past MAX_DRAW values a leaf is drawn a block of leading rows at a
    time: each block the draw of its shape, in order; a leaf within
    MAX_DRAW is one draw."""
    monkeypatch.setattr(t_params, "MAX_DRAW", 100)
    b = t_params.Builder(torch.Generator().manual_seed(0),
                         dtype=torch.bfloat16, device="cpu")
    got = b.normal((7, 5, 6))                  # 210 values, blocks of 3 rows
    g = torch.Generator().manual_seed(0)
    scale = 7 ** -0.5
    want = torch.cat([torch.randn((n, 5, 6), generator=g) * scale
                      for n in (3, 3, 1)]).to(torch.bfloat16)
    assert torch.equal(got, want)
    small = b.normal((4, 5))
    assert torch.equal(small, (torch.randn((4, 5), generator=g)
                               * 4 ** -0.5).to(torch.bfloat16))


def test_param_bytes_stay_the_model_plus_one_block(monkeypatch):
    """``init_stacked`` allocates each stacked leaf once: no second copy
    of a leaf (``stack_layers``) and no fp32 temporary past one block of
    rows (at least one row: here one expert)."""
    monkeypatch.setattr(t_params, "MAX_DRAW", 1000)
    sizes = []
    real = torch.randn

    def spy(*a, **k):
        t = real(*a, **k)
        sizes.append(t.numel())
        return t
    monkeypatch.setattr(torch, "randn", spy)
    cfg = registry.get_smoke("kimi-k2-1t-a32b")
    api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    e, d, ff = cfg.moe.n_experts, cfg.d_model, cfg.moe.expert_ff
    # an expert leaf of a layer (8 x 64 x 64) in blocks of one expert:
    # E draws a leaf a layer, and nothing larger
    assert max(sizes) == d * ff
    assert sizes.count(d * ff) == 3 * e * cfg.n_layers


# ---------------------------------------------------------------------------
# forward, prefill, decode against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(arch, dtype, monkeypatch):
    cfg, j_cfg = _cfgs(arch, dtype)
    params, j_params = _params(arch, dtype)
    tb, jb = _batch(cfg)
    slots = _Slots(monkeypatch)
    got, aux = api.forward(params, cfg, tb)
    want, j_aux = j_api.forward(j_params, j_cfg, jb)
    if cfg.moe is not None and dtype == "float32":
        slots.check()
    assert got.dtype == torch.float32 and got.shape == want.shape
    _logits_close(got, want, cfg, TOL[dtype])
    assert aux.dtype == torch.float32 and aux.dim() == 0
    np.testing.assert_allclose(aux.item(), float(j_aux), rtol=1e-5 if dtype
                               == "float32" else 2e-2)
    assert (aux.item() > 0) == (cfg.moe is not None)


def test_forward_with_dropping_capacity_matches_reference(monkeypatch):
    """kimi's smoke config at capacity factor 0.5: choices drop, and the
    port drops exactly the reference's."""
    arch = "kimi-k2-1t-a32b"
    cfg, j_cfg = _cfgs(arch, "float32")
    m = dataclasses.replace(cfg.moe, capacity_factor=0.5)
    cfg, j_cfg = cfg.replace(moe=m), j_cfg.replace(
        moe=dataclasses.replace(j_cfg.moe, capacity_factor=0.5))
    params, j_params = _params(arch, "float32")
    tb, jb = _batch(cfg, s=24, seed=4)
    slots = _Slots(monkeypatch)
    got, aux = api.forward(params, cfg, tb)
    want, j_aux = j_api.forward(j_params, j_cfg, jb)
    assert any(not v.all() for _, _, v in slots.port)
    slots.check()
    _logits_close(got, want, cfg, TOL["float32"])
    np.testing.assert_allclose(aux.item(), float(j_aux), rtol=1e-5)


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "arctic-480b"])
def test_bf16_routing_flips_no_more_than_the_references(arch, monkeypatch):
    """Over eight prompts, the (token, layer) pairs whose expert set
    differs from an fp32 evaluation of the same weights: the port's bf16
    forward at most twice the reference's bf16 forward, plus four."""
    cfg, j_cfg = _cfgs(arch, "bfloat16")
    params, j_params = _params(arch, "bfloat16")
    j32, j_cfg32 = _fp32(j_params), j_cfg.replace(dtype="float32")
    slots = _Slots(monkeypatch)
    flips = {"port": 0, "ref": 0}
    for seed in range(8):
        tb, jb = _batch(cfg, seed=20 + seed)
        api.forward(params, cfg, tb)
        j_api.forward(j_params, j_cfg, jb)
        port16, ref16 = slots.expert_sets()
        api.forward(params, cfg, tb)          # keeps the two lists paired
        j_api.forward(j32, j_cfg32, jb)
        _, ref32 = slots.expert_sets()
        for who, sets in (("port", port16), ("ref", ref16)):
            flips[who] += sum(int((a != b).any(-1).sum())
                              for a, b in zip(sets, ref32))
    assert flips["port"] <= 2 * flips["ref"] + 4, flips


def _cache_close(got, want, dtype, layers=None):
    """Leaf by leaf; ``layers`` limits the values compared to the first
    few layers (the shapes and positions are held whole)."""
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    if layers is not None:
        g = {k: t if k.endswith("slot_pos") else t[:layers]
             for k, t in g.items()}
        w = {k: a if k.endswith("slot_pos") else a[:layers]
             for k, a in w.items()}
    for name in g:
        assert tuple(g[name].shape) == w[name].shape, name
        assert str(g[name].dtype).split(".")[-1] == w[name].dtype.name
        if name.endswith("slot_pos"):
            np.testing.assert_array_equal(g[name].numpy(),
                                          np.asarray(w[name]))
        elif dtype == "float32":
            np.testing.assert_allclose(g[name].float().numpy(),
                                       _np(w[name]), rtol=2 ** -7, atol=0)
        else:
            np.testing.assert_allclose(g[name].float().numpy(),
                                       _np(w[name]), rtol=0, atol=5e-2)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(arch, dtype, monkeypatch):
    cfg, j_cfg = _cfgs(arch, dtype)
    params, j_params = _params(arch, dtype)
    tb, jb = _batch(cfg, seed=1)
    max_len = _positions(cfg, 16) + 8
    # bf16 MoE: a routing flip in layer 0 moves later layers' keys by an
    # expert's share, so their caches are compared at layer 0
    upto = 1 if cfg.moe is not None and dtype == "bfloat16" else None
    slots = _Slots(monkeypatch)
    got, cache = api.prefill(params, cfg, tb, max_len)
    want, j_cache = j_api.prefill(j_params, j_cfg, jb, max_len)
    if cfg.moe is not None and dtype == "float32":
        slots.check()
    _logits_close(got, want, cfg, TOL[dtype])
    _cache_close(cache, j_cache, dtype, upto)
    nxt = np.random.RandomState(2).randint(0, cfg.vocab_size, 2).astype(
        np.int32)
    for pos in (_positions(cfg, 16), _positions(cfg, 16) + 1):
        got, cache = api.decode_step(params, cfg, cache,
                                     torch.from_numpy(nxt), pos)
        want, j_cache = j_api.decode_step(j_params, j_cfg, j_cache,
                                          jnp.asarray(nxt),
                                          jnp.asarray(pos, jnp.int32))
        if cfg.moe is not None and dtype == "float32":
            slots.check()
        _logits_close(got, want, cfg, TOL[dtype])
        _cache_close(cache, j_cache, dtype, upto)
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
    """The reference's law (tests/test_models.py:61) in the port, bf16:
    prefill's last logits == forward's at position -2, and
    decode(prefill(prompt), next) == forward(prompt + next)."""
    cfg, _ = _cfgs(arch, "bfloat16")
    params, _ = _params(arch, "bfloat16")
    tb, _ = _batch(cfg, seed=3)
    total = _positions(cfg, 16)
    logits_pf, cache = api.prefill(params, cfg, tb, total + 4)
    nxt = torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg.vocab_size, (2, 1)).astype(np.int32))
    full, _ = api.forward(params, cfg,
                          dict(tb, tokens=torch.cat([tb["tokens"], nxt], 1)))
    np.testing.assert_allclose(logits_pf.numpy(), full[:, -2].numpy(),
                               rtol=2e-2, atol=2e-2)
    dec, _ = api.decode_step(params, cfg, cache, nxt[:, 0], total)
    np.testing.assert_allclose(dec.numpy(), full[:, -1].numpy(), rtol=5e-2,
                               atol=5e-2)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_reference(arch, dtype):
    """The loss carries aux_loss_coef x aux (a vlm model's logits cut to
    the text region); gradients by autograd against jax.grad (a MoE
    decoder's in fp32 only: see the module's note on routing flips)."""
    cfg, j_cfg = _cfgs(arch, dtype)
    params, j_params = _params(arch, dtype)
    tb, jb = _batch(cfg, seed=5)
    req = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = api.loss(req, cfg, tb)
    grads = torch.autograd.grad(loss, tree_leaves(req))
    j_loss, j_grads = jax.value_and_grad(j_api.loss)(j_params, j_cfg, jb)
    rtol, gtol = (1e-5, 1e-5) if dtype == "float32" else (2e-3, 5e-2)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=rtol)
    if cfg.moe is not None and dtype == "bfloat16":
        return
    it = iter(grads)
    g = _leaves(tree_map(lambda _: next(it), req))
    w = _leaves(j_grads)
    assert g.keys() == w.keys()
    for name in g:
        ref = _np(w[name])
        err = np.abs(g[name].float().numpy() - ref).max()
        assert err <= gtol * np.abs(ref).max(), (name, err)


@pytest.mark.parametrize("arch", ARCHS)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_engine_matches_reference_engine(arch):
    """Tokens only, a vlm model too: the reference's engine feeds no
    patches."""
    cfg, j_cfg = _cfgs(arch, "float32")
    params, j_params = _params(arch, "float32")
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 3, 6, 4, 2)]
    got, engine = _serve(DecodeEngine, Request, cfg, params, prompts)
    want, _ = _serve(JDecodeEngine, JRequest, j_cfg, j_params, prompts)
    for g, w in zip(got, want):
        assert len(g.output) == g.max_new_tokens
        assert g.output == w.output
    if cfg.attention.kind == "mla":
        assert set(engine.cache["layers"]) == {"c_kv", "k_rope", "slot_pos"}


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_lm_synthetic_vlm_batch_equals_reference(smoke):
    """The patches are drawn before the tokens, as the reference draws
    them: the same seed gives the same arrays."""
    get = registry.get_smoke if smoke else registry.get_arch
    j_get = j_registry.get_smoke if smoke else j_registry.get_arch
    for seed in (0, 3):
        got = LMSynthetic(get("internvl2-2b"), seed)
        want = JLMSynthetic(j_get("internvl2-2b"), seed)
        p = get("internvl2-2b").n_frontend_tokens
        for b, s in ((2, p + 16), (1, p + 40)):
            a, w = got.batch(b, s), want.batch(b, s)
            assert a.keys() == w.keys() == {"patches", "tokens"}
            assert a["patches"].dtype == np.float32
            np.testing.assert_array_equal(a["patches"], w["patches"])
            np.testing.assert_array_equal(a["tokens"], w["tokens"])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_serves_the_new_archs_on_cpu(arch):
    out = io.StringIO()
    with redirect_stdout(out):
        stats = t_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--requests", "3", "--batch-size", "2",
                              "--prompt-len", "4", "--new-tokens", "3"])
    assert stats["n"] == 3 and stats["p50_ms"] > 0


@pytest.mark.parametrize("arch", ["internvl2-2b", "kimi-k2-1t-a32b"])
def test_train_launcher_trains_the_new_archs_on_cpu(arch, monkeypatch):
    """A vlm batch's patches reach the step as bf16, as the reference's
    launcher casts them."""
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
        loss = t_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                             "--steps", "2", "--batch-size", "2",
                             "--seq-len", "24"])
    assert np.isfinite(loss) and len(seen) == 2
    if arch == "internvl2-2b":
        assert seen[0] == {"patches": torch.bfloat16, "tokens": torch.int32}
