"""Multi-head latent attention on a (data, model) mesh, and Adafactor's
statistics across shards.

minicpm3-4b SMOKE (4 heads, 2 / 2 a rank; the low-rank projections and
the latent replicated, ``wq_b`` / ``wk_b`` / ``wv_b`` column blocks and
``wo`` a row block of whole heads) on 4 gloo CPU ranks as (2, 2)
(``distributed.spawn``, started once), against the JAX reference's own
``mesh=`` steps on 4 fake host devices (one subprocess, on the inputs it
saves): 2 AdamW train steps, prefill and 3 decode steps; the decode's
absorbed and naive paths equal on the mesh, its latent cache whole on
every 'model' rank. An uneven split, a 3-rank 'model' axis (2 / 1 / 1
heads, S a multiple of 3), against the port's one-rank path. The head
split at TP 1, 2, 4 and 16 of the three configs of ROADMAP item 13d's
first part. And on the (2, 2) ranks, Adafactor on a leaf of each spec
kind (a column and a row block of whole heads, uneven blocks, the
experts' ``("expert", "fsdp", None)``, replicated, a vector of heads,
and a stacked leaf through ``layerwise``), two steps from zeros, against
the same steps on the whole leaf: its statistics, its normaliser, its
update's RMS and its update.

Tolerances. The configs run in fp32 on both sides, as
``tests/test_torch_lm_mesh_moe.py``'s (its docstring): losses and grad
norms rtol 1e-5; logits rtol and atol 1e-3 (the bf16 decode cache);
AdamW's params within 1e-5 but for at most 1e-3 of the elements, none
further apart than 2.02 lr a step; absorbed against naive within
``tests/test_models.py``'s 1e-3 (the two contract the latent in other
orders). Adafactor's sharded statistics: the rank's fp32 sums summed
over the axes that split the leaf, against fp32 sums over the whole
leaf, within 1e-6 of the largest of them (at most a few hundred terms of
like sign, each sum's rounding ~2^-24 a term).

The rank functions import no JAX: they are pickled to the children by
this module's name, so JAX runs only in the reference's subprocess.
"""
import io
import os
import subprocess
import sys
import textwrap
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.data import make_placer
from repro_torch.distributed import collectives, sharding, spawn
from repro_torch.launch import serve as t_serve
from repro_torch.launch.mesh import Mesh
from repro_torch.models import api, mla
from repro_torch.optim import adafactor, layerwise, tree_map, tree_paths
from repro_torch.optim import optimizers as t_optim

torch.set_num_threads(1)

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCH = "minicpm3-4b"
SHAPE, AXES = (2, 2), ("data", "model")
B, S, MAX_LEN, DECODE, STEPS = 4, 64, 80, 3, 2
# the 3-rank 'model' axis: S, B, and the SMOKE config with its vocab
# and d_ff made multiples of 3 (its 256 and 160 do not split in 3)
UNEVEN_S, UNEVEN_B = 48, 2
UNEVEN_CFG = dict(vocab_size=384, d_ff=192)
LR, STEP_MAX = 3e-4, 1.01      # AdamW's (the default optimizer)
RTOL = 1e-5
FLOOR, FLOOR_SHARE = 1e-5, 1e-3
LOGIT_TOL = 1e-3
ABSORBED_TOL = 1e-3
STAT_TOL = 1e-6
FULL = ("kimi-k2-1t-a32b", "arctic-480b", "minicpm3-4b")

REF_CODE = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.registry import SMOKE_ARCHS
    from repro.launch.mesh import make_mesh
    from repro.models import api
    B, S, MAX_LEN, DECODE, STEPS = 4, 64, 80, 3, 2
    out = {}
    mesh = make_mesh((2, 2), ('data', 'model'))

    def flat(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf)

    cfg = SMOKE_ARCHS["minicpm3-4b"].replace(dtype="float32")
    params, _ = api.init(jax.random.PRNGKey(0), cfg)
    flat("p0", params)
    rng = np.random.RandomState(7)
    _, opt, step = api.make_train_step(cfg, mesh=mesh)
    st, p = opt.init(params), params
    with mesh:
        jstep = jax.jit(step)
        for s in range(STEPS):
            toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
            out[f"tokens{s}"] = toks
            p, st, m = jstep(p, st, {"tokens": jnp.asarray(toks)})
            out[f"loss{s}"] = np.asarray(m["loss"])
            out[f"gnorm{s}"] = np.asarray(m["grad_norm"])
            flat(f"p{s + 1}", p)
        toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
        out["prompt"] = toks
        logits, cache = jax.jit(api.make_prefill_step(cfg, MAX_LEN, mesh))(
            params, {"tokens": jnp.asarray(toks)})
        out["prefill"] = np.asarray(logits)
        dec = jax.jit(api.make_decode_fn(cfg, mesh))
        for i in range(DECODE):
            t = rng.randint(0, cfg.vocab_size, (B,)).astype(np.int32)
            out[f"dtok{i}"] = t
            logits, cache = dec(params, cache, {
                "tokens": jnp.asarray(t), "pos": jnp.int32(S + i)})
            out[f"decode{i}"] = np.asarray(logits)
    np.savez(sys.argv[1], **out)
""")


def _cfg(**kw):
    return registry.get_smoke(ARCH).replace(dtype="float32", **kw)


def _template(**kw):
    return api.init(torch.Generator().manual_seed(0), _cfg(**kw),
                    device="cpu")


def _load(z, prefix, template):
    def build(t, path=""):
        if isinstance(t, dict):
            return {k: build(t[k], f"{path}[{k!r}]") for k in t}
        return torch.from_numpy(np.array(z[prefix + path])).to(t.dtype)
    return build(template)


def _fake(shape, coords, axes=AXES):
    return Mesh(tuple((a, None, c, n)
                      for a, c, n in zip(axes, coords, shape)))


# ---------------------------------------------------------------------------
# Adafactor on one leaf of each spec kind
# ---------------------------------------------------------------------------

def _heads(h, kh, hd):
    return sharding.Heads(h, kh, hd, "q")


# name: (whole shape, logical spec, layerwise's min_layers or None)
AF_CASES = {
    "column heads": ((16, 24), (None, _heads(6, 2, 4)), None),
    "row heads": ((24, 16), (_heads(6, 2, 4), None), None),
    # 3 query heads on 1 kv head: 2 / 1 at 2 ranks, blocks of 8 and 4
    "uneven blocks": ((16, 12), (None, _heads(3, 1, 4)), None),
    "experts": ((4, 8, 6), ("expert", "fsdp", None), None),
    "replicated": ((16, 12), (None, None), None),
    "vector of heads": ((24,), (_heads(6, 2, 4),), None),
    "stacked through layerwise": ((2, 16, 24), (None, None, _heads(6, 2, 4)),
                                  2),
}
AF_STEPS = 2


def _af_grads(shape, case):
    gen = torch.Generator().manual_seed(sorted(AF_CASES).index(case))
    return [torch.randn(shape, generator=gen) for _ in range(AF_STEPS)]


def _af_run(case, mesh=None):
    """Two Adafactor steps (lr 1) from zeros on the case's leaf: the
    rank's block on ``mesh`` with its layout, the whole leaf without ->
    (each step's update, the statistics after it, the normaliser and
    the squared gradients' mean of the first step's statistics)."""
    shape, spec, min_layers = AF_CASES[case]
    opt = adafactor(1.0)
    if min_layers:
        opt = layerwise(opt, min_layers=min_layers)
    grads = _af_grads(shape, case)
    kw, lay = {}, None
    if mesh is not None:
        res = sharding.resolve(mesh, spec)
        grads = [sharding.local_block(g, mesh, res) for g in grads]
        lay = api.leaf_layout(mesh, spec, shape)
        kw = {"layouts": {"w": lay}}
    p = {"w": torch.zeros(grads[0].shape)}
    state = opt.init(p)
    out = {"upd": [], "state": []}
    for g in grads:
        before = p["w"].clone()
        opt.update({"w": g}, state, p, **kw)
        out["upd"].append(before - p["w"])
        out["state"].append({k: v.clone() for k, v in
                             state["fac"]["w"].items()})
    vr = out["state"][0].get("vr")
    flat = lay.layer() if (lay is not None and min_layers) else lay
    if vr is not None:
        norm_vr = vr[0] if min_layers else vr
        out["norm"] = t_optim._mean(norm_vr, -1, flat, of=-2, keepdim=True)
    sq = grads[0][0] if min_layers else grads[0]
    out["ms"] = t_optim._mean_all(sq.square(), flat)
    return out


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------

def _gathered(params, mesh, **kw):
    return tree_map(lambda x, sp, t: sharding.gather_full(
        x, mesh, sharding.resolve(mesh, sp), t.shape), params,
        api.param_specs(_cfg(**kw)), _template(**kw))


def _serve(cfg, mesh, params, prompt, tokens, s, absorbed=True):
    """Prefill and a decode step a token: each rank's logits gathered
    over 'model', and the cache's latent."""
    blocks = api.shard_params(params, cfg, mesh)
    place = make_placer("cpu", mesh, api.batch_specs(cfg, mesh))
    real = mla.mla_decode
    mla.mla_decode = lambda *a, **k: real(*a, **k, absorbed=absorbed)
    try:
        logits, cache = api.make_prefill_step(cfg, MAX_LEN, mesh=mesh)(
            blocks, place({"tokens": prompt}))
        out = [collectives.all_gather(logits, mesh, "model", dim=-1)]
        dec = api.make_decode_fn(cfg, mesh=mesh)
        for i, t in enumerate(tokens):
            mine = place({"tokens": t})["tokens"]
            logits, cache = dec(blocks, cache, {"tokens": mine,
                                                "pos": s + i})
            out.append(collectives.all_gather(logits, mesh, "model",
                                              dim=-1))
    finally:
        mla.mla_decode = real
    return out, cache["layers"]["c_kv"]


def _rank(mesh, npz):
    z = np.load(npz)
    cfg = _cfg()
    p0 = _load(z, "p0", _template())
    blocks = api.shard_params(p0, cfg, mesh)
    _, opt, step = api.make_train_step(cfg, mesh=mesh)
    state = opt.init(blocks)
    place = make_placer("cpu", mesh, api.batch_specs(cfg, mesh))
    out = {"coords": tuple(mesh.rank(a) for a in AXES), "losses": [],
           "gnorms": [], "trail": [],
           "heads": blocks["layers"]["mla"]["wv_b"].shape[-1]
           // cfg.attention.mla.v_head_dim}
    for s in range(STEPS):
        blocks, state, m = step(blocks, state,
                                place({"tokens": z[f"tokens{s}"]}))
        out["losses"].append(float(m["loss"]))
        out["gnorms"].append(float(m["grad_norm"]))
        out["trail"].append(tree_map(torch.clone, _gathered(blocks, mesh)))
    prompt = z["prompt"]
    tokens = [z[f"dtok{i}"] for i in range(DECODE)]
    fresh = _load(z, "p0", _template())
    out["logits"], latent = _serve(cfg, mesh, fresh, prompt, tokens, S)
    out["naive"], _ = _serve(cfg, mesh, fresh, prompt, tokens, S,
                             absorbed=False)
    out["latent"] = latent
    out["af"] = {case: _af_run(case, mesh) for case in AF_CASES}
    return out


def _uneven_inputs():
    rng = np.random.RandomState(11)
    cfg = _cfg(**UNEVEN_CFG)
    return (rng.randint(0, cfg.vocab_size, (UNEVEN_B, UNEVEN_S))
            .astype(np.int32),
            [rng.randint(0, cfg.vocab_size, (UNEVEN_B,)).astype(np.int32)
             for _ in range(2)])


def _uneven_rank(mesh):
    """One train step, prefill and 2 decode steps on a 3-rank 'model'
    axis: 2 / 1 / 1 heads."""
    cfg = _cfg(**UNEVEN_CFG)
    toks, dec = _uneven_inputs()
    blocks = api.shard_params(_template(**UNEVEN_CFG), cfg, mesh)
    _, opt, step = api.make_train_step(cfg, mesh=mesh)
    state = opt.init(blocks)
    blocks, state, m = step(blocks, state, {"tokens": torch.from_numpy(toks)})
    logits, _ = _serve(cfg, mesh, _template(**UNEVEN_CFG), toks, dec,
                       UNEVEN_S)
    return {"loss": float(m["loss"]), "gnorm": float(m["grad_norm"]),
            "params": _gathered(blocks, mesh, **UNEVEN_CFG),
            "logits": logits,
            "heads": blocks["layers"]["mla"]["wq_b"].shape[-1]
            // (cfg.attention.mla.qk_nope_head_dim
                + cfg.attention.mla.qk_rope_head_dim)}


# ---------------------------------------------------------------------------
# the reference's run and the ranks'
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mlaref")
    npz = str(tmp / "ref.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", REF_CODE, npz],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return npz


@pytest.fixture(scope="module")
def z(ref):
    return np.load(ref)


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    work = tmp_path_factory.mktemp("mlaranks")
    return spawn(_rank, 4, backend="gloo",
                 init_file=str(work / "rendezvous"), args=(ref,),
                 timeout_s=120, join_timeout_s=240, mesh_shape=SHAPE,
                 mesh_axes=AXES)


@pytest.fixture(scope="module")
def uneven(tmp_path_factory):
    work = tmp_path_factory.mktemp("mlauneven")
    return spawn(_uneven_rank, 3, backend="gloo",
                 init_file=str(work / "rendezvous"), timeout_s=120,
                 join_timeout_s=240, mesh_shape=(3,), mesh_axes=("model",))


def _np(t):
    return np.asarray(t, np.float64)


def _logits(ranks, what, i):
    return np.concatenate([r[what][i] for r in ranks
                           if r["coords"][1] == 0])


def _params_close(got, want, tol, what):
    """AdamW's fp32 rule (module docstring) on {path: array} trees, ``tol``
    each element's bound so far (updated in place)."""
    for p in want:
        tol[p] = tol[p] + 2 * STEP_MAX * LR
        err = np.abs(got[p] - want[p])
        assert (err > FLOOR).mean() <= FLOOR_SHARE, (what, p)
        worst = int(np.argmax(err - tol[p]))
        assert err.flat[worst] <= tol[p].flat[worst], (
            what, p, err.flat[worst])


# ---------------------------------------------------------------------------
# the head split of the three configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", (1, 2, 4, 16))
@pytest.mark.parametrize("arch", FULL)
def test_head_split_of_the_moe_and_mla_configs(arch, tp):
    """Every query head once, in order, on a kv head of its rank: kimi's
    64 / 8 and arctic's 56 / 8 (kv heads replicated past TP 8), MLA's
    40 heads as MHA (3 x 8 and 2 x 8 at TP 16)."""
    a = registry.get_arch(arch).attention
    kh = a.n_heads if a.kind == "mla" else a.n_kv_heads
    split = sharding.head_split(a.n_heads, kh, tp)
    assert len(split) == tp
    g = a.n_heads // kh
    q_seen = []
    for q0, q1, k0, k1 in split:
        q_seen += range(q0, q1)
        assert all(k0 <= q // g < k1 for q in range(q0, q1))
    assert q_seen == list(range(a.n_heads))
    sizes = [q1 - q0 for q0, q1, _, _ in split]
    assert max(sizes) - min(sizes) <= 1 or kh < tp
    if (arch, tp) == ("minicpm3-4b", 16):
        assert sorted(sizes) == [2] * 8 + [3] * 8
    if tp == 16 and a.kind == "gqa":
        # 2 ranks a kv head: kimi's 8 query heads 4 / 4, arctic's 7 4 / 3
        assert sharding.kv_replicated(kh, tp)
        assert sorted(set(sizes)) == ([4] if arch == "kimi-k2-1t-a32b"
                                      else [3, 4])


def test_mla_specs_split_whole_heads():
    cfg = registry.get_arch(ARCH)
    m = cfg.attention.mla
    specs = api.param_specs(cfg)["layers"]["mla"]
    mesh = _fake((1, 16), (0, 0))
    heads = [q1 - q0 for q0, q1, _, _ in sharding.head_split(40, 40, 16)]
    for name, hd in (("wq_b", m.qk_nope_head_dim + m.qk_rope_head_dim),
                     ("wk_b", m.qk_nope_head_dim), ("wv_b", m.v_head_dim)):
        assert sharding.resolve(mesh, specs[name])[2] == sharding.Blocks(
            "model", tuple(h * hd for h in heads))
    assert sharding.resolve(mesh, specs["wo"])[1] == sharding.Blocks(
        "model", tuple(h * m.v_head_dim for h in heads))
    for name in ("wq_a", "wkv_a"):
        assert sharding.resolve(mesh, specs[name]) == (None, None, None)
    assert sharding.resolve(mesh, specs["q_norm"]["w"]) == (None, None)


def test_cache_specs_keep_the_latent_whole_over_model():
    cfg = _cfg()
    mesh = _fake(SHAPE, (1, 1))
    sh = api.cache_specs(cfg, B, 16, mesh)["layers"]
    assert sh["c_kv"].spec == sh["k_rope"].spec == (None, "data", None,
                                                     None)
    assert sh["slot_pos"].spec == (None, None)
    mine = api.init_cache(cfg, B // 2, 16, device="cpu", mesh=mesh)
    whole = api.init_cache(cfg, B, 16, device="cpu")
    for k in ("c_kv", "k_rope", "slot_pos"):
        assert sharding.local_block(whole["layers"][k], mesh,
                                    sh[k].spec).shape \
            == mine["layers"][k].shape


# ---------------------------------------------------------------------------
# against the reference's (2, 2) steps
# ---------------------------------------------------------------------------

def test_every_rank_gets_the_same_bits(ranks):
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
        assert r["gnorms"] == ranks[0]["gnorms"]
        for (path, a), (_, b) in zip(tree_paths(r["trail"][-1]),
                                     tree_paths(ranks[0]["trail"][-1])):
            assert np.array_equal(a, b), path
    for d in (0, 1):
        mine = [r for r in ranks if r["coords"][0] == d]
        for a, b in zip(mine[0]["logits"], mine[1]["logits"]):
            assert np.array_equal(a, b)
        # the latent cache: whole, the same bits on the 'model' ranks
        assert np.array_equal(mine[0]["latent"], mine[1]["latent"])
        assert mine[0]["latent"].shape[1:3] == (B // 2, MAX_LEN)
    assert [r["heads"] for r in ranks] == [2, 2, 2, 2]


def test_train_steps_match_the_reference(ranks, z):
    got = ranks[0]
    np.testing.assert_allclose(got["losses"], [float(z[f"loss{s}"])
                                               for s in range(STEPS)],
                               rtol=RTOL)
    np.testing.assert_allclose(got["gnorms"], [float(z[f"gnorm{s}"])
                                               for s in range(STEPS)],
                               rtol=RTOL)
    paths = [p for p, _ in tree_paths(got["trail"][0])]
    tol = {p: np.full(np.shape(z["p0" + p]), FLOOR) for p in paths}
    for s in range(STEPS):
        mine = {p: _np(x) for p, x in tree_paths(got["trail"][s])}
        want = {p: _np(z[f"p{s + 1}" + p]) for p in paths}
        _params_close(mine, want, tol, f"step {s}")


@pytest.mark.parametrize("i", range(1 + DECODE))
def test_prefill_and_decode_match_the_reference(ranks, z, i):
    want = z["prefill"] if i == 0 else z[f"decode{i - 1}"]
    np.testing.assert_allclose(_logits(ranks, "logits", i), want,
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("i", range(1 + DECODE))
def test_absorbed_and_naive_decode_agree_on_the_mesh(ranks, i):
    np.testing.assert_allclose(_logits(ranks, "logits", i),
                               _logits(ranks, "naive", i),
                               rtol=0, atol=ABSORBED_TOL)


# ---------------------------------------------------------------------------
# an uneven split against the one-rank path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank():
    cfg = _cfg(**UNEVEN_CFG)
    toks, dec = _uneven_inputs()
    params = _template(**UNEVEN_CFG)
    _, opt, step = api.make_train_step(cfg)
    p = tree_map(torch.clone, params)
    state = opt.init(p)
    p, state, m = step(p, state, {"tokens": torch.from_numpy(toks)})
    logits, cache = api.make_prefill_step(cfg, MAX_LEN)(
        params, {"tokens": torch.from_numpy(toks)})
    out = [logits.numpy()]
    for i, t in enumerate(dec):
        logits, cache = api.make_decode_fn(cfg)(
            params, cache, {"tokens": torch.from_numpy(t),
                            "pos": UNEVEN_S + i})
        out.append(logits.numpy())
    return {"loss": float(m["loss"]), "gnorm": float(m["grad_norm"]),
            "params": p, "logits": out}


def test_uneven_heads_match_the_one_rank_path(uneven, one_rank):
    assert [r["heads"] for r in uneven] == [2, 1, 1]
    for r in uneven:
        np.testing.assert_allclose(r["loss"], one_rank["loss"], rtol=RTOL)
        np.testing.assert_allclose(r["gnorm"], one_rank["gnorm"], rtol=RTOL)
    want = {p: _np(x) for p, x in tree_paths(one_rank["params"])}
    got = {p: _np(x) for p, x in tree_paths(uneven[0]["params"])}
    _params_close(got, want,
                  {p: np.full(x.shape, FLOOR) for p, x in want.items()},
                  "uneven")
    for i, want_l in enumerate(one_rank["logits"]):
        for r in uneven:
            np.testing.assert_allclose(r["logits"][i], want_l,
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL)


# ---------------------------------------------------------------------------
# Adafactor's statistics across shards
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def af_whole():
    return {case: _af_run(case) for case in AF_CASES}


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        np.asarray(got, np.float64), want, rtol=0,
        atol=STAT_TOL * max(np.abs(want).max(), 1e-30), err_msg=what)


@pytest.mark.parametrize("case", sorted(AF_CASES))
def test_adafactor_statistics_on_a_mesh_equal_the_whole_leafs(
        ranks, af_whole, case):
    """Each rank's block of vr, vc (or v), of the normaliser mean(vr)
    and of the update, and the squared gradient's mean (the update-RMS
    reduction), after two steps on its block, against the whole leaf's:
    a reduction over the rank's block alone misses the rest of the
    leaf."""
    shape, spec, min_layers = AF_CASES[case]
    whole = af_whole[case]
    split = False
    for r in ranks:
        mesh = _fake(SHAPE, r["coords"])
        res = sharding.resolve(mesh, spec)
        split |= any(sharding.entry_axes(e) for e in res)
        got = r["af"][case]
        for s in range(AF_STEPS):
            _close(got["upd"][s], sharding.local_block(
                whole["upd"][s], mesh, res), (case, s, "update"))
            for k, v in whole["state"][s].items():
                st_spec = (res[:-1] if k == "vr" else
                           res[:-2] + res[-1:] if k == "vc" else res)
                _close(got["state"][s][k], sharding.local_block(
                    v, mesh, st_spec), (case, s, k))
        if "norm" in whole:
            vr_spec = res[1:-1] if min_layers else res[:-1]
            _close(got["norm"], sharding.local_block(
                whole["norm"], mesh, vr_spec[:-1] + (None,)),
                (case, "normaliser"))
        _close(got["ms"], whole["ms"], (case, "mean square"))
    assert split or case == "replicated"


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FULL)
def test_serve_launcher_serves_the_configs_under_a_mesh(arch):
    """As the reference's ``serve_lm``: under ``--mesh`` an LM is served
    unsharded, as without it (the ``mesh=`` steps shard LM serving)."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--requests",
            "2", "--batch-size", "2", "--prompt-len", "4", "--new-tokens",
            "2"]
    with redirect_stdout(io.StringIO()):
        plain = t_serve.main(argv)
        meshed = t_serve.main(argv + ["--mesh", "pod"])
    assert meshed["n"] == plain["n"] == 2
