"""The LM's logical axes on a (data, model) mesh: the GQA decoders and the
vision-prefix decoder, tensor- and sequence-parallel over 'model' and
data-parallel over 'data', on 4 gloo CPU ranks as (2, 2)
(``distributed.spawn(..., mesh_shape=(2, 2), mesh_axes=("data",
"model"))``, started once), against the JAX reference's own ``mesh=``
steps on 4 fake host devices (``api.make_train_step`` /
``make_prefill_step`` / ``make_decode_fn`` with ``mesh=make_mesh((2, 2),
('data', 'model'))``, one subprocess, on the inputs it saves):

* qwen1.5-4b SMOKE (qkv bias): 2 AdamW train steps, prefill and 3 decode
  steps against the reference's;
* smollm-360m SMOKE (3 query heads on 1 kv head: the query heads split
  2 / 1, the kv head replicated): 1 train step against the reference's;
* h2o-danube-1.8b SMOKE (window 16, a ring cache) and internvl2-2b SMOKE
  (the patch prefix): a train step, prefill and 2 decode steps against
  the port's own one-rank path.

Also: the head-split rule at TP 1, 2, 4 and 16 for the four full configs;
the reference's elastic case ((4, 2) to (2, 4), ``tests/
test_distributed.py:167``) and the ranks' (2, 2) train state restored
onto (1, 4) (qwen's and smollm's), in-process over each rank's
coordinates; a sharded DLRM
publisher's broadcast served by ``Replica(mesh=, shards=)``; the LM
launcher's ``--shards 2`` (its loss against the one-rank launcher's, and
its resume bit for bit); the serve launcher's LM under ``--mesh``; and
every refusal, which names ROADMAP item 13e.

Tolerances, from the reference's own gap between its mesh and one-device
steps (qwen 5.552182 / 5.552210, max |dparam| 9.8e-4, one bf16 ulp at
the weights' scale):

* losses rtol 1e-4: bf16 partial sums of the row-parallel products are
  rounded before they are added, here and in the reference's GSPMD
  program, in other places;
* grad norms rtol 2e-3 (the first step's gradient, through the same
  roundings) and 1e-2 after a step (the params moved apart as below);
* params: each element within 2 bf16 ulps of its leaf's scale (its max
  |value|) after the steps, plus what its gradients' disagreement lets
  AdamW move it. A step moves an element by lr |m_hat / sqrt(v_hat)|,
  at most 1.0004 lr over two steps (Cauchy-Schwarz over the moments'
  weights), 1.01 lr with fp32's rounding; where the two sides' gradients
  of it (each step's, from AdamW's first moments) differ by r relative
  to the reference's up to a step, that step's moves differ by at most
  2.02 lr min(r, 1). r >= 1 is a gradient whose sign is noise, such as a key
  bias's, which RoPE alone keeps from zero: a step the other way. An
  element whose gradients agree is held to the 2 ulps;
* each leaf's update a step, as a vector, within 3/4 of the reference's
  (relative L2 norm): a missing or doubled update is 1 away from it, a
  reversed one 2;
* logits at the bf16 floor of ``tests/test_torch_lm.py`` (rtol 2e-2,
  atol 5e-2), against the reference and against the one-rank path.

Exact: every rank's replicated outputs against the others' (losses, grad
norms, the params gathered from the blocks, the logits of the ranks of a
data group), the launcher's resume, and the restored blocks.

The rank functions import no JAX: they are pickled to the children by
this module's name, so JAX runs only in the reference's subprocess.
"""
import io
import os
import subprocess
import sys
import textwrap
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.configs.dlrm import DLRM_SMOKE
from repro_torch.core import dlrm
from repro_torch.core import embedding_source as es
from repro_torch.data import make_placer
from repro_torch.distributed import collectives, sharding, spawn
from repro_torch.fleet import CLEAN, ChaosChannel, FaultPlan, Replica
from repro_torch.fleet.runner import _serve_batch
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.launch.mesh import Mesh
from repro_torch.models import api, transformer
from repro_torch.optim import adafactor, tree_map, tree_paths
from repro_torch.training import OnlineCacheConfig, OnlineTrainer
from repro_torch.training.online import make_drifting_zipf

torch.set_num_threads(1)

SRC = str(Path(__file__).resolve().parents[1] / "src")
SHAPE, AXES = (2, 2), ("data", "model")
B, S, MAX_LEN, DECODE = 4, 64, 80, 3
LR, WD, B1 = 3e-4, 0.01, 0.9   # the default optimizer's, layerwise(adamw)
STEP_MAX = 1.01                # |m_hat / sqrt(v_hat)| (docstring)
UPDATE_RTOL = 0.75             # a leaf's step against the reference's
LOSS_RTOL = 1e-4
GNORM_RTOL = (2e-3, 1e-2)      # the first step, the steps after it
LOGIT_RTOL, LOGIT_ATOL = 2e-2, 5e-2
REF_STEPS = {"qwen1.5-4b": 2, "smollm-360m": 1}
OWN = ("h2o-danube-1.8b", "internvl2-2b")
FULL = ("qwen1.5-4b", "smollm-360m", "h2o-danube-1.8b", "internvl2-2b")

# The reference's (2, 2) run: params from api.init(PRNGKey(0)), every
# input drawn from RandomState(7), each leaf saved under "<arch>/<what>"
# + its keystr path (bf16 as fp32, exactly).
REF_CODE = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.registry import SMOKE_ARCHS
    from repro.launch.mesh import make_mesh
    from repro.models import api
    B, S, MAX_LEN, DECODE = 4, 64, 80, 3
    out = {}
    mesh = make_mesh((2, 2), ('data', 'model'))

    def flat(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf)

    for arch, steps, serve in (("qwen1.5-4b", 2, True),
                               ("smollm-360m", 1, False)):
        cfg = SMOKE_ARCHS[arch]
        params, _ = api.init(jax.random.PRNGKey(0), cfg)
        flat(f"{arch}/p0", params)
        rng = np.random.RandomState(7)
        _, opt, step = api.make_train_step(cfg, mesh=mesh)
        st, p = opt.init(params), params
        with mesh:
            jstep = jax.jit(step)
            for s in range(steps):
                toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
                out[f"{arch}/tokens{s}"] = toks
                p, st, m = jstep(p, st, {"tokens": jnp.asarray(toks)})
                out[f"{arch}/loss{s}"] = np.asarray(m["loss"])
                out[f"{arch}/gnorm{s}"] = np.asarray(m["grad_norm"])
                flat(f"{arch}/p{s + 1}", p)
                flat(f"{arch}/m{s + 1}", st["m"])
            if serve:
                toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
                out[f"{arch}/prompt"] = toks
                logits, cache = jax.jit(api.make_prefill_step(
                    cfg, MAX_LEN, mesh))(params, {"tokens": jnp.asarray(toks)})
                out[f"{arch}/prefill"] = np.asarray(logits)
                dec = jax.jit(api.make_decode_fn(cfg, mesh))
                for i in range(DECODE):
                    t = rng.randint(0, cfg.vocab_size, (B,)).astype(np.int32)
                    out[f"{arch}/dtok{i}"] = t
                    logits, cache = dec(params, cache, {
                        "tokens": jnp.asarray(t), "pos": jnp.int32(S + i)})
                    out[f"{arch}/decode{i}"] = np.asarray(logits)
    np.savez(sys.argv[1], **{k: (v.astype(np.float32)
                                 if v.dtype.name == "bfloat16" else v)
                             for k, v in out.items()})
""")


def _cfg(arch):
    return registry.get_smoke(arch)


def _template(arch):
    return api.init(torch.Generator().manual_seed(0), _cfg(arch),
                    device="cpu")


def _load(z, prefix, template):
    """The reference's params saved under ``prefix`` as the port's tree,
    in the template's dtypes."""
    def build(t, path=""):
        if isinstance(t, dict):
            return {k: build(t[k], f"{path}[{k!r}]") for k in t}
        return torch.from_numpy(np.array(z[prefix + path])).to(t.dtype)
    return build(template)


def _own_batch(cfg, seed, b=B, s=S):
    """A numpy batch for the port's own comparisons (a vlm's patches
    fp32, cast to bf16 where it is placed)."""
    rng = np.random.RandomState(seed)
    out = {}
    if cfg.family == "vlm":
        p = cfg.n_frontend_tokens
        out["patches"] = rng.randn(b, p, cfg.d_model).astype(np.float32)
        s -= p
    out["tokens"] = rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return out


def _torch_batch(batch):
    out = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    if "patches" in out:
        out["patches"] = out["patches"].to(torch.bfloat16)
    return out


def _place(cfg, mesh, batch):
    out = make_placer("cpu", mesh, api.batch_specs(cfg, mesh))(batch)
    if "patches" in out:
        out["patches"] = out["patches"].to(torch.bfloat16)
    return out


def _prompt_len(batch) -> int:
    return batch["tokens"].shape[1] + (batch["patches"].shape[1]
                                       if "patches" in batch else 0)


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------

def _gathered(params, cfg, mesh, template):
    """The whole params, put together from the blocks on every rank."""
    return tree_map(lambda x, sp, t: sharding.gather_full(
        x, mesh, sharding.resolve(mesh, sp), t.shape), params,
        api.param_specs(cfg), template)


def _train(cfg, mesh, params, batches, template):
    blocks = api.shard_params(params, cfg, mesh)
    _, opt, step = api.make_train_step(cfg, mesh=mesh)
    state = opt.init(blocks)
    losses, gnorms, trail = [], [], []
    for b in batches:
        blocks, state, m = step(blocks, state, _place(cfg, mesh, b))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        # copies: a replicated leaf is gathered as itself, and the next
        # step updates it in place
        trail.append(tuple(tree_map(torch.clone, _gathered(
            t, cfg, mesh, template)) for t in (blocks, state["m"])))
    return {"losses": losses, "gnorms": gnorms, "params": trail[-1][0],
            "trail": trail}, (blocks, state)


def _serve(cfg, mesh, params, prompt, tokens):
    """Prefill and a decode step a token of ``tokens``: each rank's
    logits gathered over 'model' (its share of the batch)."""
    blocks = api.shard_params(params, cfg, mesh)
    logits, cache = api.make_prefill_step(cfg, MAX_LEN, mesh=mesh)(
        blocks, _place(cfg, mesh, prompt))
    out = [collectives.all_gather(logits, mesh, "model", dim=-1)]
    dec = api.make_decode_fn(cfg, mesh=mesh)
    s = _prompt_len(prompt)
    for i, t in enumerate(tokens):
        mine = _place(cfg, mesh, {"tokens": t})["tokens"]
        logits, cache = dec(blocks, cache, {"tokens": mine, "pos": s + i})
        out.append(collectives.all_gather(logits, mesh, "model", dim=-1))
    kv = cache["layers"]["k"]
    return {"logits": out, "kv_heads": kv.shape[3]}


def _own_tokens(cfg):
    rng = np.random.RandomState(3)
    return [rng.randint(0, cfg.vocab_size, (B,)).astype(np.int32)
            for _ in range(2)]


def _rank_lm(mesh, npz, tmp):
    z = np.load(npz)
    out = {}
    for arch, steps in REF_STEPS.items():
        cfg, tpl = _cfg(arch), _template(arch)
        p0 = _load(z, f"{arch}/p0", tpl)
        batches = [{"tokens": z[f"{arch}/tokens{s}"]} for s in range(steps)]
        out[arch], state = _train(cfg, mesh, p0, batches, tpl)
        if arch == "qwen1.5-4b":
            out[arch]["serve"] = _serve(
                cfg, mesh, p0, {"tokens": z[f"{arch}/prompt"]},
                [z[f"{arch}/dtok{i}"] for i in range(DECODE)])
        # the (2, 2) train state, saved unsharded
        name, opt, _ = api.make_train_step(cfg, mesh=mesh)
        p_sh, s_sh, _ = api.train_state_specs(cfg, name, opt, mesh)
        CheckpointManager(Path(tmp) / f"ckpt22_{arch}", device="cpu").save(
            steps, state, shardings=(p_sh, s_sh))
    for arch in OWN:
        cfg, tpl = _cfg(arch), _template(arch)
        out[arch], _ = _train(cfg, mesh, tpl, [_own_batch(cfg, 1)], tpl)
        out[arch]["serve"] = _serve(cfg, mesh, tpl, _own_batch(cfg, 2),
                                    _own_tokens(cfg))
    return out


def _rank_fleet(mesh):
    """The reference's sharded-publisher chaos run (``tests/
    test_fleet.py:202``) on the mesh's 'model' axis: every rank trains
    the same batches, publishes the gathered arena, and feeds a chaos
    replica and a clean one, each ``Replica(mesh=, shards=2)``."""
    cfg, shards, max_l, b = DLRM_SMOKE, 2, 4, 8
    full = dlrm.init(torch.Generator().manual_seed(0), cfg, shards,
                     device="cpu")
    trainer = OnlineTrainer(cfg, dlrm.shard_params(full, mesh), max_l=max_l,
                            mesh=mesh, device="cpu",
                            cache_cfg=OnlineCacheConfig(k=32,
                                                        refresh_every=2))
    gen = make_drifting_zipf(cfg, batch_size=b, mean_l=2, max_l=max_l,
                             drift_per_batch=64, alpha=1.05, seed=0)
    for _ in range(2):
        trainer.train_step(next(gen))
    vs0 = es.VersionedSource.deserialize(
        trainer.publish_source(include_head=True), device="cpu")
    kw = dict(max_l=max_l, batch_size=b, heads={"a": dict(vs0.head)},
              mesh=mesh, shards=shards, device="cpu")
    rep = Replica("replica0", cfg, vs0, ChaosChannel(FaultPlan(
        seed=22, drop=0.3, dup=0.3, delay=0.6, max_delay=3)),
        params_seed=2, **kw)
    ref = Replica("ref", cfg, vs0, ChaosChannel(CLEAN), params_seed=5, **kw)
    probe = next(gen)
    for _ in range(4):
        for _ in range(2):
            trainer.train_step(next(gen))
        blob = trainer.publish_source(include_head=True)
        ref.deliver(trainer.version, blob)
        rep.channel.send(blob, trainer.version)
        rep.pump()
    stale = (rep.stale_injected, rep.stale_rejections())
    for v, blob in rep.channel.flush():
        rep.deliver(v, blob)
    rep.deliver(trainer.version, trainer.publish_source(include_head=True))
    return {"stale": stale,
            "got": _serve_batch(rep.engines["a"], cfg, probe),
            "want": _serve_batch(ref.engines["a"], cfg, probe),
            "versions": (rep.versions()["a"], trainer.version),
            "recompiles": rep.recompiles()["a"]}


def _rank_suite(mesh, npz, tmp):
    return {"coords": tuple(mesh.rank(a) for a in AXES),
            "lm": _rank_lm(mesh, npz, tmp), "fleet": _rank_fleet(mesh)}


# ---------------------------------------------------------------------------
# the reference's run, the ranks', and the port's one-rank runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The path of the .npz of the reference's inputs and outputs."""
    tmp = tmp_path_factory.mktemp("lmref")
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
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("lmranks")


@pytest.fixture(scope="module")
def ranks(ref, work):
    return spawn(_rank_suite, 4, backend="gloo",
                 init_file=str(work / "rendezvous"), args=(ref, str(work)),
                 timeout_s=120, join_timeout_s=240, mesh_shape=SHAPE,
                 mesh_axes=AXES)


def _one_rank(arch):
    """The port's one-rank train step, prefill and decode, for the OWN
    configs (the same inputs as the ranks')."""
    cfg, params = _cfg(arch), _template(arch)
    _, opt, step = api.make_train_step(cfg)
    state = opt.init(params)
    p = tree_map(torch.clone, params)
    p, state, m = step(p, state, _torch_batch(_own_batch(cfg, 1)))
    prompt = _torch_batch(_own_batch(cfg, 2))
    logits, cache = api.make_prefill_step(cfg, MAX_LEN)(params, prompt)
    out = [logits]
    dec = api.make_decode_fn(cfg)
    for i, t in enumerate(_own_tokens(cfg)):
        logits, cache = dec(params, cache, {"tokens": torch.from_numpy(t),
                                            "pos": _prompt_len(prompt) + i})
        out.append(logits)
    return {"loss": float(m["loss"]), "gnorm": float(m["grad_norm"]),
            "params": p, "m": state["m"], "logits": [x.numpy() for x in out]}


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _leaves(tree):
    """{keystr path: float64 array} of a tree of tensors or arrays."""
    return {p: np.asarray(_np(x) if torch.is_tensor(x) else x, np.float64)
            for p, x in tree_paths(tree)}


def _params_close(got, want, init, what):
    """The mesh path's params against ``want``'s after each step (module
    docstring): ``got`` and ``want`` list (params, AdamW's first
    moments), each a {keystr path: array}, a step; ``init`` the params
    before the first step."""
    for path, p0 in init.items():
        gp, wp = ([p[path] for p, _ in t] for t in (got, want))
        scale = float(np.abs(wp[-1]).max())
        ulp = 2.0 ** (np.floor(np.log2(scale)) - 7) if scale > 0 else 0.0
        tol = np.full(p0.shape, 2 * ulp)
        noise = np.zeros(p0.shape)
        gm = wm = 0.0
        for (_, a), (_, b) in zip(got, want):
            # the step's gradient, from m_s = b1 m_(s-1) + (1 - b1) g_s
            ga, gb = ((m[path] - B1 * prev) / (1 - B1)
                      for m, prev in ((a, gm), (b, wm)))
            gm, wm = a[path], b[path]
            with np.errstate(divide="ignore", invalid="ignore"):
                r = np.where(ga == gb, 0.0, np.abs(ga - gb) / np.abs(gb))
            noise = np.maximum(noise, np.minimum(r, 1.0))
            tol += 2 * LR * STEP_MAX * noise
        err = np.abs(gp[-1] - wp[-1])
        worst = int(np.argmax(err - tol))
        assert err.flat[worst] <= tol.flat[worst], (
            what, path, err.flat[worst], tol.flat[worst])
        for s in range(len(want)):
            dg = gp[s] - (gp[s - 1] if s else p0)
            dw = wp[s] - (wp[s - 1] if s else p0)
            assert np.linalg.norm(dg - dw) <= UPDATE_RTOL * np.linalg.norm(
                dw), (what, path, s)


def _logits(ranks, arch, i):
    """The whole batch's logits of serve output i: the data groups'
    shares, each from its 'model' rank 0."""
    return np.concatenate([r["lm"][arch]["serve"]["logits"][i]
                           for r in ranks if r["coords"][1] == 0])


# ---------------------------------------------------------------------------
# the head split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", (1, 2, 4, 16))
@pytest.mark.parametrize("arch", FULL)
def test_head_split_covers_every_head(arch, tp):
    a = registry.get_arch(arch).attention
    h, kh = a.n_heads, a.n_kv_heads
    split = sharding.head_split(h, kh, tp)
    assert len(split) == tp
    g = h // kh
    q_seen, kv_seen = [], set()
    for q0, q1, k0, k1 in split:
        assert 0 <= q0 <= q1 <= h and 0 <= k0 < k1 <= kh
        q_seen += range(q0, q1)
        kv_seen |= set(range(k0, k1))
        # every query head of the rank reads a kv head of the rank
        assert all(k0 <= q // g < k1 for q in range(q0, q1))
        if kh >= tp:
            assert (q1 - q0) == (k1 - k0) * g
        else:
            assert k1 - k0 == 1
    assert q_seen == list(range(h))          # each once, in order
    assert kv_seen == set(range(kh))
    sizes = [k1 - k0 for _, _, k0, k1 in split]
    if kh >= tp:
        assert max(sizes) - min(sizes) <= 1
    assert sharding.kv_replicated(kh, tp) == (kh < tp)


@pytest.mark.parametrize("h,kh,tp,want", (
    (15, 5, 2, ((0, 9, 0, 3), (9, 15, 3, 5))),           # smollm-360m
    (3, 1, 2, ((0, 2, 0, 1), (2, 3, 0, 1))),             # its smoke config
    (32, 8, 2, ((0, 16, 0, 4), (16, 32, 4, 8))),         # h2o-danube
    (16, 8, 2, ((0, 8, 0, 4), (8, 16, 4, 8))),           # internvl2
    (20, 20, 2, ((0, 10, 0, 10), (10, 20, 10, 20))),     # qwen1.5-4b
))
def test_head_split_at_two_ranks(h, kh, tp, want):
    assert sharding.head_split(h, kh, tp) == want


def test_head_split_can_leave_a_rank_without_heads():
    split = sharding.head_split(15, 5, 16)          # smollm at TP 16
    assert [q1 - q0 for q0, q1, _, _ in split].count(0) == 1
    assert split[3] == (3, 3, 0, 1)
    with pytest.raises(ValueError, match="query heads"):
        sharding.head_split(15, 4, 2)


@pytest.mark.parametrize("arch", FULL)
def test_specs_resolve_to_blocks_of_whole_heads(arch):
    cfg = registry.get_arch(arch)
    a = cfg.attention
    hd = a.resolved_head_dim(cfg.d_model)
    specs = api.param_specs(cfg)["layers"]["attn"]
    mesh = Mesh((("data", None, 0, 2), ("model", None, 0, 2)))
    q = sharding.resolve(mesh, specs["wq"])[2]
    assert q == sharding.Blocks("model", tuple(
        (q1 - q0) * hd for q0, q1, _, _ in sharding.head_split(
            a.n_heads, a.n_kv_heads, 2)))
    assert sharding.resolve(mesh, specs["wo"])[1] == q
    assert sharding.resolve(mesh, api.param_specs(cfg)["embed"]) \
        == ("model", None)


@pytest.mark.parametrize("arch,heads", (("qwen1.5-4b", (2, 2)),
                                        ("smollm-360m", None)))
def test_cache_specs_split_the_kv_heads(arch, heads):
    """The decode cache is split by kv head, as the decode's attention is
    (replicated where the kv heads are: smollm's one under 2 ranks), and
    on the batch over 'data'; ``init_cache(..., mesh=)`` gives this
    rank's block of it."""
    cfg = _cfg(arch)
    mesh = Mesh((("data", None, 1, 2), ("model", None, 1, 2)))
    sh = api.cache_specs(cfg, B, 16, mesh)["layers"]
    kv = None if heads is None else sharding.Blocks("model", heads)
    assert sh["k"].spec == sh["v"].spec == (None, "data", None, kv, None)
    assert sh["slot_pos"].spec == (None, None)
    mine = api.init_cache(cfg, B // 2, 16, device="cpu", mesh=mesh)
    whole = api.init_cache(cfg, B, 16, device="cpu")
    for k in ("k", "v", "slot_pos"):
        assert sharding.local_block(whole["layers"][k], mesh,
                                    sh[k].spec).shape \
            == mine["layers"][k].shape


# ---------------------------------------------------------------------------
# against the reference's (2, 2) steps
# ---------------------------------------------------------------------------

def test_ranks_sit_on_the_mesh(ranks):
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("arch", tuple(REF_STEPS) + OWN)
def test_every_rank_gets_the_same_bits(ranks, arch):
    first = ranks[0]["lm"][arch]
    for r in ranks[1:]:
        got = r["lm"][arch]
        assert got["losses"] == first["losses"]
        assert got["gnorms"] == first["gnorms"]
        for (path, a), (_, b) in zip(tree_paths(got["params"]),
                                     tree_paths(first["params"])):
            assert np.array_equal(a, b), (arch, path)
    for d in (0, 1):
        mine = [r["lm"][arch].get("serve") for r in ranks
                if r["coords"][0] == d]
        if mine[0] is not None:
            for a, b in zip(mine[0]["logits"], mine[1]["logits"]):
                assert np.array_equal(a, b)


@pytest.mark.parametrize("arch", tuple(REF_STEPS))
def test_train_steps_match_the_reference(ranks, z, arch):
    got, steps = ranks[0]["lm"][arch], REF_STEPS[arch]
    np.testing.assert_allclose(
        got["losses"], [float(z[f"{arch}/loss{s}"]) for s in range(steps)],
        rtol=LOSS_RTOL)
    for s in range(steps):
        np.testing.assert_allclose(got["gnorms"][s],
                                   float(z[f"{arch}/gnorm{s}"]),
                                   rtol=GNORM_RTOL[min(s, 1)])
    paths = [p for p, _ in tree_paths(_template(arch))]
    want = [tuple({p: np.asarray(z[f"{arch}/{k}{s + 1}{p}"], np.float64)
                   for p in paths} for k in "pm") for s in range(steps)]
    _params_close([tuple(map(_leaves, t)) for t in got["trail"]], want,
                  {p: np.asarray(z[f"{arch}/p0{p}"], np.float64)
                   for p in paths}, arch)


@pytest.mark.parametrize("i", range(1 + DECODE))
def test_prefill_and_decode_match_the_reference(ranks, z, i):
    want = z["qwen1.5-4b/prefill"] if i == 0 \
        else z[f"qwen1.5-4b/decode{i - 1}"]
    np.testing.assert_allclose(_logits(ranks, "qwen1.5-4b", i), want,
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


def test_decode_cache_holds_the_ranks_kv_heads(ranks):
    # qwen SMOKE's 4 kv heads split 2 / 2; smollm's one would be
    # replicated, h2o's 2 split 1 / 1
    assert ranks[0]["lm"]["qwen1.5-4b"]["serve"]["kv_heads"] == 2
    assert ranks[0]["lm"]["h2o-danube-1.8b"]["serve"]["kv_heads"] == 1


# ---------------------------------------------------------------------------
# against the port's one-rank path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank():
    return {arch: _one_rank(arch) for arch in OWN}


@pytest.mark.parametrize("arch", OWN)
def test_train_step_matches_the_one_rank_path(ranks, one_rank, arch):
    got, want = ranks[0]["lm"][arch], one_rank[arch]
    np.testing.assert_allclose(got["losses"][0], want["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["gnorms"][0], want["gnorm"],
                               rtol=GNORM_RTOL[0])
    _params_close([tuple(map(_leaves, t)) for t in got["trail"]],
                  [(_leaves(want["params"]), _leaves(want["m"]))],
                  _leaves(_template(arch)), arch)


@pytest.mark.parametrize("i", range(3))
@pytest.mark.parametrize("arch", OWN)
def test_serving_matches_the_one_rank_path(ranks, one_rank, arch, i):
    np.testing.assert_allclose(_logits(ranks, arch, i),
                               one_rank[arch]["logits"][i],
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


# ---------------------------------------------------------------------------
# elastic restore
# ---------------------------------------------------------------------------

def _fake(shape, coords):
    return Mesh(tuple((a, None, c, n)
                      for a, c, n in zip(AXES, coords, shape)))


@pytest.mark.parametrize("coords", [(d, m) for d in range(2)
                                    for m in range(4)])
def test_elastic_restore_across_meshes(tmp_path, coords):
    """The reference's case (``tests/test_distributed.py:167``): an (8, 8)
    leaf split over 'model' on (4, 2) is saved whole, and each rank of
    (2, 4) restores its block."""
    full = torch.arange(64.0).reshape(8, 8)
    mgr = CheckpointManager(tmp_path, device="cpu")
    mgr.save(3, {"w": full})
    mesh_b = _fake((2, 4), coords)
    sh = sharding.sharding_for(mesh_b, (None, "model"))
    block = sharding.local_block(full, mesh_b, sh.spec)
    assert block.shape == (8, 2)
    restored, _ = mgr.restore({"w": torch.zeros(8, 2)},
                              shardings={"w": sh})
    assert torch.equal(restored["w"], full[:, 2 * coords[1]:
                                           2 * coords[1] + 2])


@pytest.mark.parametrize("m", range(4))
@pytest.mark.parametrize("arch", tuple(REF_STEPS))
def test_train_state_restores_onto_another_mesh(ranks, work, arch, m):
    """The ranks' (2, 2) train state after their steps, saved whole once
    (its params equal the ones the ranks gathered), restored onto (1, 4)
    at each rank's coordinates: the blocks of the saved leaves, bit for
    bit (smollm's 3 query heads split 1/1/1/0 there: a rank without
    one)."""
    cfg, steps = _cfg(arch), REF_STEPS[arch]
    mgr = CheckpointManager(work / f"ckpt22_{arch}", device="cpu")
    assert mgr.steps() == [steps]
    mesh = _fake((1, 4), (0, m))
    name, opt, _ = api.make_train_step(cfg, mesh=mesh)
    p_sh, s_sh, _ = api.train_state_specs(cfg, name, opt, mesh)
    blocks = api.shard_params(_template(arch), cfg, mesh)
    template = (blocks, opt.init(blocks))
    (params, state), manifest = mgr.restore(template,
                                            shardings=(p_sh, s_sh))
    assert state["step"] == steps
    saved = np.load(work / f"ckpt22_{arch}" / f"step_{steps}" /
                    "arrays.npz")
    got = dict(tree_paths((params, state)))
    shardings = dict(_sharding_paths((p_sh, s_sh)))
    for i, path in enumerate(manifest["paths"]):
        if path == "[1]['step']":
            continue
        want = sharding.local_block(torch.from_numpy(saved[f"arr_{i}"]),
                                    mesh, shardings[path].spec)
        assert torch.equal(got[path].float(), want), path
    whole = ranks[0]["lm"][arch]["params"]
    for i, path in enumerate(manifest["paths"]):
        if path.startswith("[0]"):
            assert np.array_equal(saved[f"arr_{i}"],
                                  dict(tree_paths(whole))[path[3:]]), path


def _sharding_paths(tree, path=""):
    """(keystr path, Sharding or None) of a shardings tree, in
    ``tree_paths``' naming (a ``Sharding`` is a leaf here)."""
    if tree is None or isinstance(tree, sharding.Sharding):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _sharding_paths(tree[k], f"{path}[{k!r}]")]
    return [pl for i, x in enumerate(tree)
            for pl in _sharding_paths(x, f"{path}[{i}]")]


# ---------------------------------------------------------------------------
# the fleet's replicas of a sharded publisher
# ---------------------------------------------------------------------------

def test_replicas_of_a_sharded_publisher_serve_exactly(ranks):
    for r in ranks:
        f = r["fleet"]
        assert f["stale"][0] == f["stale"][1]
        assert f["got"] == f["want"]
        assert f["versions"][0] == f["versions"][1]
        assert f["recompiles"] == 0
    assert all(r["fleet"]["got"] == ranks[0]["fleet"]["got"]
               for r in ranks[1:])


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

LAUNCH = ["--arch", "qwen1.5-4b", "--smoke", "--device", "cpu",
          "--batch-size", "2", "--seq-len", "32", "--log-every", "100"]


def _sharded(tmp, name, *extra):
    return LAUNCH + ["--shards", "2", "--backend", "gloo", "--rendezvous",
                     str(tmp / f"rv_{name}"), "--timeout", "120", *extra]


def test_lm_launcher_trains_and_resumes_on_shards(tmp_path):
    """``--shards 2`` trains a SMOKE LM tensor- and sequence-parallel:
    its loss within LOSS_RTOL of the one-rank launcher's, and a run
    stopped after 2 steps and resumed to 4 writes the uninterrupted run's
    step-3 checkpoint bit for bit."""
    with redirect_stdout(io.StringIO()):
        one = t_train.main(LAUNCH + ["--steps", "4"])
        whole = t_train.main(_sharded(
            tmp_path, "a", "--steps", "4", "--ckpt-dir",
            str(tmp_path / "a"), "--ckpt-every", "2"))
        t_train.main(_sharded(tmp_path, "b", "--steps", "2", "--ckpt-dir",
                              str(tmp_path / "b"), "--ckpt-every", "2"))
        resumed = t_train.main(_sharded(
            tmp_path, "c", "--steps", "4", "--ckpt-dir",
            str(tmp_path / "b"), "--ckpt-every", "2", "--resume"))
    np.testing.assert_allclose(whole, one, rtol=LOSS_RTOL)
    assert resumed == whole
    a = np.load(tmp_path / "a" / "step_3" / "arrays.npz")
    b = np.load(tmp_path / "b" / "step_3" / "arrays.npz")
    assert a.files == b.files
    for k in a.files:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("arch,ok", (("qwen1.5-4b", True),
                                     ("internvl2-2b", True),
                                     ("minicpm3-4b", True),
                                     ("rwkv6-7b", False)))
def test_lm_launcher_takes_shards_for_ported_families(arch, ok):
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--shards", "2",
            "--backend", "gloo"]
    if ok:
        assert t_train.parse_args(argv).shards == 2
        return
    err = io.StringIO()
    with pytest.raises(SystemExit), redirect_stderr(err):
        t_train.parse_args(argv)
    assert "item 13e" in err.getvalue()


def test_serve_launcher_serves_an_lm_unsharded_under_a_mesh():
    """As the reference's ``serve_lm``: ``--mesh pod`` is not built for an
    LM (no 256 ranks needed), which is served as without it."""
    argv = ["--arch", "smollm-360m", "--smoke", "--device", "cpu",
            "--requests", "2", "--batch-size", "2", "--prompt-len", "4",
            "--new-tokens", "2"]
    with redirect_stdout(io.StringIO()):
        plain = t_serve.main(argv)
        meshed = t_serve.main(argv + ["--mesh", "pod"])
    assert meshed["n"] == plain["n"] == 2


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

MESH2 = Mesh((("data", None, 0, 1), ("model", None, 0, 2)))


@pytest.mark.parametrize("arch", ("kimi-k2-1t-a32b", "arctic-480b",
                                  "minicpm3-4b", "recurrentgemma-9b",
                                  "rwkv6-7b", "seamless-m4t-large-v2"))
def test_unported_families_refuse_a_mesh(arch):
    """The hybrid, ssm and encoder-decoder families refuse a mesh, naming
    ROADMAP item 13e; the MoE and MLA decoders (item 13d) take one
    (``tests/test_torch_lm_mesh_moe.py``, ``test_torch_lm_mesh_mla.py``
    run them)."""
    cfg = _cfg(arch)
    makes = (lambda: api.make_train_step(cfg, mesh=MESH2),
             lambda: api.make_prefill_step(cfg, 16, mesh=MESH2),
             lambda: api.make_decode_fn(cfg, mesh=MESH2),
             lambda: api.init_cache(cfg, 1, 8, device="cpu", mesh=MESH2))
    if cfg.moe is not None or cfg.attention.kind == "mla":
        for make in makes:
            make()
        with sharding.use_mesh(MESH2):
            transformer.init_cache(cfg, 1, 8, device="cpu")
        assert api.mesh_ported(cfg)
        return
    for make in makes:
        with pytest.raises(NotImplementedError, match="item 13e"):
            make()
    if not cfg.is_encdec:
        # the model code itself, under the active mesh
        with sharding.use_mesh(MESH2), \
                pytest.raises(NotImplementedError, match="item 13e"):
            transformer.init_cache(cfg, 1, 8, device="cpu")
    assert not api.mesh_ported(cfg)


def test_adafactor_refuses_a_mesh():
    """Adafactor takes a mesh (its statistics across shards: ``tests/
    test_torch_lm_mesh_mla.py``), and its state has specs there; an
    optimizer the mesh steps do not take is refused, not run on one
    rank."""
    cfg = _cfg("qwen1.5-4b")
    name, opt, _ = api.make_train_step(
        cfg, optimizer=("adafactor", adafactor(1e-3)), mesh=MESH2)
    _, state_sh, _ = api.train_state_specs(cfg, name, opt, MESH2)
    assert state_sh["fac"]["layers"]["attn"]["wq"]["vr"].spec == (None, None)
    other = ("rowwise_adagrad", adafactor(1e-3))
    with pytest.raises(ValueError, match="mesh steps take"):
        api.make_train_step(cfg, optimizer=other, mesh=MESH2)
    # one rank is no mesh
    api.make_train_step(cfg, optimizer=other,
                        mesh=Mesh((("model", None, 0, 1),)))
