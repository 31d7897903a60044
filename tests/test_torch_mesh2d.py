"""The port on a two-dimensional (data, model) mesh: 4 gloo CPU ranks on a
(2, 2) mesh (``distributed.spawn(..., mesh_shape=(2, 2),
mesh_axes=("data", "model"))``), started once, against the JAX
reference's own (2, 2) run (``make_mesh((2, 2), ('data', 'model'))`` on 4
fake host devices, one subprocess), on the inputs that run saved.

The cases are those of ``tests/test_distributed.py`` at (2, 2): the
row-sharded fixed and ragged lookups, the fixed and ragged DLRM forwards,
the vocab-sharded token gather, the expert-parallel MoE; and DLRM_SMOKE
after 2 dense-gradient steps (the fixed path, its bags split over the
data axis, the block's gradient summed over it) and 2 sparse sharded
steps (the ragged batch replicated over both axes). Also: ``resolve``
against the reference's on (2, 2) and (1, 2, 2) meshes, ``make_placer``'s
blocks, the gradients through the mesh's collectives against the
one-rank paths', the serving engine's plans on the mesh, ``make_mesh``'s
layout
and ``make_production_mesh``'s refusal, and the reference's tiered
trainer failing at its first ``retier()`` on an arena padded for two
shards (the reason the port's tiered trainer does not shard).

Tolerances, the reference's (``tests/test_distributed.py``): lookups and
the token gather 1e-5, the forwards and the MoE 1e-4, the MoE's aux ratio
within (0.5, 2); the steps 1e-4 (``tests/test_sharded_sparse.py``), the
served probabilities 1e-5 from the one-rank engine; the gradients 1e-4
from the one-rank paths' (fp32 sums in another order). Exact: every rank's
outputs against the others' (all-reduces, broadcasts and the all-to-all
hand each the same bits).

The rank functions import no JAX: they are pickled to the children by
this module's name, so JAX runs only in the reference's subprocess and in
the parent's in-process pin.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.configs.dlrm import DLRM_SMOKE as CFG
from repro_torch.core import dlrm
from repro_torch.core import embedding_source as es
from repro_torch.core import sparse_engine as se
from repro_torch.data import make_placer
from repro_torch.distributed import collectives, sharding, spawn
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.launch.mesh import Mesh, make_mesh, make_production_mesh
from repro_torch.models import embedding as emb
from repro_torch.models import moe
from repro_torch.optim import tree_leaves
from repro_torch.serving import RecEngine, requests_from_ragged_batch

torch.set_num_threads(1)

SRC = str(Path(__file__).resolve().parents[1] / "src")
SHAPE, AXES = (2, 2), ("data", "model")
MAX_L = 6
STEPS = 2
LOOKUP_TOL = 1e-5
FORWARD_TOL = 1e-4
STEP_TOL = 1e-4
PROB_TOL = 1e-5
# gradients of a sum of squares of outputs of order 10: fp32 sums in
# another association, a few ulps of values of order 100
GRAD_TOL = 1e-4
MCFG = MoEConfig(n_experts=8, top_k=2, expert_ff=32, capacity_factor=4.0)
LOGICAL = (("batch", None), ("fsdp", "model"), ("expert", "fsdp", None),
           (None,), ("vocab", "heads", "ff"), ("batch", None, "model"), ())
TRAIN_KEYS = ("dense", "indices", "offsets", "labels")

# The reference's (2, 2) run: it makes every input, saves them and its
# outputs to the .npz named by argv[1], and prints resolve()'s specs.
REF_CODE = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import MoEConfig
    from repro.configs.dlrm import DLRM_SMOKE as cfg
    from repro.core import dlrm, embedding_source as es
    from repro.core import sparse_engine as se
    from repro.data import DLRMSynthetic
    from repro.distributed.sharding import resolve, use_mesh
    from repro.launch.mesh import make_mesh
    from repro.models import embedding as emb, moe
    from repro.models.params import Builder, split
    MAX_L, STEPS = 6, 2
    out = {}
    mesh = make_mesh((2, 2), ('data', 'model'))
    # test_distributed.py:78 and :118 at (2, 2)
    spec = se.ArenaSpec(3, 64, 8)
    arena = se.init_arena(jax.random.PRNGKey(0), spec, shards=2)
    rng = np.random.RandomState(0)
    idx = rng.randint(0, 64, (8, 3, 5)).astype(np.int32)
    lens = rng.randint(0, 6, 24).astype(np.int32)
    off = np.zeros(25, np.int32); off[1:] = np.cumsum(lens)
    ridx = rng.randint(0, 64, int(off[-1]) + 4).astype(np.int32)
    sh = lambda a: es.ShardedArena(es.FpArena(a), mesh)
    out.update(lk_arena=arena, lk_idx=idx, lk_off=off, lk_ridx=ridx)
    out["lk_fixed"] = jax.jit(lambda a, i: es.lookup_fixed(
        sh(a), spec, i))(arena, idx)
    out["lk_ragged"] = jax.jit(lambda a, i, o: es.lookup_bags(
        sh(a), spec, i, o, max_l=5))(arena, ridx, off)
    # test_distributed.py:95 at (2, 2)
    params = dlrm.init(jax.random.PRNGKey(0), cfg, shards=2)
    for k, v in enumerate(jax.tree_util.tree_leaves(params)):
        out[f"p{k}"] = v
    rb = DLRMSynthetic(cfg, seed=5).ragged_batch(8, dist='fixed')
    fx = DLRMSynthetic.ragged_to_fixed(rb, cfg.n_tables)
    out.update(fw_dense=rb['dense'], fw_fixed_ids=fx,
               fw_indices=rb['indices'], fw_offsets=rb['offsets'],
               fw_max_l=np.int32(rb['max_l']))
    out["fw_fixed"] = dlrm.forward(params, cfg, jnp.asarray(rb['dense']),
                                   jnp.asarray(fx), mesh)
    out["fw_ragged"] = jax.jit(lambda p, d, i, o: dlrm.forward_ragged(
        p, cfg, d, i, o, max_l=int(rb['max_l']), mesh=mesh))(
        params, rb['dense'], rb['indices'], rb['offsets'])
    # 2 dense-gradient steps on fixed batches
    opt, step = dlrm.make_train_step(cfg, mesh=mesh)
    p, st = params, opt.init(params)
    data = DLRMSynthetic(cfg, seed=19)
    for s in range(STEPS):
        b = data.batch(8)
        for k in ("dense", "indices", "labels"):
            out[f"dn_{s}_{k}"] = b[k]
        p, st, loss = jax.jit(step)(p, st, {k: jnp.asarray(v)
                                            for k, v in b.items()})
        out[f"dn_loss_{s}"] = loss
    out["dn_arena"] = p["arena"]
    for k, v in enumerate(jax.tree_util.tree_leaves(
            {"bottom": p["bottom"], "top": p["top"]})):
        out[f"dn_mlp{k}"] = v
    # 2 sparse sharded steps on ragged batches
    opt, step = dlrm.make_train_step_ragged(cfg, max_l=MAX_L, mesh=mesh)
    p, st = params, opt.init(params)
    data = DLRMSynthetic(cfg, seed=3)
    for s in range(STEPS):
        b = data.ragged_batch(8, mean_l=3, max_l=MAX_L,
                              pad_to=8 * cfg.n_tables * MAX_L)
        for k in ("dense", "indices", "offsets", "labels"):
            out[f"sp_{s}_{k}"] = b[k]
        p, st, loss, rows = jax.jit(step)(
            p, st, {k: jnp.asarray(b[k]) for k in
                    ("dense", "indices", "offsets", "labels")})
        out[f"sp_loss_{s}"] = loss
        out[f"sp_rows_{s}"] = rows
    out["sp_arena"] = p["arena"]
    out["sp_acc"] = st["arena"]["acc"]
    for k, v in enumerate(jax.tree_util.tree_leaves(
            {"bottom": p["bottom"], "top": p["top"]})):
        out[f"sp_mlp{k}"] = v
    # test_distributed.py:31, and a batch that does not divide 'data'
    table = rng.randn(128, 16).astype(np.float32)
    tokens = rng.randint(0, 100, (4, 8)).astype(np.int32)
    out.update(em_table=table, em_tokens=tokens)
    with use_mesh(mesh):
        out["em_out"] = jax.jit(emb.embed_tokens)(table, tokens)
        out["em_out3"] = jax.jit(emb.embed_tokens)(table, tokens[:3])
    # test_distributed.py:49
    mcfg = MoEConfig(n_experts=8, top_k=2, expert_ff=32,
                     capacity_factor=4.0)
    mp, _ = split(moe.init_moe(Builder(jax.random.PRNGKey(0),
                                       dtype=jnp.float32), mcfg, 16))
    x = rng.randn(2, 16, 16).astype(np.float32)
    out.update(x=x, **{f"moe_{k}": v for k, v in mp.items()})
    out["moe_y_local"], out["moe_aux_local"] = moe.apply_moe(mp, mcfg, x)
    with use_mesh(mesh):
        out["moe_y_ep"], out["moe_aux_ep"] = jax.jit(
            lambda p, x: moe.apply_moe(p, mcfg, x))(mp, x)
    np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
    logical = json.loads(sys.argv[2])
    mesh3 = make_mesh((1, 2, 2), ('pod', 'data', 'model'))
    specs = {name: [[list(e) if isinstance(e, tuple) else e
                     for e in resolve(m, tuple(lg))] for lg in logical]
             for name, m in (("2d", mesh), ("3d", mesh3))}
    print(json.dumps(specs))
""")


def _params(z, prefix="p"):
    """The reference's DLRM params (leaves saved in jax's order) as the
    port's nested dict."""
    leaves = [z[f"{prefix}{k}"] for k in range(
        sum(1 for key in z.files if key.startswith(prefix)
            and key[len(prefix):].isdigit()))]
    n_bot = len(CFG.bottom_mlp)
    tree = {"arena": leaves[0],
            "bottom": [(leaves[1 + 2 * i], leaves[2 + 2 * i])
                       for i in range(n_bot)]}
    rest = leaves[1 + 2 * n_bot:]
    tree["top"] = [(rest[2 * i], rest[2 * i + 1])
                   for i in range(len(rest) // 2)]
    return dlrm.params_from_numpy(tree, "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _mlp(params):
    return [t.clone() for k in ("bottom", "top")
            for t in tree_leaves(params[k])]


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------

def _rank_lookups(mesh, z):
    spec = se.ArenaSpec(3, 64, 8)
    block = se.shard_block(_t(z["lk_arena"]), mesh.rank("model"), 2)
    src = es.ShardedArena(es.FpArena(block), mesh)
    return {"fixed": es.lookup_fixed(src, spec, _t(z["lk_idx"])),
            "ragged": es.lookup_bags(src, spec, _t(z["lk_ridx"]),
                                     _t(z["lk_off"]), max_l=5)}


def _rank_forwards(mesh, z):
    params = dlrm.shard_params(_params(z), mesh)
    dense = _t(z["fw_dense"])
    with torch.no_grad():
        return {"fixed": dlrm.forward(params, CFG, dense,
                                      _t(z["fw_fixed_ids"]), mesh),
                "ragged": dlrm.forward_ragged(
                    params, CFG, dense, _t(z["fw_indices"]),
                    _t(z["fw_offsets"]), max_l=int(z["fw_max_l"]),
                    mesh=mesh)}


def _rank_dense_steps(mesh, z):
    params = dlrm.shard_params(_params(z), mesh)
    opt, step = dlrm.make_train_step(CFG, mesh=mesh)
    state = opt.init(params)
    losses = []
    for s in range(STEPS):
        batch = {k: _t(z[f"dn_{s}_{k}"])
                 for k in ("dense", "indices", "labels")}
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    return {"losses": losses,
            "arena": collectives.gather_blocks(params["arena"], mesh),
            "acc": collectives.gather_blocks(state["arena"]["acc"], mesh),
            "mlp": _mlp(params)}


def _rank_sparse_steps(mesh, z):
    params = dlrm.shard_params(_params(z), mesh)
    opt, step = dlrm.make_train_step_ragged(CFG, max_l=MAX_L, mesh=mesh)
    state = opt.init(params)
    losses, rows = [], []
    for s in range(STEPS):
        batch = {k: _t(z[f"sp_{s}_{k}"]) for k in TRAIN_KEYS}
        params, state, loss, r = step(params, state, batch)
        losses.append(float(loss))
        rows.append(r.clone())
    return {"losses": losses, "rows": rows,
            "arena": collectives.gather_blocks(params["arena"], mesh),
            "acc": collectives.gather_blocks(state["arena"]["acc"], mesh),
            "mlp": _mlp(params)}


def _rank_tokens(mesh, z):
    table = _t(z["em_table"])
    block = sharding.local_block(table, mesh, ("model", None))
    tokens = _t(z["em_tokens"])
    return {"out": emb.embed_tokens(block, tokens, mesh),
            "out3": emb.embed_tokens(block, tokens[:3], mesh)}


def _rank_moe(mesh, z):
    p = {k: _t(z[f"moe_{k}"]) for k in ("wr", "wg", "wu", "wd")}
    blocks = moe.shard_moe_params(p, MCFG, mesh)
    y, aux = moe.apply_moe(blocks, MCFG, _t(z["x"]), mesh)
    # a sequence that does not divide 'model': the local path, over the
    # whole weights gathered from the blocks
    y_odd, _ = moe.apply_moe(blocks, MCFG, _t(z["x"])[:, :15], mesh)
    return {"y": y, "aux": float(aux), "y_odd": y_odd,
            "shapes": [tuple(blocks[k].shape) for k in ("wg", "wu", "wd")]}


def _rank_grads(mesh, z):
    """Gradients through the mesh's collectives (all-to-all, all-gather,
    the data-axis sums) against the one-rank paths' on the same loss: the
    MoE's output (its aux is another estimator on the mesh, so left out)
    w.r.t. x and the weight blocks, and the token gather w.r.t. the
    table's block."""
    p = {k: _t(z[f"moe_{k}"]) for k in ("wr", "wg", "wu", "wd")}
    x = _t(z["x"])
    local = {k: v.clone().requires_grad_() for k, v in p.items()}
    xl = x.clone().requires_grad_()
    moe.apply_moe(local, MCFG, xl)[0].square().sum().backward()
    blocks = {k: v.clone().requires_grad_()
              for k, v in moe.shard_moe_params(p, MCFG, mesh).items()}
    xm = x.clone().requires_grad_()
    moe.apply_moe(blocks, MCFG, xm, mesh)[0].square().sum().backward()
    want = moe.shard_moe_params({k: v.grad for k, v in local.items()},
                                MCFG, mesh)
    out = {"moe_x": float((xm.grad - xl.grad).abs().max())}
    out.update({f"moe_{k}": float((blocks[k].grad - want[k]).abs().max())
                for k in want})
    table = _t(z["em_table"])
    tokens = _t(z["em_tokens"])
    whole = table.clone().requires_grad_()
    whole[tokens.long()].square().sum().backward()
    block = sharding.local_block(table, mesh, ("model", None)) \
        .requires_grad_()
    emb.embed_tokens(block, tokens, mesh).square().sum().backward()
    out["tokens"] = float((block.grad - sharding.local_block(
        whole.grad, mesh, ("model", None))).abs().max())
    return out


def _rank_serve(mesh, z):
    """The serving engine's plans on the mesh, and the one-rank ragged
    and fixed plans beside them."""
    spec = dlrm.arena_spec(CFG)
    full = _params(z)
    params = dlrm.shard_params(full, mesh)
    from repro_torch.data import DLRMSynthetic
    rb = DLRMSynthetic(CFG, seed=13).ragged_batch(7, dist="fixed")
    counts = se.trace_row_counts(spec, rb["indices"], rb["offsets"])
    out = {}
    for name, p, kw in (
            ("one_rank", full, dict(source="ragged")),
            ("one_rank_fixed", full, dict(source="fixed")),
            ("ragged", params, dict(source="ragged", mesh=mesh)),
            ("fixed", params, dict(source="fixed", mesh=mesh)),
            ("sharded", params, dict(source="sharded", mesh=mesh)),
            ("cached", params, dict(source="cached", cache_k=32,
                                    cache_trace=counts, mesh=mesh))):
        eng = RecEngine(CFG, p, max_l=MAX_L, max_batch=4, max_wait_ms=0.0,
                        device="cpu", **kw)
        reqs = requests_from_ragged_batch(rb, CFG.n_tables)
        for r in reqs:
            eng.submit(r)
            eng.step()
        eng.drain()
        out[name] = np.array([r.prob for r in reqs])
    return out


def _rank_suite(mesh, npz):
    z = np.load(npz)
    coords = tuple(mesh.rank(a) for a in AXES)
    return {"coords": coords, "shape": mesh.shape,
            "backend": mesh.backend,
            "lookups": _rank_lookups(mesh, z),
            "forwards": _rank_forwards(mesh, z),
            "dense": _rank_dense_steps(mesh, z),
            "sparse": _rank_sparse_steps(mesh, z),
            "tokens": _rank_tokens(mesh, z),
            "moe": _rank_moe(mesh, z),
            "grads": _rank_grads(mesh, z),
            "serve": _rank_serve(mesh, z)}


# ---------------------------------------------------------------------------
# the reference's run and the ranks' (module fixtures)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """(path of the .npz of inputs and outputs, resolve()'s specs)."""
    tmp = tmp_path_factory.mktemp("ref2d")
    npz = str(tmp / "ref.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run(
        [sys.executable, "-c", REF_CODE, npz,
         json.dumps([list(lg) for lg in LOGICAL])],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return npz, json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks2d")
    return spawn(_rank_suite, 4, backend="gloo",
                 init_file=str(tmp / "rendezvous"), args=(ref[0],),
                 timeout_s=120, join_timeout_s=180, mesh_shape=SHAPE,
                 mesh_axes=AXES)


@pytest.fixture(scope="module")
def z(ref):
    return np.load(ref[0])


def _equal(a, b, what=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b)), what


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_ranks_sit_row_major_on_the_mesh(ranks):
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(r["shape"] == {"data": 2, "model": 2} for r in ranks)
    assert all(r["backend"] == "gloo" for r in ranks)


@pytest.mark.parametrize("part", ("lookups", "forwards", "dense", "sparse",
                                  "tokens", "moe", "serve"))
def test_every_rank_gets_the_same_bits(ranks, part):
    for r in ranks[1:]:
        _equal(ranks[0][part], r[part], part)


def test_make_mesh_lays_out_any_shape_without_a_group():
    m = make_mesh((1, 1, 1), ("pod", "data", "model"))
    assert m.axis_names == ("pod", "data", "model")
    assert m.shape == {"pod": 1, "data": 1, "model": 1}
    assert all(m.group(a) is None for a in m.axis_names)
    with pytest.raises(RuntimeError, match="torch.distributed"):
        make_mesh((2, 2), AXES)
    with pytest.raises(ValueError, match="differ in length"):
        make_mesh((2, 2), ("model",))
    with pytest.raises(ValueError, match="repeat"):
        make_mesh((1, 1), ("model", "model"))


@pytest.mark.parametrize("multi_pod,n", ((False, 256), (True, 512)))
def test_production_mesh_refuses_fewer_ranks(multi_pod, n):
    with pytest.raises(RuntimeError, match=f"need {n} ranks"):
        make_production_mesh(multi_pod=multi_pod)


@pytest.mark.parametrize("launcher", (t_train, t_serve))
def test_both_launchers_reach_the_production_mesh(launcher):
    with pytest.raises(RuntimeError, match="need 256 ranks"):
        launcher.main(["--smoke", "--device", "cpu", "--mesh", "pod"])
    with pytest.raises(SystemExit, match="cannot be combined"):
        launcher.main(["--smoke", "--device", "cpu", "--mesh", "multipod",
                       "--shards", "2", "--backend", "gloo"])


@pytest.mark.parametrize("name", ("2d", "3d"))
def test_resolve_matches_the_reference(ref, name):
    shape = {"2d": (("data", 2), ("model", 2)),
             "3d": (("pod", 1), ("data", 2), ("model", 2))}[name]
    mesh = Mesh(tuple((a, None, 0, n) for a, n in shape))
    got = [[list(e) if isinstance(e, tuple) else e
            for e in sharding.resolve(mesh, lg)] for lg in LOGICAL]
    assert got == ref[1][name]
    with pytest.raises(ValueError, match="unknown logical axis"):
        sharding.resolve(mesh, ("rows",))
    assert sharding.sharding_for(None, ("batch",)) is None
    tree = sharding.spec_tree_to_shardings(mesh, {"w": ("fsdp", None),
                                                  "b": [(None,)]})
    assert tree["w"].spec == sharding.resolve(mesh, ("fsdp", None))
    assert tree["b"][0] == sharding.Sharding(mesh, (None,))


def _fake(d, m):
    return Mesh((("data", None, d, 2), ("model", None, m, 2)))


@pytest.mark.parametrize("d,m", ((0, 0), (0, 1), (1, 0), (1, 1)))
def test_make_placer_hands_each_rank_its_block(d, m):
    mesh = _fake(d, m)
    batch = {"dense": np.arange(24, dtype=np.float32).reshape(4, 6),
             "tokens": np.arange(32, dtype=np.int32).reshape(4, 8)}
    specs = {"dense": sharding.resolve(mesh, ("batch", None)),
             "tokens": sharding.resolve(mesh, ("batch", "model"))}
    out = make_placer("cpu", mesh, specs)(batch)
    np.testing.assert_array_equal(out["dense"].numpy(),
                                  batch["dense"][2 * d:2 * d + 2])
    np.testing.assert_array_equal(
        out["tokens"].numpy(), batch["tokens"][2 * d:2 * d + 2,
                                               4 * m:4 * m + 4])
    batch["dense"][2 * d, 0] = -1.0              # the block owns a copy
    assert out["dense"][0, 0].item() == 12.0 * d
    with pytest.raises(ValueError, match="batch_specs"):
        make_placer("cpu", mesh)
    assert sharding.place_row_sharded(torch.arange(8.0), mesh).tolist() \
        == [4.0 * m + i for i in range(4)]


# ---------------------------------------------------------------------------
# against the reference's (2, 2) run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ("fixed", "ragged"))
def test_lookups_match_the_reference(ranks, z, kind):
    np.testing.assert_allclose(ranks[0]["lookups"][kind], z[f"lk_{kind}"],
                               rtol=0, atol=LOOKUP_TOL)


@pytest.mark.parametrize("kind", ("fixed", "ragged"))
def test_forwards_match_the_reference(ranks, z, kind):
    np.testing.assert_allclose(ranks[0]["forwards"][kind], z[f"fw_{kind}"],
                               rtol=0, atol=FORWARD_TOL)
    # the reference's acceptance: ragged == fixed on equal-length bags
    np.testing.assert_allclose(ranks[0]["forwards"]["ragged"],
                               ranks[0]["forwards"]["fixed"], rtol=0,
                               atol=FORWARD_TOL)


def _mlp_ref(z, prefix):
    n = sum(1 for k in z.files if k.startswith(prefix))
    return [z[f"{prefix}{i}"] for i in range(n)]


@pytest.mark.parametrize("kind", ("dense", "sparse"))
def test_steps_match_the_reference(ranks, z, kind):
    key = {"dense": "dn", "sparse": "sp"}[kind]
    got = ranks[0][kind]
    np.testing.assert_allclose(got["losses"],
                               [float(z[f"{key}_loss_{s}"])
                                for s in range(STEPS)], rtol=STEP_TOL)
    np.testing.assert_allclose(got["arena"], z[f"{key}_arena"], rtol=0,
                               atol=STEP_TOL)
    want = _mlp_ref(z, f"{key}_mlp")
    assert len(got["mlp"]) == len(want)
    for g, w in zip(got["mlp"], want):
        np.testing.assert_allclose(g, w, rtol=0, atol=STEP_TOL)
    if kind == "sparse":
        np.testing.assert_allclose(got["acc"], z["sp_acc"], rtol=STEP_TOL,
                                   atol=1e-7)
        for s in range(STEPS):
            np.testing.assert_array_equal(got["rows"][s], z[f"sp_rows_{s}"])


def test_dense_step_sums_the_block_gradient_over_the_data_axis(ranks, z):
    """Each data group's backward sees only its own bags: the block's
    Adagrad accumulator is the whole batch's, as the one-rank step's."""
    full = _params(z)
    opt, step = dlrm.make_train_step(CFG)
    state = opt.init(full)
    for s in range(STEPS):
        full, state, _ = step(full, state, {
            k: _t(z[f"dn_{s}_{k}"]) for k in ("dense", "indices", "labels")})
    np.testing.assert_allclose(ranks[0]["dense"]["acc"],
                               state["arena"]["acc"].numpy(),
                               rtol=STEP_TOL, atol=1e-7)


def test_token_gather_matches_the_reference(ranks, z):
    np.testing.assert_allclose(ranks[0]["tokens"]["out"], z["em_out"],
                               rtol=0, atol=LOOKUP_TOL)
    np.testing.assert_allclose(ranks[0]["tokens"]["out3"], z["em_out3"],
                               rtol=0, atol=LOOKUP_TOL)


def test_expert_parallel_moe_matches_the_reference(ranks, z):
    got = ranks[0]["moe"]
    assert got["shapes"] == [(4, 8, 32), (4, 8, 32), (4, 16, 16)]
    np.testing.assert_allclose(got["y"], z["moe_y_ep"], rtol=0,
                               atol=FORWARD_TOL)
    np.testing.assert_allclose(got["y"], z["moe_y_local"], rtol=0,
                               atol=FORWARD_TOL)
    np.testing.assert_allclose(got["aux"], float(z["moe_aux_ep"]),
                               rtol=1e-5)
    assert 0.5 < got["aux"] / float(z["moe_aux_local"]) < 2.0
    p = {k: _t(z[f"moe_{k}"]) for k in ("wr", "wg", "wu", "wd")}
    y_odd, _ = moe.apply_moe(p, MCFG, _t(z["x"])[:, :15])
    np.testing.assert_array_equal(got["y_odd"], y_odd.numpy())


@pytest.mark.parametrize("what", ("moe_x", "moe_wr", "moe_wg", "moe_wu",
                                  "moe_wd", "tokens"))
def test_mesh_paths_differentiate_like_the_one_rank_paths(ranks, what):
    """The backward of every collective on the mesh: the all-to-all's is
    the same exchange, the all-gather's a slice, a replicated input's
    gradient summed over the axes it is replicated on."""
    for r in ranks:
        assert r["grads"][what] < GRAD_TOL, (r["coords"], what,
                                             r["grads"][what])


@pytest.mark.parametrize("plan", ("ragged", "sharded", "cached"))
def test_served_plans_match_the_one_rank_engine(ranks, plan):
    got = ranks[0]["serve"]
    np.testing.assert_allclose(got[plan], got["one_rank"], rtol=0,
                               atol=PROB_TOL)


def test_served_fixed_plan_matches_the_one_rank_engine(ranks):
    got = ranks[0]["serve"]
    np.testing.assert_allclose(got["fixed"], got["one_rank_fixed"], rtol=0,
                               atol=PROB_TOL)


# ---------------------------------------------------------------------------
# the reference's tiered trainer on an arena padded for shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", (1, 2))
def test_reference_tiered_trainer_fails_on_a_padded_arena(shards):
    """Recorded, not ported: the reference's ``OnlineTrainer`` with tiers
    retiers at one shard, and fails its tier-size assertion at its first
    retier on an arena padded for two (mesh or not), which is why the
    port's tiered trainer refuses a mesh."""
    import jax
    from repro.configs.dlrm import DLRM_SMOKE as j_cfg
    from repro.core import dlrm as j_dlrm
    from repro.data import DLRMSynthetic as JSynthetic
    from repro.storage import TierPolicy as JTierPolicy
    from repro.training import OnlineCacheConfig as JCacheConfig
    from repro.training import OnlineTrainer as JTrainer
    trainer = JTrainer(j_cfg, j_dlrm.init(jax.random.PRNGKey(0), j_cfg,
                                          shards),
                       max_l=8, cache_cfg=JCacheConfig(
                           k=0, tiers=JTierPolicy(hot=4, warm=8),
                           refresh_every=2))
    data = JSynthetic(j_cfg, seed=1)

    def run():
        # refresh_every=2: the second step retiers
        for _ in range(3):
            trainer.train_step(data.ragged_batch(8, max_l=8, pad_to=512))
        trainer.retier()
    if shards == 1:
        run()
        assert trainer.version >= 1
        return
    with pytest.raises(AssertionError, match="tier sizes are fixed"):
        run()
