"""The row-sharded path across ranks: gloo process groups of 2 and 4 CPU
ranks (``repro_torch.distributed.spawn``, a file rendezvous under the
test's temporary directory), against the JAX reference on shared numpy
inputs.

The ranks are started five times in all, each start running a batch of
checks whose results the tests below read (module-scoped fixtures):

* 2 and 4 ranks: ``lookup_bags`` over every sharded composition (fp,
  fixed-L, int8, cached over an fp and an int8 sharded cold, a table
  group of sharded members); both pipelined forms and the pipelined
  serve step on the mesh beside the single-shot sharded forwards; 3
  sharded sparse steps; 3 dense-gradient steps through the sharded
  source and the arena's gradient; the ``RecEngine`` sharded and cached
  plans; an ``OnlineTrainer(mesh=)`` feeding a live cache and its
  published blob; at 4 ranks a checkpoint saved after the 3 steps, and a
  4th step;
* 2 ranks: that checkpoint restored onto 2 ranks, and the 4th step;
* the training launcher's ``--shards 2 --backend gloo``;
* the serving launcher's ``--shards 2 --backend gloo``.

One more test holds the port's 4-rank lookups against the reference's
own ``shard_map`` on 4 fake host devices (a subprocess, the pattern of
``tests/test_sharded_sparse.py``). Each start gives its process group a
timeout and the parent a join limit of 120 s, so a hang fails its test.

The rank functions import no JAX: they are pickled to the children by
this module's name, so JAX is imported inside the parent's functions.

Tolerances, the reference's (``tests/test_sharded_sparse.py``): a lookup
``rtol=1e-5, atol=1e-6`` against the replicated one (a bag whose rows
lie on several ranks is summed in another association); 3 steps within
1e-4 of the dense-gradient step, touched rows equal. Exact: every rank's
outputs against the others' (one all-reduce hands each the same bits),
the hot copies against their arena rows, the restored blocks.
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

from repro_torch.checkpoint import CheckpointManager, row_shardings
from repro_torch.configs.dlrm import DLRM_HET_SMOKE, DLRM_SMOKE
from repro_torch.core import dlrm, hybrid
from repro_torch.core import embedding_source as es
from repro_torch.core import sparse_engine as se
from repro_torch.data import DLRMSynthetic
from repro_torch.distributed import collectives, spawn
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.optim import tree_leaves
from repro_torch.serving import RecEngine, requests_from_ragged_batch
from repro_torch.training import OnlineCacheConfig, OnlineTrainer

torch.set_num_threads(1)

SRC = str(Path(__file__).resolve().parents[1] / "src")
CFG, HET = DLRM_SMOKE, DLRM_HET_SMOKE
MAX_L = 6
RTOL, ATOL = 1e-5, 1e-6
STEPS = 3
KEYS = ("dense", "indices", "offsets", "labels")


def _batches(seed, n, b=8):
    data = DLRMSynthetic(CFG, seed=seed)
    return [data.ragged_batch(b, mean_l=3, max_l=MAX_L,
                              pad_to=b * CFG.n_tables * MAX_L)
            for _ in range(n)]


def _tb(b):
    return {k: torch.from_numpy(np.asarray(b[k])) for k in KEYS}


def _np_params(cfg, shards, seed=1):
    import jax
    from repro.configs import dlrm as j_cfgs
    from repro.core import dlrm as j_dlrm
    j_cfg = {CFG.name: j_cfgs.DLRM_SMOKE,
             HET.name: j_cfgs.DLRM_HET_SMOKE}[cfg.name]
    return jax.tree.map(np.asarray,
                        j_dlrm.init(jax.random.PRNGKey(seed), j_cfg, shards))


def _inputs(shards):
    """Everything the ranks use, made here: the reference's padded
    params, the lookup batch, the training batches and the requests."""
    return {"params": _np_params(CFG, shards),
            "het": _np_params(HET, shards, seed=2),
            "lookup": DLRMSynthetic(CFG, seed=5).ragged_batch(
                8, mean_l=3, max_l=MAX_L),
            "het_lookup": DLRMSynthetic(HET, seed=7).ragged_batch(
                6, mean_l=3, max_l=MAX_L),
            "train": _batches(3, STEPS + 1),
            "fixed": DLRMSynthetic(CFG, seed=19).batch(8),
            "serve": DLRMSynthetic(CFG, seed=13).ragged_batch(
                6, mean_l=3, max_l=MAX_L),
            "online": _batches(17, 6)}


def _unsharded(block, mesh):
    return collectives.gather_blocks(block, mesh)


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------

def _rank_lookups(mesh, inp):
    spec = dlrm.arena_spec(CFG)
    params = dlrm.shard_params(dlrm.params_from_numpy(inp["params"], "cpu"),
                               mesh)
    block = params["arena"]
    lb = inp["lookup"]
    idx, off = (torch.from_numpy(lb[k]) for k in ("indices", "offsets"))
    full = dlrm.params_from_numpy(inp["params"], "cpu")["arena"]
    counts = se.trace_row_counts(spec, lb["indices"], lb["offsets"])
    out = {}
    fp = es.resolve_source(block, mesh)
    q = es.ShardedArena(es.QuantizedArena.from_arena(block), mesh)
    out["fp"] = es.lookup_bags(fp, spec, idx, off, max_l=MAX_L)
    fixed = torch.from_numpy(np.random.RandomState(0).randint(
        0, CFG.rows_per_table, (4, CFG.n_tables, 5)).astype(np.int32))
    out["fixed"] = es.lookup_fixed(fp, spec, fixed)
    out["int8"] = es.lookup_bags(q, spec, idx, off, max_l=MAX_L)
    for name, cold in (("cached_fp", False), ("cached_int8", True)):
        src = es.SourceSpec(cache_k=64, quantize_cold=cold,
                            mesh=mesh).build(block, spec, counts)
        out[name] = es.lookup_bags(src, spec, idx, off, max_l=MAX_L)
        # law 1: every hot copy is its arena row, bit for bit
        hot = src.hot
        out[name + "_law1"] = bool(torch.equal(
            hot.hot_rows[:-1], full[hot.hot_ids.long()]))
    het = dlrm.shard_params(dlrm.params_from_numpy(inp["het"], "cpu"),
                            mesh)
    hb = inp["het_lookup"]
    out["group"] = es.lookup_bags(
        dlrm.group_source(het, HET, mesh), dlrm.arena_spec(HET),
        torch.from_numpy(hb["indices"]), torch.from_numpy(hb["offsets"]),
        max_l=MAX_L)
    out["describe"] = es.describe_source(fp)
    return out


def _rank_pipelined(mesh, inp):
    """Both pipelined forms (4 micro-batches) and the pipelined serve step
    on the mesh, beside the single-shot sharded forwards."""
    params = dlrm.shard_params(dlrm.params_from_numpy(inp["params"], "cpu"),
                               mesh)
    fb, rb = inp["fixed"], _tb(inp["train"][0])
    dense, ids = (torch.from_numpy(fb[k]) for k in ("dense", "indices"))
    args = (rb["dense"], rb["indices"], rb["offsets"])
    with torch.no_grad():
        return {
            "fixed": hybrid.pipelined_forward(params, CFG, dense, ids, 4,
                                              mesh),
            "fixed_single": dlrm.forward(params, CFG, dense, ids, mesh),
            "serve": hybrid.make_pipelined_serve_step(CFG, 4, mesh)(
                params, {"dense": dense, "indices": ids}),
            "ragged": hybrid.pipelined_forward_ragged(
                params, CFG, *args, max_l=MAX_L, n_micro=4, mesh=mesh),
            "ragged_single": dlrm.forward_ragged(params, CFG, *args,
                                                 max_l=MAX_L, mesh=mesh)}


def _rank_train(mesh, inp, ckpt_dir):
    spec = dlrm.arena_spec(CFG)
    full = dlrm.params_from_numpy(inp["params"], "cpu")
    out = {}
    # the sharded sparse step
    params = dlrm.shard_params(full, mesh)
    opt, step = dlrm.make_train_step_ragged(CFG, max_l=MAX_L, mesh=mesh)
    state = opt.init(params)
    losses, rows = [], []
    for b in inp["train"][:STEPS]:
        params, state, loss, r = step(params, state, _tb(b))
        losses.append(float(loss))
        rows.append(r.numpy().copy())
    out["sparse"] = {"losses": losses, "rows": rows,
                     "arena": _unsharded(params["arena"], mesh),
                     "acc": _unsharded(state["arena"]["acc"], mesh),
                     "mlp": [t.clone() for k in ("bottom", "top")
                             for t in tree_leaves(params[k])],
                     "sentinel": float(params["arena"][-1].abs().sum()
                                       + state["arena"]["acc"][-1].sum())}
    if ckpt_dir is not None:
        shardings = row_shardings((params, state), mesh)
        CheckpointManager(ckpt_dir, device="cpu").save(
            STEPS - 1, (params, state), shardings=shardings)
        params, state, loss, _ = step(params, state,
                                      _tb(inp["train"][STEPS]))
        out["after"] = {"loss": float(loss),
                        "arena": _unsharded(params["arena"], mesh),
                        "mlp": [t.clone() for k in ("bottom", "top")
                                for t in tree_leaves(params[k])]}
    # the dense-gradient step through the sharded source, from fresh
    # params (the steps above updated the shared MLP tensors in place)
    full = dlrm.params_from_numpy(inp["params"], "cpu")
    params = dlrm.shard_params(full, mesh)
    opt, step = dlrm.make_train_step_ragged(CFG, max_l=MAX_L, sparse=False,
                                            mesh=mesh)
    state = opt.init(params)
    live = {k: (v.clone().requires_grad_() if k == "arena" else v)
            for k, v in params.items()}
    b = _tb(inp["train"][0])
    dlrm.loss_ragged(live, CFG, b["dense"], b["indices"], b["offsets"],
                     b["labels"], max_l=MAX_L, mesh=mesh).backward()
    out["grad"] = _unsharded(live["arena"].grad, mesh)
    out["grad_sentinel"] = float(live["arena"].grad[-1].abs().sum())
    losses = []
    for b in inp["train"][:STEPS]:
        params, state, loss, _ = step(params, state, _tb(b))
        losses.append(float(loss))
    out["dense"] = {"losses": losses,
                    "arena": _unsharded(params["arena"], mesh),
                    "acc": _unsharded(state["arena"]["acc"], mesh)}
    return out


def _rank_serve(mesh, inp):
    spec = dlrm.arena_spec(CFG)
    params = dlrm.shard_params(dlrm.params_from_numpy(inp["params"], "cpu"),
                               mesh)
    rb = inp["serve"]
    counts = se.trace_row_counts(spec, rb["indices"], rb["offsets"])
    out = {}
    for name, kw in (("sharded", dict(source="sharded")),
                     ("cached", dict(source="cached", cache_k=32,
                                     cache_trace=counts))):
        eng = RecEngine(CFG, params, max_l=MAX_L, max_batch=4,
                        max_wait_ms=0.0, mesh=mesh, device="cpu", **kw)
        eng.warmup()
        reqs = requests_from_ragged_batch(rb, CFG.n_tables)
        for r in reqs:
            eng.submit(r)
        eng.step(force=True)
        eng.drain()
        st = eng.stats()
        out[name] = {"probs": np.array([r.prob for r in reqs]),
                     "graphed": st["graphed"], "why": st["why"],
                     "source": st["source"]}
    return out


def _rank_online(mesh, inp):
    spec = dlrm.arena_spec(CFG)
    params = dlrm.shard_params(dlrm.params_from_numpy(inp["params"], "cpu"),
                               mesh)
    trainer = OnlineTrainer(CFG, params, max_l=MAX_L, mesh=mesh,
                            cache_cfg=OnlineCacheConfig(k=64,
                                                        refresh_every=4,
                                                        quantize_cold=True),
                            device="cpu")
    for b in inp["online"]:
        trainer.train_step(b)
    rb = inp["lookup"]
    idx, off = (torch.from_numpy(rb[k]) for k in ("indices", "offsets"))
    arena = _unsharded(trainer.params["arena"], mesh)
    plain = es.lookup_bags(es.FpArena(arena), spec, idx, off, max_l=MAX_L)
    cached = es.lookup_bags(es.CachedSource(
        trainer.cache, es.ShardedArena(es.FpArena(trainer.params["arena"]),
                                       mesh)), spec, idx, off, max_l=MAX_L)
    src = trainer.serving_source()
    blob = trainer.publish_source()
    eng = RecEngine(CFG, trainer.params, source="cached", mesh=mesh,
                    cache_k=64, cache_trace=trainer.hist, quantize_cold=True,
                    max_l=MAX_L, max_batch=4, device="cpu")
    adopted = es.VersionedSource.deserialize(blob, mesh,
                                             device="cpu").apply(eng)
    repl = es.VersionedSource.deserialize(blob, device="cpu").source
    synced = trainer.sync_engine(eng)
    hot = trainer.cache
    return {"err": float((cached - plain).abs().max()),
            "version": trainer.version, "losses": trainer.losses,
            "sharded_structure": isinstance(src.cold, es.ShardedArena),
            "adopted": adopted, "synced": synced,
            "repl_ok": isinstance(repl.cold, es.QuantizedArena)
            and repl.cold.q.shape[0] == arena.shape[0],
            "law1": bool(torch.equal(hot.hot_rows[:-1],
                                     arena[hot.hot_ids.long()])),
            "hist": trainer.hist}


def _rank_suite(mesh, inp, ckpt_dir):
    return {"lookups": _rank_lookups(mesh, inp),
            "pipelined": _rank_pipelined(mesh, inp),
            "train": _rank_train(mesh, inp, ckpt_dir),
            "serve": _rank_serve(mesh, inp),
            "online": _rank_online(mesh, inp)}


def _rank_restore(mesh, inp4, ckpt_dir):
    """Restore the 4-rank checkpoint onto this 2-rank mesh and take the
    4th step."""
    params = dlrm.shard_params(dlrm.init(torch.Generator().manual_seed(0),
                                         CFG, 2, device="cpu"), mesh)
    opt, step = dlrm.make_train_step_ragged(CFG, max_l=MAX_L, mesh=mesh)
    template = (params, opt.init(params))
    (params, state), manifest = CheckpointManager(
        ckpt_dir, device="cpu").restore(
        template, shardings=row_shardings(template, mesh))
    restored = {"arena": _unsharded(params["arena"], mesh),
                "acc": _unsharded(state["arena"]["acc"], mesh),
                "sentinel": float(params["arena"][-1].abs().sum()
                                  + state["arena"]["acc"][-1].sum()),
                "step": manifest["step"]}
    params, state, loss, _ = step(params, state, _tb(inp4["train"][STEPS]))
    return {"restored": restored, "loss": float(loss),
            "arena": _unsharded(params["arena"], mesh),
            "mlp": [t.clone() for k in ("bottom", "top")
                    for t in tree_leaves(params[k])]}


# ---------------------------------------------------------------------------
# the starts (module fixtures) and the references
# ---------------------------------------------------------------------------

def _start(fn, n, tmp, *args):
    return spawn(fn, n, backend="gloo", init_file=str(tmp / "rendezvous"),
                 args=args, timeout_s=120, join_timeout_s=120)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{2: (inputs, per-rank results), 4: ...}, the 4-rank start saving
    its checkpoint."""
    out = {}
    for n in (2, 4):
        tmp = tmp_path_factory.mktemp(f"ranks{n}")
        inp = _inputs(n)
        ckpt = str(tmp / "ckpt") if n == 4 else None
        out[n] = (inp, _start(_rank_suite, n, tmp, inp, ckpt), ckpt)
    return out


@pytest.fixture(scope="module")
def restored(runs, tmp_path_factory):
    inp4, _, ckpt = runs[4]
    tmp = tmp_path_factory.mktemp("restore2")
    return _start(_rank_restore, 2, tmp, inp4, ckpt)


def _all_equal(values):
    first = values[0]
    for v in values[1:]:
        if isinstance(first, dict):
            assert first.keys() == v.keys()
            _all_equal_pairs(first, v)
        else:
            assert np.array_equal(np.asarray(first), np.asarray(v))


def _all_equal_pairs(a, b):
    for k in a:
        if isinstance(a[k], dict):
            _all_equal_pairs(a[k], b[k])
        elif isinstance(a[k], list):
            for x, y in zip(a[k], b[k]):
                assert np.array_equal(np.asarray(x), np.asarray(y)), k
        else:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def _j_lookups(inp):
    """The reference's replicated lookups of the same compositions."""
    import jax.numpy as jnp
    from repro.configs import dlrm as j_cfgs
    from repro.core import dlrm as j_dlrm
    from repro.core import embedding_source as j_es
    from repro.core import sparse_engine as j_se
    spec = j_dlrm.arena_spec(j_cfgs.DLRM_SMOKE)
    arena = jnp.asarray(inp["params"]["arena"])
    lb = inp["lookup"]
    idx, off = jnp.asarray(lb["indices"]), jnp.asarray(lb["offsets"])
    counts = j_se.trace_row_counts(spec, lb["indices"], lb["offsets"])
    cache = j_se.build_hot_cache(arena, spec, counts, 64)
    fp, q = j_es.FpArena(arena), j_es.QuantizedArena.from_arena(arena)
    fixed = jnp.asarray(np.random.RandomState(0).randint(
        0, CFG.rows_per_table, (4, CFG.n_tables, 5)).astype(np.int32))
    het = inp["het"]
    hb = inp["het_lookup"]
    group = j_es.TableGroupSource.from_arenas(
        [jnp.asarray(a) for a in het["tables"]],
        j_dlrm.member_specs(j_cfgs.DLRM_HET_SMOKE))
    return {
        "fp": j_es.lookup_bags(fp, spec, idx, off, max_l=MAX_L),
        "fixed": j_es.lookup_fixed(fp, spec, fixed),
        "int8": j_es.lookup_bags(q, spec, idx, off, max_l=MAX_L),
        "cached_fp": j_es.lookup_bags(j_es.CachedSource(cache, fp), spec,
                                      idx, off, max_l=MAX_L),
        "cached_int8": j_es.lookup_bags(j_es.CachedSource(cache, q), spec,
                                        idx, off, max_l=MAX_L),
        "group": j_es.lookup_bags(
            group, j_dlrm.arena_spec(j_cfgs.DLRM_HET_SMOKE),
            jnp.asarray(hb["indices"]), jnp.asarray(hb["offsets"]),
            max_l=MAX_L)}


# ---------------------------------------------------------------------------
# lookups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", (2, 4))
def test_sharded_lookups_match_the_reference(runs, n):
    inp, res, _ = runs[n]
    want = _j_lookups(inp)
    for name, w in want.items():
        for r in res:
            np.testing.assert_allclose(r["lookups"][name], np.asarray(w),
                                       rtol=RTOL, atol=ATOL, err_msg=name)
    assert res[0]["lookups"]["describe"] == f"sharded({n},fp)"


@pytest.mark.parametrize("n", (2, 4))
def test_every_rank_gets_the_same_bits(runs, n):
    _, res, _ = runs[n]
    _all_equal([r["lookups"] for r in res])
    _all_equal([r["pipelined"] for r in res])
    _all_equal([r["train"] for r in res])
    _all_equal([{k: v["probs"] for k, v in r["serve"].items()}
                for r in res])
    assert all(r["lookups"][k] for r in res
               for k in ("cached_fp_law1", "cached_int8_law1"))


def test_port_lookups_match_the_reference_shard_map(runs):
    """The reference's own shard_map on 4 fake host devices, over the
    arena and batch of the 4-rank start."""
    inp, res, _ = runs[4]
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    code = textwrap.dedent("""
        import json, jax, jax.numpy as jnp, numpy as np
        from repro.configs.dlrm import DLRM_SMOKE as cfg
        from repro.core import dlrm, embedding_source as es
        from repro.core import sparse_engine as se
        from repro.data import DLRMSynthetic
        from repro.launch.mesh import make_mesh
        mesh = make_mesh((4,), ("model",))
        spec = dlrm.arena_spec(cfg)
        arena = dlrm.init(jax.random.PRNGKey(1), cfg, 4)["arena"]
        rb = DLRMSynthetic(cfg, seed=5).ragged_batch(8, mean_l=3, max_l=6)
        idx, off = jnp.asarray(rb["indices"]), jnp.asarray(rb["offsets"])
        counts = se.trace_row_counts(spec, rb["indices"], rb["offsets"])
        cache = se.build_hot_cache(arena, spec, counts, 64)
        sh = es.ShardedArena(es.FpArena(arena), mesh)
        out = {"fp": es.lookup_bags(sh, spec, idx, off, max_l=6),
               "cached_fp": es.lookup_bags(es.CachedSource(cache, sh), spec,
                                           idx, off, max_l=6)}
        print(json.dumps({k: np.asarray(v).tolist()
                          for k, v in out.items()}))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("fp", "cached_fp"):
        np.testing.assert_allclose(res[0]["lookups"][name],
                                   np.asarray(want[name], np.float32),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("n", (2, 4))
def test_pipelined_forms_on_a_mesh_match_the_single_shot_forward(runs, n):
    """Each micro-batch's lookup is the sharded one (its all-reduce a
    micro-batch, the tail's too): the pipelines equal the single-shot
    sharded forwards within the lookups' bound (gloo may sum a bag's
    partials in another order at another message size), and the
    reference's replicated forwards within the hybrid tests' 1e-5."""
    import jax
    import jax.numpy as jnp
    from repro.configs import dlrm as j_cfgs
    from repro.core import dlrm as j_dlrm
    inp, res, _ = runs[n]
    jp = jax.tree.map(jnp.asarray, inp["params"])
    fb, rb = inp["fixed"], inp["train"][0]
    want_fixed = j_dlrm.forward(jp, j_cfgs.DLRM_SMOKE,
                                jnp.asarray(fb["dense"]),
                                jnp.asarray(fb["indices"]))
    want_ragged = j_dlrm.forward_ragged(
        jp, j_cfgs.DLRM_SMOKE, *(jnp.asarray(rb[k])
                                 for k in ("dense", "indices", "offsets")),
        max_l=MAX_L)
    got = res[0]["pipelined"]
    for name, want in (("fixed", want_fixed), ("ragged", want_ragged)):
        np.testing.assert_allclose(got[name], got[name + "_single"],
                                   rtol=RTOL, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(got[name], np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(got["serve"],
                               1 / (1 + np.exp(-got["fixed_single"])),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _j_dense_steps(inp):
    """3 steps of the reference's dense-gradient step from the same
    padded params."""
    import jax
    import jax.numpy as jnp
    from repro.configs import dlrm as j_cfgs
    from repro.core import dlrm as j_dlrm
    params = jax.tree.map(jnp.asarray, inp["params"])
    opt, step = j_dlrm.make_train_step_ragged(j_cfgs.DLRM_SMOKE,
                                              max_l=MAX_L, sparse=False)
    state = opt.init(params)
    losses, rows = [], []
    for b in inp["train"][:STEPS]:
        params, state, loss, r = step(params, state,
                                      {k: jnp.asarray(b[k]) for k in KEYS})
        losses.append(float(loss))
        rows.append(np.asarray(r))
    return params, losses, rows


@pytest.mark.parametrize("n", (2, 4))
def test_sharded_sparse_steps_match_the_reference_dense_step(runs, n):
    inp, res, _ = runs[n]
    j_params, j_losses, j_rows = _j_dense_steps(inp)
    got = res[0]["train"]["sparse"]
    for a, b in zip(got["rows"], j_rows):
        assert np.array_equal(a, b)
    np.testing.assert_allclose(got["losses"], j_losses, rtol=1e-4)
    np.testing.assert_allclose(got["arena"], np.asarray(j_params["arena"]),
                               atol=1e-4)
    j_mlp = [np.asarray(x) for k in ("bottom", "top")
             for x in __import__("jax").tree_util.tree_leaves(j_params[k])]
    for a, b in zip(got["mlp"], j_mlp):
        np.testing.assert_allclose(a, b, atol=1e-4)
    assert got["sentinel"] == 0.0


@pytest.mark.parametrize("n", (2, 4))
def test_dense_gradient_sharded_step_matches_the_replicated_one(runs, n):
    """The sharded source's gradient is the replicated one, not N times
    it: the all-reduce's backward is the identity. Checked on the
    arena's gradient itself and on the Adagrad accumulator after 3 steps
    (row-wise Adagrad normalizes the update, so the params alone would
    not show a scaled gradient)."""
    inp, res, _ = runs[n]
    full = dlrm.params_from_numpy(inp["params"], "cpu")
    live = {k: (v.clone().requires_grad_() if k == "arena" else v)
            for k, v in full.items()}
    b = _tb(inp["train"][0])
    dlrm.loss_ragged(live, CFG, b["dense"], b["indices"], b["offsets"],
                     b["labels"], max_l=MAX_L).backward()
    got = res[0]["train"]
    np.testing.assert_allclose(got["grad"], live["arena"].grad.numpy(),
                               rtol=1e-4, atol=1e-7)
    assert got["grad_sentinel"] == 0.0
    opt, step = dlrm.make_train_step_ragged(CFG, max_l=MAX_L, sparse=False)
    params, state = full, opt.init(full)
    losses = []
    for b in inp["train"][:STEPS]:
        params, state, loss, _ = step(params, state, _tb(b))
        losses.append(float(loss))
    np.testing.assert_allclose(got["dense"]["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(got["dense"]["arena"],
                               params["arena"].numpy(), atol=1e-4)
    np.testing.assert_allclose(got["dense"]["acc"],
                               state["arena"]["acc"].numpy(), rtol=1e-4,
                               atol=1e-12)


def test_checkpoint_saved_at_4_ranks_restores_at_2(runs, restored):
    """Restored blocks equal the saved arena (the 4-rank padding dropped),
    which is on disk unsharded; the 4th step on 2 ranks equals the 4th
    step on 4 within the steps' bounds."""
    inp, res, ckpt = runs[4]
    saved = res[0]["train"]["sparse"]
    rows2 = dlrm.arena_spec(CFG).padded_rows(2)
    assert saved["arena"].shape[0] == dlrm.arena_spec(CFG).padded_rows(4)
    _all_equal(restored)
    for r in restored:
        got = r["restored"]
        assert got["step"] == STEPS - 1 and got["sentinel"] == 0.0
        assert np.array_equal(got["arena"], saved["arena"][:rows2])
        assert np.array_equal(got["acc"], saved["acc"][:rows2])
        assert not saved["arena"][rows2:].any()
    manifest = json.loads((Path(ckpt) / f"step_{STEPS - 1}"
                           / "manifest.json").read_text())
    assert "[0]['arena']" in manifest["paths"]
    with np.load(Path(ckpt) / f"step_{STEPS - 1}" / "arrays.npz") as z:
        i = manifest["paths"].index("[0]['arena']")
        assert np.array_equal(z[f"arr_{i}"], saved["arena"])
    after4 = res[0]["train"]["after"]
    np.testing.assert_allclose(restored[0]["loss"], after4["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(restored[0]["arena"],
                               after4["arena"][:rows2], atol=1e-4)
    for a, b in zip(restored[0]["mlp"], after4["mlp"]):
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_the_reference_restores_the_port_sharded_checkpoint(runs):
    """The checkpoint the 4 ranks wrote is unsharded, in the reference's
    layout: the reference restores it into its own 4-padded state."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import CheckpointManager as JCheckpointManager
    from repro.configs import dlrm as j_cfgs
    from repro.core import dlrm as j_dlrm
    inp, res, ckpt = runs[4]
    params = jax.tree.map(jnp.asarray, inp["params"])
    opt, _ = j_dlrm.make_train_step_ragged(j_cfgs.DLRM_SMOKE, max_l=MAX_L)
    state, _ = JCheckpointManager(ckpt).restore((params, opt.init(params)))
    saved = res[0]["train"]["sparse"]
    assert np.array_equal(np.asarray(state[0]["arena"]), saved["arena"])
    assert np.array_equal(np.asarray(state[1]["arena"]["acc"]),
                          saved["acc"])


# ---------------------------------------------------------------------------
# serving and the online trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", (2, 4))
def test_rec_engine_sharded_and_cached_plans(runs, n):
    """Both plans serve the reference's ragged engine's CTRs; they say
    they serve eagerly, and why."""
    import jax
    from repro.configs import dlrm as j_cfgs
    from repro.serving import RecEngine as JRecEngine
    from repro.serving import requests_from_ragged_batch as j_requests
    inp, res, _ = runs[n]
    eng = JRecEngine(j_cfgs.DLRM_SMOKE,
                     jax.tree.map(jax.numpy.asarray, inp["params"]),
                     source="ragged", max_l=MAX_L, max_batch=4,
                     max_wait_ms=0.0)
    reqs = j_requests(inp["serve"], CFG.n_tables)
    for r in reqs:
        eng.submit(r)
    eng.step(force=True)
    eng.drain()
    want = np.array([r.prob for r in reqs])
    for name in ("sharded", "cached"):
        got = res[0]["serve"][name]
        np.testing.assert_allclose(got["probs"], want, rtol=0, atol=1e-5)
        assert got["graphed"] is False and got["why"] == "sharded source"
    assert res[0]["serve"]["sharded"]["source"] == f"sharded({n},fp)"
    assert res[0]["serve"]["cached"]["source"] == f"cached(sharded({n},fp))"


@pytest.mark.parametrize("n", (2, 4))
def test_online_trainer_on_a_mesh_feeds_a_live_cache(runs, n):
    """The reference's case: the sharded trainer's write-through keeps
    the cached lookup over the sharded arena exact within 1e-5 of the
    plain one, its hot copies equal their rows bit for bit, and its
    sharded artifact is adopted by a sharded engine and unwraps without a
    mesh; the histogram is global, equal on every rank."""
    _, res, _ = runs[n]
    for r in res:
        o = r["online"]
        assert o["err"] < 1e-5 and o["law1"]
        assert o["version"] >= 1 and o["sharded_structure"]
        assert o["adopted"] and o["synced"] and o["repl_ok"]
        assert np.array_equal(o["hist"], res[0]["online"]["hist"])
        assert o["losses"] == res[0]["online"]["losses"]


def test_sharded_serving_requires_a_mesh():
    params = dlrm.init(torch.Generator().manual_seed(0), CFG, device="cpu")
    with pytest.raises(ValueError, match="require_mesh"):
        RecEngine(CFG, params, source="sharded", max_l=MAX_L, device="cpu")


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_trains_sharded_over_gloo(tmp_path, capsys):
    """``--shards 2 --backend gloo``: the ranks' losses agree (the
    launcher checks), and equal the replicated trainer's on the same
    padded params within the steps' bound; the backend has no default."""
    argv = ["--smoke", "--device", "cpu", "--ragged", "--steps", "3",
            "--batch-size", "8", "--log-every", "1"]
    loss = t_train.main(argv + ["--shards", "2", "--backend", "gloo",
                                "--rendezvous", str(tmp_path / "rdv"),
                                "--timeout", "120"])
    gen = torch.Generator().manual_seed(0)
    trainer = OnlineTrainer(CFG, dlrm.init(gen, CFG, 2, device="cpu"),
                            max_l=2 * CFG.lookups_per_table, device="cpu")
    data = DLRMSynthetic(CFG, seed=0)
    max_l = 2 * CFG.lookups_per_table
    for _ in range(3):
        want = trainer.train_step(data.ragged_batch(
            8, max_l=max_l, pad_to=8 * CFG.n_tables * max_l))
    np.testing.assert_allclose(loss, want, rtol=1e-5)
    with pytest.raises(SystemExit):
        t_train.main(argv + ["--shards", "2"])
    assert "--backend" in capsys.readouterr().err


def test_serve_launcher_serves_sharded_over_gloo(tmp_path, capsys):
    """``serve --shards 2 --backend gloo``: the ranks' probabilities agree
    bit for bit (the launcher checks), and rank 0's last batch equals the
    replicated serve step's on the same padded params within the lookups'
    bound; the backend has no default."""
    argv = ["--smoke", "--device", "cpu", "--requests", "16",
            "--batch-size", "8"]
    out = t_serve.main(argv + ["--shards", "2", "--backend", "gloo",
                               "--rendezvous", str(tmp_path / "rdv"),
                               "--timeout", "120"])
    assert out["steps"] == 2
    params = dlrm.init(torch.Generator().manual_seed(0), CFG, 2,
                       device="cpu")
    data = DLRMSynthetic(CFG, seed=1)
    for _ in range(2):
        b = data.batch(8)
    want = dlrm.make_serve_step(CFG)(
        params, {k: torch.from_numpy(b[k]) for k in ("dense", "indices")})
    np.testing.assert_allclose(out["last_probs"], want.numpy(), rtol=RTOL,
                               atol=ATOL)
    with pytest.raises(SystemExit):
        t_serve.main(argv + ["--shards", "2"])
    assert "--backend" in capsys.readouterr().err
